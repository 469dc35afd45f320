"""Special-token constants (counterpart of lhrs_bot_tpu/models/constants.py)."""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
