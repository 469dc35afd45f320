"""Logging and environment helpers (counterparts of lhrs_bot_tpu/utils)."""
