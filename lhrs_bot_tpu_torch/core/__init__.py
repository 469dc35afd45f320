from .bootstrap import build_engine  # noqa: F401
from .convert import eval_config, params_from_numpy  # noqa: F401
