from .bootstrap import build_engine, build_trainer  # noqa: F401
from .convert import (eval_config, params_from_numpy,  # noqa: F401
                      training_params_from_numpy)
