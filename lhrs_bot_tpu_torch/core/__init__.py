from .bootstrap import (build_engine, build_model,  # noqa: F401
                        build_trainer)
from .convert import (eval_config, params_from_numpy,  # noqa: F401
                      training_params_from_numpy)
from .model_io import load_pretrained, save_final  # noqa: F401
