from .bootstrap import (add_eval_args, add_train_args,  # noqa: F401
                        build_engine, build_model, build_model_and_tokenizer,
                        build_trainer, parse_config, setup, train_stage)
from .dtypes import DTypePolicy, resolve_dtype  # noqa: F401
from .convert import (eval_config, params_from_numpy,  # noqa: F401
                      training_params_from_numpy)
from .model_io import (load_converted_params, load_pretrained,  # noqa: F401
                       save_converted_params, save_final)
