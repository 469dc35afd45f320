from . import caption, metrics  # noqa: F401
from .protocols import make_caption_eval_fn, make_cls_eval_fn  # noqa: F401
from .scheduled import scheduler_generate  # noqa: F401
