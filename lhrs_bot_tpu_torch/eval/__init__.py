from .scheduled import scheduler_generate  # noqa: F401
