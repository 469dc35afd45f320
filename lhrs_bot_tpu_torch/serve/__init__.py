from .engine import GenerationConfig, GenerationEngine  # noqa: F401
