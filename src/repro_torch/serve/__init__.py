from .engine import Engine, GenerationResult, Request, RequestQueue  # noqa: F401
