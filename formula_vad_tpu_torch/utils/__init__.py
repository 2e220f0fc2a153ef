from . import checkpoint, logging, profiling, uuid  # noqa: F401
