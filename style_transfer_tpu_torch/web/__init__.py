from .server import WebInterface  # noqa: F401
