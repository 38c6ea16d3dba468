from . import losses, pooling, sqrtm  # noqa: F401
