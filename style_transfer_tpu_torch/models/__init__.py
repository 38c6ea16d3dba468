from . import vgg, weights  # noqa: F401
