"""``device_idle`` in the pyramid cells (see ``_idle.py``)."""

from benchmark.metrics import _idle


def read(ctx):
    return _idle.read(ctx, "pyramid")
