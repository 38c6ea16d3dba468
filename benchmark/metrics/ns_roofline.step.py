"""``ns_roofline`` in the step cells (see ``_ns.py``)."""

from benchmark.metrics import _ns


def read(ctx):
    return _ns.read(ctx, "step")
