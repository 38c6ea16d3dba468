"""``ns_roofline`` in the pyramid cells (see ``_ns.py``)."""

from benchmark.metrics import _ns


def read(ctx):
    return _ns.read(ctx, "pyramid")
