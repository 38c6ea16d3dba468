"""Device idle ms an iteration in gaps of at least 20 us that open at the
zoom line search's host read of ``go``: the device waits there for the host
to read the bool and launch the next trial or the tail (see ``_zoom.py``)."""

from benchmark.metrics import _zoom


def read(ctx):
    idle = _zoom.ls_idle_ns(ctx)
    return None if idle is None else idle / 1e6 / ctx["traced_iterations"]
