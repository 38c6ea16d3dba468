"""Device ms of one line-search trial (the loss and gradient at the trial
point and the search's step): the time between two CUDA events captured in
the zoom runner's trial graph, the median over the traced chunks (see
``_zoom.py``)."""

from benchmark.metrics import _zoom


def read(ctx):
    return _zoom.trial_ms(ctx)
