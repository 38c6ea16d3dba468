"""Loss evaluations an iteration of the zoom L-BFGS step over the traced
chunks: 1 (the loss and gradient at the iterate) plus the line search's
trials, from the runner's ``zoom-trials`` counter (see ``_zoom.py``)."""

from benchmark.metrics import _zoom


def read(ctx):
    return _zoom.evals_per_iter(ctx)
