"""The trunk's share of its roofline in the zoom L-BFGS step, per
evaluation: the trunk's least time for one evaluation of the loss and its
gradient (``counts.trunk_least_s``) times the evaluations the traced
stretch ran (its iterations times ``evals_per_iter``, from the runner's
``zoom-trials`` counter), over the device time of the convolution kernels
and their layout copies in it."""

from benchmark.metrics import _zoom
from benchmark.metrics._kernels import TRUNK


def read(ctx):
    evals = _zoom.evals_per_iter(ctx)
    if evals is None:
        return None
    seconds = ctx["trace"].seconds(TRUNK)
    if seconds <= 0:
        raise RuntimeError("the trace holds no convolution kernel")
    return 100.0 * ctx["trunk_least_s"] * ctx["traced_iterations"] * evals / seconds
