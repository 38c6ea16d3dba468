"""The trunk's least time (``counts.trunk_least_s``: each convolution's
forward and data gradient bound by its FLOPs at the peak or its bytes at
the memory bandwidth) over the device time of the convolution kernels and
their layout copies in the traced stretch."""

from benchmark.metrics._kernels import TRUNK


def read(ctx):
    trace = ctx["trace"]
    if ctx["kind"] != "step" or trace is None:
        return None
    seconds = trace.seconds(TRUNK)
    if seconds <= 0:
        raise RuntimeError("the trace holds no convolution kernel")
    return 100.0 * ctx["trunk_least_s"] * ctx["traced_iterations"] / seconds
