"""The NS chain's share of its roofline, for ``ns_roofline.step`` and
``ns_roofline.pyramid``: its least time (``counts.ns_least_s`` at 495
TFLOP/s and 3.35 TB/s) per iteration, times the traced iterations, over
the ``stt_nsk_`` kernels' device time."""

from benchmark.metrics._kernels import NS


def read(ctx, kind):
    trace = ctx["trace"]
    if ctx["kind"] != kind or trace is None:
        return None
    seconds = trace.seconds((NS,))
    if seconds <= 0:
        raise RuntimeError("the trace holds no stt_nsk_ kernel")
    return 100.0 * ctx["ns_least_s"] * ctx["traced_iterations"] / seconds
