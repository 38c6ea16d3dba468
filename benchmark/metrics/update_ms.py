"""Device ms an iteration of the step's ``update`` section: Adam or L-BFGS,
the clamp, EMA and the state's writes. The time between two CUDA events
captured in the step's graph, the median over the traced chunks (see
``_spans.py``)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.section_ms(ctx, "update")
