"""Device ms an iteration of the step's ``loss`` section: the W2 terms with
the NS chain, content and TV, to the scalar loss. The time between two CUDA
events captured in the step's graph, the median over the traced chunks (see
``_spans.py``)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.section_ms(ctx, "loss")
