"""Device ms an iteration of the step's ``forward`` section: the trunk
forward, with the moments taken at its taps. The time between two CUDA
events captured in the step's graph, the median over the traced chunks (see
``_spans.py``)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.section_ms(ctx, "forward")
