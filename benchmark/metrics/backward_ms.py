"""Device ms an iteration of the step's ``backward`` section: the image's
gradient through the loss and the trunk, with remat's recompute. The time
between two CUDA events captured in the step's graph, the median over the
traced chunks (see ``_spans.py``)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.section_ms(ctx, "backward")
