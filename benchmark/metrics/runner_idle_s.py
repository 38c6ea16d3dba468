"""Idle s an image of the device in the step runner's phases: the gaps of at
least 20 us whose innermost program span is a chunk (`chunk1`, `chunk`,
the graph replays and their host reads) or the runner's `warm-up` or
`capture` inside a scale's first chunk (see ``_spans.py``)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.idle_s(ctx, _spans.RUNNER)
