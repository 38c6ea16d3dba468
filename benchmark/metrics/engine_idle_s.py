"""Idle s an image of the device in the engine's own phases: the gaps of at
least 20 us whose innermost program span is the `prologue`, `targets`,
`scale-entry`, `scale-exit`, `callbacks`, `ckpt-snapshot` or
`final-image` (see ``_spans.py``)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.idle_s(ctx, _spans.ENGINE)
