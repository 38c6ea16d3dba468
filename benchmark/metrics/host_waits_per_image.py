"""The points an image where the program blocks the host on the device (its
recorder's `host_wait` events: phase-end synchronizes, chunk reads of the
losses, the synchronize before a capture, the read of the final image;
see ``_spans.py``)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.host_waits_per_image(ctx)
