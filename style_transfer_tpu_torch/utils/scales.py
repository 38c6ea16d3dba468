"""Coarse-to-fine scale scheduling (host-side, pure Python).

Port of ``style_transfer_tpu/utils/scales.py`` (reference
``style_transfer.py:256-276`` and ``cli.py:84-87``): successive scales
differ by sqrt(2), e.g. ``gen_scales(128, 512) == [128, 181, 256, 362, 512]``.
"""

__all__ = ["gen_scales", "size_to_fit", "get_safe_scale", "align_size",
           "shard_align_size"]


def gen_scales(start: int, end: int):
    """Deduplicated ascending pyramid of max-dims ``round(end / 2**(i/2))``."""
    scales = set()
    i = 0
    scale = end
    while scale >= start:
        scales.add(scale)
        i += 1
        scale = round(end / 2 ** (i / 2))
    return sorted(scales)


def size_to_fit(size, max_dim: int, scale_up: bool = False):
    """Aspect-preserving (w, h) fit of ``size`` into a ``max_dim`` box."""
    w, h = size
    if not scale_up and max(h, w) <= max_dim:
        return w, h
    new_w, new_h = max_dim, max_dim
    if h > w:
        new_w = round(max_dim * w / h)
    else:
        new_h = round(max_dim * h / w)
    return new_w, new_h


def align_size(size, align: int):
    """Round (w, h) to the nearest positive multiples of ``align``
    (``--align``: exact output size traded for even pooling cascades)."""
    if align <= 1:
        return size
    w, h = size
    return (max(align, round(w / align) * align),
            max(align, round(h / align) * align))


def shard_align_size(size, mesh_rows: int, mesh_cols: int, tol: float = 0.015):
    """Snap (w, h) to shard-divisible dims for a rows x cols spatial mesh —
    H to a multiple of 16*rows, W to 16*cols — but only when the change
    stays within ``tol`` per axis (so small pyramid scales keep their exact
    aspect). Divisible dims give every rank an equal slab; elsewhere the
    last slab of a row or column of the grid takes the remainder
    (``parallel/mesh.slab_bounds``)."""
    w, h = size
    aw = 16 * mesh_cols
    ah = 16 * mesh_rows
    w2 = max(aw, round(w / aw) * aw)
    h2 = max(ah, round(h / ah) * ah)
    if abs(w2 - w) > tol * w or abs(h2 - h) > tol * h:
        return (w, h)
    return (w2, h2)


def get_safe_scale(w: int, h: int, dim: int) -> int:
    """Largest end_scale for a w x h image such that total pixels stay within
    what a dim x dim square needs (the ``--end-scale N+`` memory cap)."""
    aspect = w / h if w > h else h / w
    return int(aspect ** 0.5 * dim)
