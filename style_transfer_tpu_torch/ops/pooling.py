"""Spatial ops for the VGG trunk: pooling variants and replicate padding.

Port of ``style_transfer_tpu/ops/pooling.py`` on NCHW tensors. ``max``,
``average`` and ``l2`` (LPPool2d with p=2, which *sums* over the window
before the root) 2x2/stride-2 pooling with floor semantics on odd dims, and
the activation rescale the reference applies when swapping away from max
pooling (max: 1.0, average: 2.0, l2: 0.78).
"""

import torch
import torch.nn.functional as F

__all__ = ["POOLING_SCALES", "pool2x2", "replicate_pad2d", "safe_sqrt"]

# Activation rescale per pooling mode (reference style_transfer.py:22).
POOLING_SCALES = {"max": 1.0, "average": 2.0, "l2": 0.78}


class _SafeSqrt(torch.autograd.Function):
    """sqrt with gradient 0 where the input is 0.

    L2 pooling takes the root of a sum of squares; on an all-zero window
    (common after ReLU) the true derivative is unbounded. ``F.lp_pool2d``'s
    ``pow(1/p)`` backward gives NaN there; this matches the JAX package's
    ``safe_sqrt`` (and LPPool's intended 0)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0, g / (2.0 * y), torch.zeros_like(g))


def safe_sqrt(x):
    return _SafeSqrt.apply(x)


def pool2x2(x, mode: str):
    """2x2 stride-2 pooling over NCHW, floor semantics on odd dims.

    Max pooling's backward routes a tie to the first maximum in row-major
    window order, the tie rule of the JAX package's ``xla``/``first`` impls.
    """
    if mode == "max":
        return F.max_pool2d(x, 2, 2)
    if mode == "average":
        return F.avg_pool2d(x, 2, 2)
    if mode == "l2":
        # 4 * mean of squares is exactly the window sum (a power-of-2 scale).
        return safe_sqrt(F.avg_pool2d(x * x, 2, 2) * 4.0)
    raise ValueError(f"unknown pooling mode {mode!r}")


def replicate_pad2d(x, pad: int = 1):
    """Edge-replicate padding on the spatial dims of an NCHW tensor.

    Built from edge slices and ``torch.cat``, not ``F.pad(mode="replicate")``,
    whose CUDA backward adds the border gradients with atomics: two runs of
    the step would then differ in the last bits, and a resumed run could
    not equal an uninterrupted one. Here autograd sums them in a fixed order.
    """
    x = torch.cat([x[:, :, :1].expand(-1, -1, pad, -1), x,
                   x[:, :, -1:].expand(-1, -1, pad, -1)], dim=2)
    return torch.cat([x[:, :, :, :1].expand(-1, -1, -1, pad), x,
                      x[:, :, :, -1:].expand(-1, -1, -1, pad)], dim=3)
