"""Loss functions for optimization-based style transfer (NCHW).

Port of ``style_transfer_tpu/ops/losses.py``. Feature maps are NCHW in
shape here (the JAX package's are NHWC; tests transpose at the boundary),
and channels_last in memory from a bf16 trunk (``models/vgg.py``), which
the moments read as they lie; statistics (means, Gram / second-raw-moment
matrices) live in channel space.

* ``scaled_mse``   — MSE scaled so its gradient L1 norm is ~1.
* ``content_mse``  — plain MSE against fixed target features.
* ``content_scaled`` — ScaledMSE content loss.
* ``gram_matrix`` / ``gram_loss`` — Gram style loss, per-pixel-count
  normalization.
* ``w2_target`` / ``w2_loss`` / ``w2_losses_batched`` — Wasserstein-2 style
  loss on feature distributions N(mean, cov); targets are kept as (mean,
  second raw moment), which combine linearly across style images.
* ``tv_loss``      — L2 total variation, nine-point stencil on a
  replicate-padded image.

Every tap is upcast to FP32 before its moments, Gram and content MSE (the
JAX package's ``_f32``), so a bf16 trunk leaves the objective in FP32; TV
takes the FP32 image. With a ``mesh`` (``parallel/mesh.py``) a function
takes this rank's slab, sums its statistics over the ranks and divides by
the global counts, so every rank returns the whole image's value. Every
matmul and einsum here is full FP32: on CUDA the callers run with
``allow_tf32`` off, because the covariance feeds a Newton-Schulz square root
that diverges under single-pass low-precision products. The W2 square root
goes through the dispatching ``ops/cuda/ns_sqrtm.py::sqrtm_ns_lyap``: on a
CUDA tensor it launches the NS and Lyapunov kernels (or raises), on a CPU
tensor it takes their plain versions.
"""

from typing import NamedTuple

import torch

from ..parallel.mesh import all_reduce_sum, halo_pad
from .cuda.ns_sqrtm import sqrtm_ns_lyap
from .pooling import replicate_pad2d
from .sqrtm import sqrtm_eig

__all__ = [
    "scaled_mse",
    "content_mse",
    "content_scaled",
    "gram_matrix",
    "gram_loss",
    "W2Target",
    "w2_moments",
    "moments_to_cov",
    "w2_target",
    "w2_loss",
    "w2_loss_from_moments",
    "w2_losses_batched",
    "w2_inner",
    "w2_losses_from_trace",
    "tv_loss",
    "global_numel",
]


def _f32(x):
    """FP32 view of a tap (the tensor itself when it is FP32 already)."""
    return x.float()


def global_numel(x, mesh=None) -> int:
    """Elements of the whole NCHW activation whose slab is ``x``."""
    if mesh is None:
        return x.numel()
    h, w = mesh.global_hw(x)
    return x.shape[0] * x.shape[1] * h * w


def scaled_mse(x, target, eps: float = 1e-8, mesh=None):
    """MSE scaled such that its gradient L1 norm is approximately 1 (both
    sums taken over the ranks before the division)."""
    diff = _f32(x) - _f32(target)
    sq, ab = all_reduce_sum(mesh, torch.sum(diff * diff), torch.sum(torch.abs(diff)))
    return sq / (ab + eps)


def content_mse(x, target, mesh=None):
    """Plain MSE content loss (the one the reference engine uses)."""
    diff = _f32(x) - _f32(target)
    if mesh is None:
        return torch.mean(diff * diff)
    (sq,) = all_reduce_sum(mesh, torch.sum(diff * diff))
    return sq / global_numel(diff, mesh)


def content_scaled(x, target, eps: float = 1e-8, mesh=None):
    """ScaledMSE content loss (reference ContentLoss)."""
    return scaled_mse(x, target, eps, mesh)


class _Moments(torch.autograd.Function):
    """Features of any float dtype, (N, C, P) or, with ``pixels_first``,
    (N, P, C) -> the FP32 (N, C) mean over the pixels (their sum with
    ``mean=False``) and (N, C, C) sum over the pixels of f fᵀ. The backward
    makes one full-resolution tensor, (G₂ + G₂ᵀ) f plus the first output's
    gradient spread over the pixels, in the features' own layout, and keeps
    the features in their own dtype. Autograd's backward of the same ops
    would keep an FP32 copy of bf16 features and make four: the matmul's
    two gradients, their sum and the mean's, which at the first tap set the
    step's peak memory."""

    @staticmethod
    def forward(ctx, f, mean: bool, pixels_first: bool):
        ctx.save_for_backward(f)
        ctx.pixels_first = pixels_first
        p = 1 if pixels_first else 2
        ctx.count = f.shape[p] if mean else None
        f32 = _f32(f)
        first = torch.mean(f32, dim=p) if mean else torch.sum(f32, dim=p)
        if pixels_first:
            return first, f32.transpose(1, 2) @ f32
        return first, f32 @ f32.transpose(1, 2)

    @staticmethod
    def backward(ctx, g1, g2):
        (f,) = ctx.saved_tensors
        g1 = g1 if ctx.count is None else g1 / ctx.count
        if ctx.pixels_first:
            out = _f32(f) @ (g2 + g2.transpose(1, 2))
            out.add_(g1.unsqueeze(1))
        else:
            out = (g2 + g2.transpose(1, 2)) @ _f32(f)
            out.add_(g1.unsqueeze(-1))
        return out.to(f.dtype), None, None


def _moments(feats, mean: bool = True):
    """(N, C, H, W) -> (mean or sum over pixels, sum over pixels of f fᵀ),
    in FP32 (see :class:`_Moments`). A channels_last tap (the bf16 trunk's)
    is taken as (N, P, C) and an NCHW one as (N, C, P), each a view, so
    neither is copied, and its gradient comes back in the tap's layout."""
    if feats.is_contiguous(memory_format=torch.channels_last) and not feats.is_contiguous():
        n, c = feats.shape[:2]
        return _Moments.apply(feats.permute(0, 2, 3, 1).reshape(n, -1, c), mean, True)
    return _Moments.apply(feats.flatten(2), mean, False)


def gram_matrix(feats, mesh=None):
    """Gram matrix of NCHW features normalized by pixel count (the
    reference's ``mat @ mat.T / (H*W)``). Returns (N, C, C)."""
    if mesh is None:
        h, w = feats.shape[2:4]
        return _moments(feats)[1] / (h * w)
    return w2_moments(feats, mesh)[1]


def gram_loss(feats, target_gram, eps: float = 1e-8, mesh=None):
    # The Gram matrix is the same on every rank: its MSE is not sharded.
    return scaled_mse(gram_matrix(feats, mesh), target_gram, eps)


class W2Target(NamedTuple):
    """Per-layer W2 style target: N(mean, cov) plus its precomputed sqrt."""

    mean: torch.Tensor  # (N, C)
    cov: torch.Tensor  # (N, C, C), already + eps*I
    cov_sqrt: torch.Tensor  # (N, C, C)


def w2_moments(feats, mesh=None):
    """Mean (N, C) and second raw moment (N, C, C) of NCHW features; with a
    mesh, Σx and Σxxᵀ summed over the ranks, then divided by the global
    pixel count."""
    if mesh is None:
        h, w = feats.shape[2:4]
        mean, s2 = _moments(feats)
        return mean, s2 / (h * w)
    h, w = mesh.global_hw(feats)
    s1, s2 = all_reduce_sum(mesh, *_moments(feats, mean=False))
    return s1 / (h * w), s2 / (h * w)


def _eye_like(x):
    return torch.eye(x.shape[-1], dtype=x.dtype, device=x.device).expand_as(x)


def moments_to_cov(mean, srm, eps: float = 1e-4):
    """(mean, srm) -> covariance + eps*I (shared by loss and target paths)."""
    cov = srm - torch.einsum("nc,nd->ncd", mean, mean)
    return cov + _eye_like(cov) * eps


def _trace(m):
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def w2_target(mean, srm, eps: float = 1e-4, sqrtm_iters: int = 12) -> W2Target:
    """Finalize a blended (mean, srm) pair into a W2Target.

    The target square root uses the eigendecomposition (|eigenvalue|
    semantics): blends with negative style weights can make the blended
    covariance indefinite, where Newton-Schulz diverges. ``sqrtm_iters`` is
    kept for API parity with the JAX package."""
    del sqrtm_iters
    cov = moments_to_cov(mean, srm, eps)
    return W2Target(mean=mean, cov=cov, cov_sqrt=sqrtm_eig(cov))


def w2_loss(feats, target: W2Target, eps: float = 1e-4, sqrtm_iters: int = 12,
            mesh=None):
    """W2(N(m1,C1), N(m2,C2))^2 = |m1-m2|^2 + tr(C1 + C2 - 2 (C2^½ C1 C2^½)^½),
    with the reference's mean-instead-of-sum reductions."""
    mean, srm = w2_moments(feats, mesh)
    return w2_loss_from_moments(mean, srm, target, eps, sqrtm_iters)


def w2_loss_from_moments(mean, srm, target: W2Target, eps: float = 1e-4,
                         sqrtm_iters: int = 12):
    """``w2_loss`` from the features' ``w2_moments``."""
    cov = moments_to_cov(mean, srm, eps)
    mean_diff = torch.mean((mean - target.mean) ** 2)
    inner = target.cov_sqrt @ (cov @ target.cov_sqrt)
    sqrt_term = sqrtm_ns_lyap(inner, sqrtm_iters)
    cov_diff = _trace(target.cov + cov - 2.0 * sqrt_term) / cov.shape[-1]
    return mean_diff + torch.mean(cov_diff)


def w2_losses_batched(means, covs, target: W2Target, sqrtm_iters: int = 12):
    """Per-element W2 losses for a stacked group of layers with equal C,
    through the full square root of the dispatching Lyapunov-backward NS.

    Args: means (G, C); covs (G, C, C) already +eps*I; target fields stacked
    along G. Returns (G,) losses. The trace path (analytic ½·A^{-1/2}
    backward) is :func:`w2_inner`, a trace of the square root, then
    :func:`w2_losses_from_trace`.
    """
    inner = w2_inner(covs, target)
    mean_diff = torch.mean((means - target.mean) ** 2, dim=-1)
    sqrt_term = sqrtm_ns_lyap(inner, sqrtm_iters)
    cov_diff = _trace(target.cov + covs - 2.0 * sqrt_term) / covs.shape[-1]
    return mean_diff + cov_diff


def w2_inner(covs, target: W2Target):
    """The matrices whose square roots the W2 loss takes, stacked like
    ``covs``: ``cov_sqrt_t @ cov @ cov_sqrt_t``."""
    return target.cov_sqrt @ (covs @ target.cov_sqrt)


def w2_losses_from_trace(means, covs, target: W2Target, tr_sqrt):
    """:func:`w2_losses_batched`'s losses from ``tr_sqrt``, the traces of
    the square roots of :func:`w2_inner`'s matrices (G,)."""
    mean_diff = torch.mean((means - target.mean) ** 2, dim=-1)
    cov_diff = (_trace(target.cov + covs) - 2.0 * tr_sqrt) / covs.shape[-1]
    return mean_diff + cov_diff


def tv_loss(image, mesh=None):
    """L2 total variation, nine-point stencil, NCHW input.

    Axis-aligned neighbor diffs weighted 1/3, diagonal diffs 1/12, total x2.
    The axis terms are means over the H x W pixels; the diagonal ones over
    the (H+1) x (W+1) neighbour pairs of the padded image.
    """
    if mesh is not None:
        return _tv_loss_sharded(image, mesh)
    x = replicate_pad2d(image, 1)
    c = x[:, :, 1:-1, 1:-1]
    d1 = torch.mean((x[:, :, 1:-1, 2:] - c) ** 2) / 3.0
    d2 = torch.mean((x[:, :, 2:, 1:-1] - c) ** 2) / 3.0
    d3 = torch.mean((x[:, :, 1:, 1:] - x[:, :, :-1, :-1]) ** 2) / 12.0
    d4 = torch.mean((x[:, :, 1:, :-1] - x[:, :, :-1, 1:]) ** 2) / 12.0
    return 2.0 * (d1 + d2 + d3 + d4)


def _tv_loss_sharded(image, mesh):
    """``tv_loss`` of the whole image from this rank's slab. The slab's
    halo-padded window holds every neighbour pair of its pixels; each
    diagonal pair (i, j) of the padded image is counted by the rank that
    holds pixel (i, j), and the pairs of the padded image's last row and
    column by the last rank of each row and column of the grid."""
    x = halo_pad(image, mesh, replicate=True)
    n, ch, h, w = image.shape
    c = x[:, :, 1:-1, 1:-1]
    r, col = mesh.coord
    dh = h + (r == mesh.grid[0] - 1)
    dw = w + (col == mesh.grid[1] - 1)
    sums = all_reduce_sum(
        mesh,
        torch.sum((x[:, :, 1:-1, 2:] - c) ** 2),
        torch.sum((x[:, :, 2:, 1:-1] - c) ** 2),
        torch.sum((x[:, :, 1:dh + 1, 1:dw + 1] - x[:, :, :dh, :dw]) ** 2),
        torch.sum((x[:, :, 1:dh + 1, :dw] - x[:, :, :dh, 1:dw + 1]) ** 2),
    )
    gh, gw = mesh.canvas
    pixels, pairs = n * ch * gh * gw, n * ch * (gh + 1) * (gw + 1)
    d1, d2 = sums[0] / pixels / 3.0, sums[1] / pixels / 3.0
    d3, d4 = sums[2] / pairs / 12.0, sums[3] / pairs / 12.0
    return 2.0 * (d1 + d2 + d3 + d4)
