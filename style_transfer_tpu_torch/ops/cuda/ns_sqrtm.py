"""Coupled Newton-Schulz square root: CUDA kernel, plain version, autograd.

The kernel (``csrc/ns_sqrtm.cu``) replaces the TPU kernel
``_ns_fwd_yz_kernel`` of ``style_transfer_tpu/ops/pallas/ns_sqrtm.py``: for
(G, C, C) float32 matrices it returns (Y, Z) ~ (A^{1/2}, A^{-1/2}) after
``num_iters`` coupled NS iterations, all in FP32 FMA.

:func:`ns_sqrtm_yz` dispatches on the tensor's device alone: a CPU tensor
takes the plain version (``ops/sqrtm.py::_sqrtm_ns_yz``); a CUDA tensor
launches the kernel or raises. ``ns_sqrtm_yz.launches`` counts the kernel
launches. :class:`TraceSqrtmNS` gives ``tr(Y)`` with the backward
½·g·Z outside the kernel, as the JAX package computes it.
"""

import torch

from ..sqrtm import _batch_trace, _sqrtm_ns_yz
from . import build

__all__ = ["ns_sqrtm_yz", "ns_sqrtm_yz_plain", "TraceSqrtmNS", "trace_sqrtm_ns"]


def ns_sqrtm_yz_plain(a, num_iters: int = 12):
    """The plain PyTorch version: full-FP32 ``torch.matmul`` chain."""
    return _sqrtm_ns_yz(a, num_iters)


def _check_input(a, num_iters):
    if a.dtype != torch.float32:
        raise TypeError(f"ns_sqrtm_yz: expected float32, got {a.dtype}")
    if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(
            f"ns_sqrtm_yz: expected (C, C) or (G, C, C), got {tuple(a.shape)}")
    if a.numel() == 0:
        raise ValueError(f"ns_sqrtm_yz: empty input {tuple(a.shape)}")
    if num_iters < 0:
        raise ValueError("num_iters must be non-negative")


def _check_cuda_input(a):
    if not a.is_contiguous():
        raise ValueError("ns_sqrtm_yz: input must be contiguous")
    cap = torch.cuda.get_device_capability(a.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"ns_sqrtm_yz: the kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(a.device)} is sm_{cap[0]}{cap[1]}")


def ns_sqrtm_yz(a, num_iters: int = 12):
    """(A^{1/2}, A^{-1/2}) of (a batch of) SPD matrices by coupled NS.

    The input must be float32, (C, C) or (G, C, C). CPU tensors take the
    plain version; CUDA tensors must also be contiguous and on an sm_90
    device, and launch the kernel on the current stream. No fallback.
    """
    _check_input(a, num_iters)
    if a.device.type == "cpu":
        return ns_sqrtm_yz_plain(a, num_iters)
    if a.device.type != "cuda":
        raise ValueError(f"ns_sqrtm_yz: unsupported device {a.device}")
    _check_cuda_input(a)
    lib = build.load()
    ab = a if a.ndim == 3 else a.unsqueeze(0)
    g, n, _ = ab.shape
    y = torch.empty_like(ab)
    z = torch.empty_like(ab)
    scratch = torch.empty((3, g, n, n), dtype=torch.float32, device=a.device)
    norm = torch.empty((g,), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):  # launches go to the current device
        err = lib.stt_ns_sqrtm_yz_f32(
            ab.data_ptr(), y.data_ptr(), z.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), scratch[2].data_ptr(), norm.data_ptr(),
            g, n, num_iters, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ns_sqrtm_yz: kernel launch failed, cudaError_t {err}")
    ns_sqrtm_yz.launches += 1
    return y.view(a.shape), z.view(a.shape)


ns_sqrtm_yz.launches = 0


class TraceSqrtmNS(torch.autograd.Function):
    """``tr(sqrtm(A))`` per matrix; saves Z ~ A^{-1/2} for the analytic
    backward d tr(A^{1/2}) / dA = A^{-1/2} / 2."""

    @staticmethod
    def forward(ctx, a, num_iters):
        y, z = ns_sqrtm_yz(a, num_iters)
        ctx.save_for_backward(z)
        return _batch_trace(y)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        return 0.5 * g[..., None, None] * z, None


def trace_sqrtm_ns(a, num_iters: int = 12):
    return TraceSqrtmNS.apply(a, num_iters)
