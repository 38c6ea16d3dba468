"""Newton-Schulz square roots: CUDA kernels, plain versions, autograd.

The kernels (``csrc/ns_sqrtm.cu``) replace the three TPU kernels of
``style_transfer_tpu/ops/pallas/ns_sqrtm.py``, all in FP32 FMA:

* :func:`ns_sqrtm_yz` (``_ns_fwd_yz_kernel``): for (G, C, C) float32
  matrices, (Y, Z) ~ (A^{1/2}, A^{-1/2}) after ``num_iters`` coupled NS
  iterations;
* :func:`ns_sqrtm` (``_ns_fwd_kernel``): the same chain emitting only Y;
* :func:`lyap_bwd` (``_lyap_bwd_kernel``): Q with Z Q + Q Z = G by the
  iterative Lyapunov solver, the backward of the NS square root.

Each wrapper dispatches on the tensor's device alone: a CPU tensor takes the
plain version (``ops/sqrtm.py``); a CUDA tensor launches the kernel or
raises. ``<wrapper>.launches`` counts the kernel launches.
:class:`TraceSqrtmNS` gives ``tr(Y)`` with the backward ½·g·Z outside the
kernel; :class:`SqrtmNSLyap` gives the full square root with the Lyapunov
kernel as its backward, as the JAX package computes them.
"""

import torch

from ..sqrtm import _batch_trace, _lyap_backward, _sqrtm_ns_yz, sqrtm_ns
from . import build

__all__ = [
    "ns_sqrtm_yz", "ns_sqrtm_yz_plain", "TraceSqrtmNS", "trace_sqrtm_ns",
    "ns_sqrtm", "ns_sqrtm_plain", "lyap_bwd", "lyap_bwd_plain",
    "SqrtmNSLyap", "sqrtm_ns_lyap",
]


def ns_sqrtm_yz_plain(a, num_iters: int = 12):
    """The plain PyTorch version: full-FP32 ``torch.matmul`` chain."""
    return _sqrtm_ns_yz(a, num_iters)


def ns_sqrtm_plain(a, num_iters: int = 12):
    """The plain PyTorch version of :func:`ns_sqrtm`."""
    return sqrtm_ns(a, num_iters)


def lyap_bwd_plain(z, g, num_iters: int = 12):
    """The plain PyTorch version of :func:`lyap_bwd`."""
    return _lyap_backward(z, g, num_iters)


def _check_input(name, a, num_iters):
    if a.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {a.dtype}")
    if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(
            f"{name}: expected (C, C) or (G, C, C), got {tuple(a.shape)}")
    if a.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(a.shape)}")
    if num_iters < 0:
        raise ValueError("num_iters must be non-negative")


def _check_cuda_input(name, a):
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    cap = torch.cuda.get_device_capability(a.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"{name}: the kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(a.device)} is sm_{cap[0]}{cap[1]}")


def _launch(name, symbol, inputs, n_out, n_scratch, num_iters):
    """Calls ``symbol(*inputs, *outputs, *scratch, norm, g, n, num_iters,
    stream)`` on the inputs' device and current stream, with every output
    and scratch buffer a fresh (G, C, C) ``torch.empty``. Returns the
    outputs in the inputs' shape."""
    x = inputs[0]
    batched = [t if t.ndim == 3 else t.unsqueeze(0) for t in inputs]
    g, n, _ = batched[0].shape
    outs = [torch.empty_like(batched[0]) for _ in range(n_out)]
    scratch = torch.empty((n_scratch, g, n, n), dtype=torch.float32, device=x.device)
    norm = torch.empty((g,), dtype=torch.float32, device=x.device)
    fn = getattr(build.load(), symbol)
    with torch.cuda.device(x.device):  # launches go to the current device
        err = fn(*(t.data_ptr() for t in batched), *(t.data_ptr() for t in outs),
                 *(t.data_ptr() for t in scratch), norm.data_ptr(), g, n,
                 num_iters, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {err}")
    return [t.view(x.shape) for t in outs]


def ns_sqrtm_yz(a, num_iters: int = 12):
    """(A^{1/2}, A^{-1/2}) of (a batch of) SPD matrices by coupled NS.

    The input must be float32, (C, C) or (G, C, C). CPU tensors take the
    plain version; CUDA tensors must also be contiguous and on an sm_90
    device, and launch the kernel on the current stream. No fallback.
    """
    _check_input("ns_sqrtm_yz", a, num_iters)
    if a.device.type == "cpu":
        return ns_sqrtm_yz_plain(a, num_iters)
    _check_cuda_input("ns_sqrtm_yz", a)
    y, z = _launch("ns_sqrtm_yz", "stt_ns_sqrtm_yz_f32", [a], 2, 3, num_iters)
    ns_sqrtm_yz.launches += 1
    return y, z


ns_sqrtm_yz.launches = 0


def ns_sqrtm(a, num_iters: int = 12):
    """A^{1/2} of (a batch of) SPD matrices by NS; the same input rules and
    dispatch as :func:`ns_sqrtm_yz`."""
    _check_input("ns_sqrtm", a, num_iters)
    if a.device.type == "cpu":
        return ns_sqrtm_plain(a, num_iters)
    _check_cuda_input("ns_sqrtm", a)
    (y,) = _launch("ns_sqrtm", "stt_ns_sqrtm_f32", [a], 1, 4, num_iters)
    ns_sqrtm.launches += 1
    return y


ns_sqrtm.launches = 0


def lyap_bwd(z, g, num_iters: int = 12):
    """Q with Z Q + Q Z = G per matrix, by ``num_iters`` steps of the NS-style
    Lyapunov iteration. ``z`` and ``g`` must have the same shape; the same
    input rules and dispatch as :func:`ns_sqrtm_yz`, for both."""
    _check_input("lyap_bwd", z, num_iters)
    _check_input("lyap_bwd", g, num_iters)
    if z.shape != g.shape:
        raise ValueError(
            f"lyap_bwd: z {tuple(z.shape)} and g {tuple(g.shape)} differ in shape")
    if z.device != g.device:
        raise ValueError(f"lyap_bwd: z on {z.device}, g on {g.device}")
    if z.device.type == "cpu":
        return lyap_bwd_plain(z, g, num_iters)
    _check_cuda_input("lyap_bwd", z)
    _check_cuda_input("lyap_bwd", g)
    (q,) = _launch("lyap_bwd", "stt_lyap_bwd_f32", [z, g], 1, 5, num_iters)
    lyap_bwd.launches += 1
    return q


lyap_bwd.launches = 0


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


class SqrtmNSLyap(torch.autograd.Function):
    """NS square root (:func:`ns_sqrtm`) whose backward is the Lyapunov
    solver (:func:`lyap_bwd`) on the saved result."""

    @staticmethod
    def forward(ctx, a, num_iters, num_iters_backward):
        y = ns_sqrtm(a, num_iters)
        ctx.save_for_backward(y)
        ctx.iters = num_iters if num_iters_backward is None else num_iters_backward
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        # Autograd may hand over a strided or expanded gradient; the wrapper
        # takes only contiguous tensors.
        return lyap_bwd(y, g.contiguous(), ctx.iters), None, None


def sqrtm_ns_lyap(a, num_iters: int = 10, num_iters_backward: int = None):
    """NS square root whose backward solves the Lyapunov equation
    iteratively, saving only the forward result (the port of
    ``sqrtm_ns_lyap_pallas``)."""
    return SqrtmNSLyap.apply(a, num_iters, num_iters_backward)
