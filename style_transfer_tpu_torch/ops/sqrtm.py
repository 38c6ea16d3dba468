"""Differentiable matrix square roots in plain PyTorch (full FP32).

Port of ``style_transfer_tpu/ops/sqrtm.py``: the coupled Newton-Schulz (NS)
iteration, ``tr(sqrtm(A))`` with its analytic ½·g·A^{-1/2} backward, the NS
square root with the iterative Lyapunov backward, and an eigendecomposition
square root with |eigenvalue| semantics.

This module is the CPU path and the oracle for the CUDA kernel in
``ops/cuda/ns_sqrtm.py``. Every product is a full-FP32 ``torch.matmul``:
NS diverges under single-pass low-precision products (a TF32 matmul on the
card is one), so callers on CUDA run with ``allow_tf32`` off.
"""

import torch

__all__ = ["sqrtm_ns", "sqrtm_ns_lyap", "sqrtm_eig", "trace_sqrtm_ns"]


def _check_square(a):
    if a.ndim < 2:
        raise ValueError("expected a matrix or a batch of matrices")
    if a.shape[-2] != a.shape[-1]:
        raise ValueError(f"expected square matrices, got {tuple(a.shape[-2:])}")


def _fro_norm(a):
    return torch.sqrt(torch.sum(a * a, dim=(-2, -1), keepdim=True))


def _eye(n, a):
    return torch.eye(n, dtype=a.dtype, device=a.device)


def _ns_chain(a, num_iters: int):
    """Coupled NS on A/||A||_F: returns (Y, Z, ||A||_F) with
    Y -> (A/n)^{1/2} and Z -> (A/n)^{-1/2} (Higham, "Functions of
    Matrices", ch. 6):
        Y_0 = A / ||A||_F,  Z_0 = I
        T_k = (3 I - Z_k Y_k) / 2
        Y_{k+1} = Y_k T_k,  Z_{k+1} = T_k Z_k
    """
    _check_square(a)
    if num_iters < 0:
        raise ValueError("num_iters must be non-negative")
    eye = _eye(a.shape[-1], a)
    norm = _fro_norm(a)
    y = a / norm
    z = eye.expand_as(a)
    for _ in range(num_iters):
        t = (3.0 * eye - z @ y) * 0.5
        y, z = y @ t, t @ z
    return y, z, norm


def sqrtm_ns(a, num_iters: int = 10):
    """Principal square root of (a batch of) SPD matrices via Newton-Schulz
    (reference sqrtm.py:9-25)."""
    y, _, norm = _ns_chain(a, num_iters)
    return y * torch.sqrt(norm)


def _sqrtm_ns_yz(a, num_iters: int):
    """Coupled NS outputs: (A^{1/2}, A^{-1/2}). Z converges to the inverse
    square root alongside Y at no extra matmul cost."""
    y, z, norm = _ns_chain(a, num_iters)
    sn = torch.sqrt(norm)
    return y * sn, z / sn


def _batch_trace(m):
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


class _TraceSqrtmNS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, num_iters):
        y, zinv = _sqrtm_ns_yz(a, num_iters)
        ctx.save_for_backward(zinv)
        return _batch_trace(y)

    @staticmethod
    def backward(ctx, g):
        (zinv,) = ctx.saved_tensors
        return 0.5 * g[..., None, None] * zinv, None


def trace_sqrtm_ns(a, num_iters: int = 12):
    """``trace(sqrtm(A))`` with the analytic VJP d/dA = A^{-1/2} / 2, which
    the coupled NS iteration already produces as its Z output (the
    Lyapunov equation A^{1/2} X + X A^{1/2} = g I has the closed-form
    solution X = g/2 · A^{-1/2}).

    Returns a scalar per batch element: shape ``a.shape[:-2]``.
    """
    return _TraceSqrtmNS.apply(a, num_iters)


def _lyap_backward(z, g, num_iters: int):
    """Solve ``Z Q + Q Z = G`` for ``Q`` by an NS-style iteration in
    normalized coordinates (reference sqrtm.py:36-47)."""
    eye3 = 3.0 * _eye(z.shape[-1], z)
    norm = _fro_norm(z)
    a = z / norm
    q = g / norm
    for _ in range(num_iters):
        at = a.transpose(-2, -1)
        eye_aa = eye3 - a @ a
        q = (q @ eye_aa - at @ (at @ q - q @ a)) * 0.5
        a = (a @ eye_aa) * 0.5
    return q * 0.5


class _SqrtmNSLyap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, num_iters, num_iters_backward):
        z = sqrtm_ns(a, num_iters)
        ctx.save_for_backward(z)
        ctx.iters = num_iters if num_iters_backward is None else num_iters_backward
        return z

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        return _lyap_backward(z, g, ctx.iters), None, None


def sqrtm_ns_lyap(a, num_iters: int = 10, num_iters_backward: int = None):
    """NS square root whose backward solves the Lyapunov equation
    iteratively, saving only the forward result (reference sqrtm.py:28-55)."""
    return _SqrtmNSLyap.apply(a, num_iters, num_iters_backward)


class _SqrtmEig(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        vals, vecs = torch.linalg.eigh(a)
        s = torch.sqrt(torch.abs(vals))
        ctx.save_for_backward(s, vecs)
        return (vecs * s[..., None, :]) @ vecs.transpose(-2, -1)

    @staticmethod
    def backward(ctx, g):
        s, vecs = ctx.saved_tensors
        vt = vecs.transpose(-2, -1)
        inner = (vt @ (g @ vecs)) / (s[..., :, None] + s[..., None, :])
        return vecs @ (inner @ vt)


def sqrtm_eig(a):
    """Square root via eigendecomposition, A^{1/2} = V diag(sqrt|d|) V^T,
    with the analytic adjoint V ((V^T G V) / (s_i + s_j)) V^T
    (reference sqrtm.py:58-78)."""
    return _SqrtmEig.apply(a)
