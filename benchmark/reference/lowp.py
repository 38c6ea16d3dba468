"""The controls that ``correct`` must fail: the reference put in the
program's place with one of the configuration's stated precisions a step
lower. Both configurations state FP32 with TF32 off for the statistics, the
Newton-Schulz chain and the optimizer, and FP32 or bf16 for the trunk, so
each has two controls (``LOWER``):

* the trunk's convolutions lower (``make_conv``). A convolution here rounds
  its operands to the lower format and accumulates in the trunk's own
  dtype, as tensor cores do: the forward rounds the input and the kernel,
  the data gradient the incoming gradient and the kernel;
* ``tf32_ns``: the statistics' products in TF32 (``make_mm``): the
  moments' f f^T, the W2 products C_t^1/2 C C_t^1/2 and every product of
  the Newton-Schulz chain, their operands rounded to TF32 and multiplied
  exactly (the product of two TF32 values is exact in FP32); the gradient
  passes the rounding as it is.

The lower formats:

* ``tf32`` (below FP32 with TF32 off): operands rounded to TF32's 10-bit
  mantissa, to nearest with ties away from zero (``cvt.rna.tf32.f32``);
  FP32 products of two TF32 values are exact.
* ``fp8`` (below bf16): the forward's operands in e4m3, the gradient in
  e5m2, each tensor scaled by a power of two that puts its largest
  magnitude at the format's largest (per-tensor scaling, as fp8 training
  does); power-of-two scales keep the rounded values exact in bf16.
"""

import torch
import torch.nn.functional as F

__all__ = ["tf32_round", "fp8_round", "make_conv", "make_mm", "CONV", "STATS", "LOWER"]

# The controls of each trunk precision: the trunk a step lower, and the
# statistics (FP32 with TF32 off in both) a step lower.
LOWER = {"f32": ("tf32", "tf32_ns"), "bf16": ("fp8", "tf32_ns")}
CONV = ("tf32", "fp8")  # the modes that lower the trunk's convolutions
STATS = ("tf32_ns",)  # the modes that lower the statistics' products
_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def tf32_round(x):
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def fp8_round(x, fmt):
    """``x`` rounded to the fp8 format ``fmt`` under a per-tensor power-of-two
    scale, in ``x``'s dtype."""
    dtype, largest = _FP8[fmt]
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, torch.exp2(torch.ceil(torch.log2(amax / largest))),
                        torch.ones_like(amax)).to(x.dtype)
    return (x / scale).to(dtype).to(x.dtype) * scale


def _rounders(mode):
    if mode == "tf32":
        return tf32_round, tf32_round
    if mode == "fp8":
        return (lambda x: fp8_round(x, "e4m3")), (lambda g: fp8_round(g, "e5m2"))
    raise ValueError(f"unknown lower precision {mode!r}")


class _RoundedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, padding, fwd, bwd):
        xq, wq = fwd(x), fwd(w)
        ctx.save_for_backward(wq)
        ctx.shape, ctx.padding, ctx.bwd = x.shape, padding, bwd
        return F.conv2d(xq, wq, b, padding=padding)

    @staticmethod
    def backward(ctx, g):
        (wq,) = ctx.saved_tensors
        gx = torch.nn.grad.conv2d_input(ctx.shape, wq, ctx.bwd(g), padding=ctx.padding)
        return gx, None, None, None, None, None


def make_conv(mode):
    """``conv(x, w, b, padding)`` computing in ``mode`` (see the module
    docstring); the bias is added in the trunk's dtype. The weights are
    frozen: no kernel gradient."""
    fwd, bwd = _rounders(mode)

    def conv(x, w, b, padding):
        return _RoundedConv.apply(x, w, b, padding, fwd, bwd)

    return conv


def _tf32_through(x):
    """``x`` rounded to TF32 (through float32), its gradient passed as it is."""
    return x + (tf32_round(x.detach().float()).to(x.dtype) - x).detach()


def make_mm(mode):
    """The statistics' product ``mm(a, b)``: plain, or under ``tf32_ns`` with
    both operands rounded to TF32."""
    if mode not in STATS:
        return torch.matmul

    def mm(a, b):
        return _tf32_through(a) @ _tf32_through(b)

    return mm
