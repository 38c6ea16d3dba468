#!/usr/bin/env python3
"""Whether the card runs the trunk's full-resolution ops on a canvas whose
64-channel activations hold more than 2^31 elements, at batch 1.

    python3 tools/large_conv_probe_torch.py [H W]      # default 6144 8192

PyTorch cannot split a batch-1 convolution that large; it hands it to cuDNN
only where cuDNN is 9.3 or newer with the v8 API, and otherwise warns
("cuDNN cannot be used for large non-batch-splittable convolutions") and
falls back to a native convolution. This runs, in FP32 (TF32 off) on one
1 x 64 x H x W tensor, conv1_2's shape (64 -> 64, 3x3, zero padding 1)
forward and input gradient, ReLU and 2x2 max pooling forward and backward,
and holds each result against the same op on the two row halves of the
input (with a one-row halo for the conv). Prints one JSON line: cuDNN's
version, the element count, whether the warning came, and each op's max
absolute difference over the result's max. Exits 1 when an op fails or
differs by more than 1e-4 of its max. Needs one GPU and about 60 GB.
"""

import json
import sys
import warnings

import torch
import torch.nn.functional as F

LARGE_CONV_WARNING = "cuDNN cannot be used for large non-batch-splittable convolutions"
TOL = 1e-4


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def probe(h=6144, w=8192, device="cuda:0"):
    """Returns the record printed by ``main``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((1, 64, h, w), device=device, generator=g) - 0.5
    weight = torch.randn((64, 64, 3, 3), device=device, generator=g) * (2 / 576) ** 0.5
    mid = h // 2
    rec = {"cudnn": torch.backends.cudnn.version(), "elements": x.numel(),
           "over_2_31": x.numel() > 2**31}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        # The conv forward and its input gradient (conv_transpose2d with
        # the same weight is that gradient), whole against two halves.
        y = F.conv2d(x, weight, padding=1)
        halves = torch.cat([F.conv2d(x[:, :, :mid + 1], weight, padding=1)[:, :, :mid],
                            F.conv2d(x[:, :, mid - 1:], weight, padding=1)[:, :, 1:]], 2)
        rec["conv_fwd"] = _rel(y, halves)
        halves = None
        dx = torch.nn.grad.conv2d_input(x.shape, weight, y, padding=1)
        top = torch.nn.grad.conv2d_input((1, 64, mid + 1, w), weight,
                                         y[:, :, :mid + 1], padding=1)[:, :, :mid]
        rec["conv_dgrad_top"] = _rel(dx[:, :, :mid - 1], top[:, :, :mid - 1])
        dx = top = y = None
        # ReLU and max pooling forward and backward, whole against halves.
        x.requires_grad_(True)
        p = F.max_pool2d(F.relu(x), 2, 2)
        (gx,) = torch.autograd.grad(p, x, p)
        p, gx = p[:, :, :mid // 2].clone(), gx[:, :, :mid].clone()
        xh = x[:, :, :mid].detach().requires_grad_(True)
        ph = F.max_pool2d(F.relu(xh), 2, 2)
        (gh,) = torch.autograd.grad(ph, xh, ph)
        rec["pool_fwd_top"] = _rel(p, ph)
        rec["pool_bwd_top"] = _rel(gx, gh)
        torch.cuda.synchronize(device)
    rec["large_conv_warning"] = any(LARGE_CONV_WARNING in str(c.message) for c in caught)
    rec["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    rec["ok"] = (not rec["large_conv_warning"]
                 and max(v for k, v in rec.items() if k.startswith(("conv_", "pool_"))) <= TOL)
    return rec


def main(argv):
    if not torch.cuda.is_available():
        print("large_conv_probe_torch.py: no CUDA device", file=sys.stderr)
        return 1
    h, w = (int(v) for v in argv[:2]) if len(argv) >= 2 else (6144, 8192)
    rec = probe(h, w)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
