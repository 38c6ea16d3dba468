"""LPIPS proper (Zhang et al. 2018), loadable from a local weight bundle.

Port of ``style_transfer_tpu/utils/lpips.py``: the same bundle format,
search path and formula, with the backbone run by PyTorch on an explicit
device (``cuda:0`` by default) in FP32. LPIPS is a learned linear
combination of channel-unit-normalized feature differences from a fixed
ImageNet backbone (AlexNet by default, VGG16 optionally); both the backbone
and the learned head come from a **local .npz bundle** that
``tools/port_lpips.py`` builds wherever the torch checkpoints exist.

Bundle format (.npz), stt-lpips v1:
  meta                      uint8 JSON: {"format": "stt-lpips", "version": 1,
                                         "net": "alex"|"vgg16"}
  conv{i}_kernel            HWIO f32 backbone conv kernels, i = 0..N-1 in
                            forward order (pool positions are implied by
                            ``net``)
  conv{i}_bias              (C_out,) f32
  lin{j}                    (C_j,) f32 nonneg learned head for tap j

:func:`load_bundle` checks the shapes in the file's HWIO layout and turns
the kernels to OIHW once. The computation matches the reference
implementation of LPIPS (richzhang/PerceptualSimilarity,
spatial_average=True, inputs normalized from [0,1]): scaling layer ->
backbone relu taps -> channel-unit normalization (eps 1e-10) -> squared
diff -> 1x1 learned head -> spatial mean -> sum over taps, the last four in
float64.
"""

import json
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["load_bundle", "find_bundle", "lpips", "LPIPS_NETS"]

# Backbone architectures: (out_channels, kernel, stride, pad,
# pool_before: bool, tap: bool). Taps are taken after each entry marked
# tap=True. AlexNet per torchvision .features; VGG16 taps at
# relu{1_2,2_2,3_3,4_3,5_3}.
LPIPS_NETS = {
    "alex": [
        # (cout, k, stride, pad, pool_before, tap)
        (64, 11, 4, 2, False, True),
        (192, 5, 1, 2, True, True),
        (384, 3, 1, 1, True, True),
        (256, 3, 1, 1, False, True),
        (256, 3, 1, 1, False, True),
    ],
    "vgg16": [
        (64, 3, 1, 1, False, False),
        (64, 3, 1, 1, False, True),
        (128, 3, 1, 1, True, False),
        (128, 3, 1, 1, False, True),
        (256, 3, 1, 1, True, False),
        (256, 3, 1, 1, False, False),
        (256, 3, 1, 1, False, True),
        (512, 3, 1, 1, True, False),
        (512, 3, 1, 1, False, False),
        (512, 3, 1, 1, False, True),
        (512, 3, 1, 1, True, False),
        (512, 3, 1, 1, False, False),
        (512, 3, 1, 1, False, True),
    ],
}

# LPIPS ScalingLayer constants (richzhang/PerceptualSimilarity lpips.py):
# applied to inputs already mapped [0,1] -> [-1,1].
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_ENV_VAR = "STT_LPIPS_WEIGHTS"


def _default_search_paths():
    here = Path(__file__).resolve().parents[2]
    cache = Path(os.path.expanduser("~/.cache/style_transfer_tpu"))
    names = ["lpips_alex.npz", "lpips_vgg16.npz", "lpips.npz"]
    for base in (here / "weights", cache):
        for n in names:
            yield base / n


def find_bundle(path=None):
    """Resolve an LPIPS bundle path: explicit arg > $STT_LPIPS_WEIGHTS >
    default locations (repo ./weights/, ~/.cache/style_transfer_tpu/).
    Returns a Path or None."""
    if path is not None:
        p = Path(path)
        return p if p.is_file() else None
    env = os.environ.get(_ENV_VAR)
    if env:
        p = Path(env)
        if p.is_file():
            return p
    for cand in _default_search_paths():
        if cand.is_file():
            return cand
    return None


def load_bundle(path):
    """Load and validate an LPIPS .npz bundle -> dict with 'net', 'convs'
    [(OIHW kernel, bias) CPU tensors, ...], 'lins' [(C,) float64 tensors]."""
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    meta = json.loads(bytes(arrays.pop("meta")).decode())
    if meta.get("format") != "stt-lpips" or meta.get("version") != 1:
        raise ValueError(f"{path}: not a stt-lpips v1 bundle")
    net = meta["net"]
    if net not in LPIPS_NETS:
        raise ValueError(f"{path}: unknown net {net!r}")
    spec = LPIPS_NETS[net]
    convs, cin = [], 3
    for i, (cout, k, _s, _p, _pool, _tap) in enumerate(spec):
        kern = np.asarray(arrays[f"conv{i}_kernel"], np.float32)
        bias = np.asarray(arrays[f"conv{i}_bias"], np.float32)
        if kern.shape != (k, k, cin, cout) or bias.shape != (cout,):
            raise ValueError(
                f"{path}: conv{i} shape {kern.shape} != {(k, k, cin, cout)}")
        convs.append((torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 2, 0, 1))),
                      torch.from_numpy(bias)))
        cin = cout
    lins = []
    taps = [e for e in spec if e[5]]
    for j, entry in enumerate(taps):
        lin = np.asarray(arrays[f"lin{j}"], np.float32)
        if lin.shape != (entry[0],):
            raise ValueError(f"{path}: lin{j} shape {lin.shape} != "
                             f"({entry[0]},)")
        lins.append(torch.from_numpy(lin.astype(np.float64)))
    return {"net": net, "convs": convs, "lins": lins, "path": str(path)}


def _features(bundle, x, device):
    """Backbone relu-tap features of a (1, 3, H, W) [-1,1]-scaled input."""
    out = []
    for (_cout, _k, stride, pad, pool_before, tap), (kern, bias) in zip(
            LPIPS_NETS[bundle["net"]], bundle["convs"]):
        if pool_before:  # torch MaxPool2d(3, 2): no padding, floor mode
            x = F.max_pool2d(x, 3, 2)
        x = F.relu(F.conv2d(x, kern.to(device), bias.to(device), stride=stride,
                            padding=pad))
        if tap:
            out.append(x)
    return out


def lpips(a, b, bundle, device="cuda:0") -> float:
    """LPIPS distance between two HWC float arrays in [0, 1], the backbone
    on ``device`` in FP32."""
    from ..models.vgg import fp32_math
    from .metrics import unit_normalized_sq_diff

    if isinstance(bundle, (str, Path)):
        bundle = load_bundle(bundle)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    device = torch.device(device)

    def prep(x):
        x = x * 2.0 - 1.0  # [0,1] -> [-1,1] (LPIPS normalize=True)
        x = (x - _SHIFT) / _SCALE
        return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None])).to(device)

    total = 0.0
    with fp32_math(device), torch.no_grad():
        fa = _features(bundle, prep(a), device)
        fb = _features(bundle, prep(b), device)
        for x, y, lin in zip(fa, fb, bundle["lins"]):
            d = unit_normalized_sq_diff(x, y)
            total += float((d * lin.to(device).view(1, -1, 1, 1)).sum(1).mean())
    return total
