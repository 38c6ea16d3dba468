"""Work counts of the step and the table of peaks.

Model FLOPs: what the step's mathematics needs, the same whatever
algorithm runs (FFT, Winograd, remat's recompute), counted once. Work
outside the iterations (the targets) is not counted. Per iteration of the
Adam step on an h x w canvas:

* the trunk: each convolution's forward and its data gradient (the step
  takes the image's gradient only), 2 * 9 * cin * cout FLOPs a pixel of
  its input each;
* the moments at each style tap, f f^T and its backward (G + G^T) f:
  2 * C^2 FLOPs a pixel each;
* the style term past the moments, counted by the configuration's
  ``style_loss`` file (``reference/style/<name>.py``, ``flops``). For W2:
  the products C_t^1/2 C C_t^1/2 and their backward, four C x C products a
  style layer, and the coupled Newton-Schulz chain of each style group:
  from Z_0 = I the first iteration is one product, every later one three,
  2 * C^3 FLOPs a product, ``sqrtm_iters`` iterations.

Bytes, for a roofline: each convolution reads its input and weights once
and writes its output once, in the trunk's dtype; the data gradient the
same of the gradients. A kernel's least time is the larger of its FLOPs
over the peak rate and its bytes over the memory bandwidth.
"""

import json
from pathlib import Path

from . import plugin
from .inputs import trunk_layers

__all__ = ["conv_shapes", "trunk_flops", "trunk_least_s", "moments_flops",
           "ns_groups", "ns_flops", "ns_least_s", "w2_product_flops",
           "step_flops", "peaks", "peak_flops", "gen_scales", "size_to_fit", "scale_canvases"]

_PEAKS = Path(__file__).resolve().parent / "peaks.json"
_DTYPE_BYTES = {"f32": 4, "bf16": 2}


def _taps(cfg):
    return set(cfg["style_layers"]) | set(cfg["content_layers"])


def conv_shapes(cfg, h, w):
    """[(conv index, cin, cout, h, w)] of the trunk's convolutions up to the
    last tap, at the spatial size of each one's input (pools floor-halve)."""
    last, out = max(_taps(cfg)), []
    for layer in trunk_layers(cfg):
        if layer[1] > last:
            break
        if layer[0] == "pool":
            h, w = h // 2, w // 2
        elif layer[0] == "conv":
            out.append((layer[1], layer[2], layer[3], h, w))
    return out


def trunk_flops(cfg, h, w):
    """Forward plus data gradient of every convolution up to the last tap."""
    return sum(2 * 2 * 9 * cin * cout * a * b for _, cin, cout, a, b in conv_shapes(cfg, h, w))


def trunk_least_s(cfg, h, w, peak, bandwidth):
    """The least time of the trunk's convolutions, forward and data
    gradient, each bound by its FLOPs or its bytes."""
    nb, total = _DTYPE_BYTES[cfg["precision"]], 0.0
    for _, cin, cout, a, b in conv_shapes(cfg, h, w):
        flops = 2 * 9 * cin * cout * a * b
        moved = nb * ((cin + cout) * a * b + 9 * cin * cout)
        total += 2 * max(flops / peak, moved / bandwidth)
    return total


def _tap_shapes(cfg, h, w):
    """{tap: (channels, pixels)} of the style taps."""
    out, c = {}, 3
    for layer in trunk_layers(cfg):
        if layer[1] > max(_taps(cfg)):
            break
        if layer[0] == "pool":
            h, w = h // 2, w // 2
        elif layer[0] == "conv":
            c = layer[3]
        if layer[1] in cfg["style_layers"]:
            out[layer[1]] = (c, h * w)
    return out


def moments_flops(cfg, h, w):
    return sum(2 * 2 * c * c * p for c, p in _tap_shapes(cfg, h, w).values())


def ns_groups(cfg):
    """{C: G}: the style layers grouped by channel count, as the step
    batches their square roots."""
    groups = {}
    for c, _ in _tap_shapes(cfg, 64, 64).values():
        groups[c] = groups.get(c, 0) + 1
    return groups


def ns_flops(cfg):
    iters = cfg["sqrtm_iters"]
    products = 1 + 3 * (iters - 1)
    return sum(g * products * 2 * c ** 3 for c, g in ns_groups(cfg).items())


def ns_least_s(cfg, peak, bandwidth):
    """The NS chain's least time: FLOPs over ``peak``, or its FP32 bytes
    (each group's input read, Y and Z written) over ``bandwidth``."""
    moved = sum(g * 3 * 4 * c * c for c, g in ns_groups(cfg).items())
    return max(ns_flops(cfg) / peak, moved / bandwidth)


def w2_product_flops(cfg):
    return sum(g * 4 * 2 * c ** 3 for c, g in ns_groups(cfg).items())


def step_flops(cfg, h, w):
    """Model FLOPs of one evaluation of the loss and its gradient on an
    h x w canvas: an Adam iteration."""
    style = plugin.load("reference/style", cfg["style_loss"])
    return trunk_flops(cfg, h, w) + moments_flops(cfg, h, w) + style.flops(cfg)


def peaks(device_name):
    """The peak rates of a card by its ``torch.cuda.get_device_name``."""
    table = json.loads(_PEAKS.read_text())
    if device_name not in table:
        raise KeyError(f"no peaks for {device_name!r} in {_PEAKS.name}")
    return table[device_name]


def peak_flops(cfg, device_name):
    """The peak a configuration's shares are held against: its ``peak``
    key names the rate."""
    return peaks(device_name)[cfg["peak"]]


def gen_scales(start, end):
    """The reference's sqrt(2) pyramid (``style_transfer.py:268-276``)."""
    scales, i, scale = set(), 0, end
    while scale >= start:
        scales.add(scale)
        i += 1
        scale = round(end / 2 ** (i / 2))
    return sorted(scales)


def size_to_fit(size, max_dim, scale_up=False):
    w, h = size
    if not scale_up and max(h, w) <= max_dim:
        return w, h
    if h > w:
        return round(max_dim * w / h), max_dim
    return max_dim, round(max_dim * h / w)


def scale_canvases(traffic):
    """[(w, h, iterations)] of a pyramid traffic's scales."""
    out = []
    for k, s in enumerate(gen_scales(traffic["min_scale"], traffic["end_scale"])):
        w, h = size_to_fit(traffic["content"], s, scale_up=True)
        out.append((w, h, traffic["initial_iterations"] if k == 0 else traffic["iterations"]))
    return out
