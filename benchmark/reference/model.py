"""Style transfer, written plainly: the trunk, the targets, the loss and
its gradient, the optimizer with the EMA, and the sqrt(2) pyramid, as
crowsonkb/style-transfer-pytorch defines them (``style_transfer.py``), from
the raw inputs of a run.

* The trunk runs in the configuration's precision (``precision``: FP32 with
  TF32 off, or bf16 from the normalized input on, taps upcast), conv1_1
  replicate-padded, the others zero-padded, with the {max: 1, average: 2,
  l2: 0.78} pool rescale.
* Everything after the taps is float64: the moments, the targets, the loss.
  The style and content terms are the configuration's ``style_loss`` and
  ``content_loss``, each a file ``style/<name>.py``, ``content/<name>.py``.
* The image and the optimizer's state are float64, the optimizer the
  configuration's ``optimizer`` (``optim/<name>.py``); the image enters the
  trunk as float32.

``mode`` puts the reference in the program's place for a control: a name of
:mod:`.lowp` (the trunk's convolutions, or the statistics' products, a
precision lower), or a fault (``half_batch``: the moments taken over the
top half of each tap only; ``altered``: each step's new image shifted by
0.01 in its first channel; ``unchanged``: each step leaves the state as it
was).
"""

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from benchmark import plugin
from benchmark.counts import gen_scales, size_to_fit
from benchmark.inputs import trunk_layers
from benchmark.reference.lowp import CONV, STATS, make_conv, make_mm

__all__ = ["fp32_math", "first_steps", "pyramid", "image_tensor", "Mode"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
POOL_SCALES = {"max": 1.0, "average": 2.0, "l2": 0.78}
FAULTS = ("half_batch", "altered", "unchanged")
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def fp32_math():
    """Turns TF32 off for cuDNN convolutions and matmuls, for good."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def image_tensor(img, size, device):
    """A PIL image at ``size`` (w, h), PIL-bicubic-resized if it differs,
    as a (1, 3, h, w) float32 tensor in [0, 1] on ``device``: uint8 bytes
    uploaded and divided there, as the engine does."""
    if img.size != tuple(size):
        img = img.resize(tuple(size), Image.BICUBIC)
    arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
    x = torch.from_numpy(arr.copy()).to(device)
    return (x.permute(2, 0, 1)[None].to(torch.float32) / 255.0).contiguous()


def _plain_conv(x, w, b, padding):
    return F.conv2d(x, w, b, padding=padding)


def _pool(x, mode):
    if mode == "max":
        return F.max_pool2d(x, 2, 2)
    if mode == "average":
        return F.avg_pool2d(x, 2, 2) * POOL_SCALES["average"]
    if mode == "l2":
        return torch.sqrt(F.avg_pool2d(x * x, 2, 2) * 4.0) * POOL_SCALES["l2"]
    raise ValueError(f"unknown pooling {mode!r}")


def trunk(cfg, weights, image, taps, conv=_plain_conv):
    """{tap: activation in the trunk's dtype} for a float32 image in [0, 1]."""
    dtype = _DTYPES[cfg["precision"]]
    mean = torch.tensor(IMAGENET_MEAN, device=image.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=image.device).view(1, 3, 1, 1)
    x = ((image - mean) / std).to(dtype)
    out, last = {}, max(taps)
    for layer in trunk_layers(cfg):
        kind, i = layer[0], layer[1]
        if i > last:
            break
        if kind == "conv":
            w, b = (t.to(dtype) for t in weights[i])
            if i == 0:
                x = conv(F.pad(x, (1, 1, 1, 1), mode="replicate"), w, b, 0)
            else:
                x = conv(x, w, b, 1)
        elif kind == "relu":
            x = F.relu(x)
        else:
            x = _pool(x, cfg["pooling"])
        if i in taps:
            out[i] = x
    return out


class Mode:
    """How the reference computes: ``conv`` for the trunk, ``mm`` for the
    statistics' products, ``half`` the half-batch fault; plain by default."""

    def __init__(self, name=None):
        if name not in (None, *CONV, *STATS, *FAULTS):
            raise ValueError(f"unknown mode {name!r}")
        self.name = name
        self.conv = make_conv(name) if name in CONV else _plain_conv
        self.mm = make_mm(name)
        self.half = name == "half_batch"


def _moments(f, mm, half=False):
    """(mean (C,), second raw moment (C, C)) of a (1, C, H, W) tap, float64."""
    if half:
        f = f[:, :, : max(1, f.shape[2] // 2)]
    f = f.double().flatten(2)[0]
    return f.mean(dim=1), mm(f, f.T) / f.shape[1]


def _style(cfg):
    return plugin.load("reference/style", cfg["style_loss"])


class Targets:
    """The content features and the style targets at one scale."""

    def __init__(self, cfg, weights, content, style, mode):
        with torch.no_grad():
            feats = trunk(cfg, weights, content, set(cfg["content_layers"]), mode.conv)
            self.content = {l: feats[l] for l in cfg["content_layers"]}
            feats = trunk(cfg, weights, style, set(cfg["style_layers"]), mode.conv)
            self.style = {l: _style(cfg).target(*_moments(feats[l], mode.mm), cfg)
                          for l in cfg["style_layers"]}


def loss(cfg, weights, targets, image, mode):
    """The objective at a float32 image: content + style + TV."""
    taps = set(cfg["style_layers"]) | set(cfg["content_layers"])
    feats = trunk(cfg, weights, image, taps, mode.conv)
    total = 0.0
    content = plugin.load("reference/content", cfg["content_loss"])
    cw = cfg["content_weight"] / len(cfg["content_layers"])
    for l in cfg["content_layers"]:
        total = total + cw * content.term(feats[l], targets.content[l])
    sw = np.abs(np.asarray(cfg["style_layer_weights"], np.float64))
    for l, w in zip(cfg["style_layers"], sw / sw.sum()):
        term = _style(cfg).term(*_moments(feats[l], mode.mm, mode.half), targets.style[l], cfg,
                                mode.mm)
        total = total + float(w) * term
    x = image.double()
    x = F.pad(x, (1, 1, 1, 1), mode="replicate")
    c = x[:, :, 1:-1, 1:-1]
    tv = 2.0 * (torch.mean((x[:, :, 1:-1, 2:] - c) ** 2) / 3.0
                + torch.mean((x[:, :, 2:, 1:-1] - c) ** 2) / 3.0
                + torch.mean((x[:, :, 1:, 1:] - x[:, :, :-1, :-1]) ** 2) / 12.0
                + torch.mean((x[:, :, 1:, :-1] - x[:, :, :-1, 1:]) ** 2) / 12.0)
    return total + cfg["tv_weight"] * tv


def _optimizer(cfg, image):
    return plugin.load("reference/optim", cfg["optimizer"]).Optimizer(cfg, image)


def _run(cfg, weights, targets, opt, steps, mode):
    """``steps`` iterations on ``opt``; returns their losses."""

    def value_and_grad(x64):
        x = x64.float().requires_grad_(True)
        value = loss(cfg, weights, targets, x, mode)
        (g,) = torch.autograd.grad(value, x)
        return value.item(), g.double()

    losses = []
    for _ in range(steps):
        value, g = value_and_grad(opt.x)
        losses.append(value)
        if mode.name == "unchanged":
            continue
        opt.step(g, value_and_grad)
        if mode.name == "altered":
            opt.x[:, 0] += 0.01
    return losses


def _targets(cfg, inputs, canvas, scale, mode, device):
    style = inputs["style"]
    content = image_tensor(inputs["content"], canvas, device)
    style = image_tensor(style, size_to_fit(style.size, round(scale)), device)
    return content, Targets(cfg, inputs["weights"], content, style, mode)


def first_steps(cfg, traffic, inputs, steps=3, chunks=None, mode=None):
    """The step cell's first ``steps`` iterations from the scale's fresh
    state (the content image at the canvas, the optimizer's state new), run
    in ``chunks`` (a split of ``steps``). Returns {"losses": [...], "grad1":
    the first gradient, as the optimizer's state holds it after one step,
    "change": the image's change over the steps}, the tensors on the host."""
    fp32_math()
    mode = Mode(mode)
    device = inputs["weights"][0][0].device
    canvas = size_to_fit(traffic["content"], traffic["scale"], scale_up=True)
    content, targets = _targets(cfg, inputs, canvas, traffic["scale"], mode, device)
    opt = _optimizer(cfg, content)
    x0, losses, grad1 = opt.x.clone(), [], None
    for n in chunks or (1, steps - 1):
        losses += _run(cfg, inputs["weights"], targets, opt, n, mode)
        if grad1 is None:
            grad1 = opt.first_grad().cpu()
    return {"losses": losses, "grad1": grad1, "change": (opt.x - x0).cpu()}


def pyramid(cfg, traffic, inputs, iterations, mode=None):
    """A whole stylization at ``iterations`` a scale (the first scale's
    too), as ``StyleTransfer.stylize`` defines it with ``init="content"``:
    each scale's image is the last scale's averaged image clamped and
    bicubically resized, its optimizer the last scale's carried over
    (``Optimizer.carry``). Returns {"losses": every iteration's loss,
    "image": the final averaged image clamped to [0, 1], (H, W, 3) float64,
    "content": the content at the final canvas, the same layout}."""
    fp32_math()
    mode = Mode(mode)
    device = inputs["weights"][0][0].device
    losses, opt = [], None
    for s in gen_scales(traffic["min_scale"], traffic["end_scale"]):
        cw, ch = size_to_fit(traffic["content"], s, scale_up=True)
        content, targets = _targets(cfg, inputs, (cw, ch), s, mode, device)
        if opt is None:
            opt = _optimizer(cfg, content)
        else:
            opt = opt.carry(torch.clamp(F.interpolate(whole, size=(ch, cw), mode="bicubic",
                                                      align_corners=False), 0.0, 1.0))
        losses += _run(cfg, inputs["weights"], targets, opt, iterations, mode)
        whole = torch.clamp(opt.average(), 0.0, 1.0)
    return {"losses": losses, "image": whole[0].permute(1, 2, 0).cpu().numpy(),
            "content": content.double()[0].permute(1, 2, 0).cpu().numpy()}
