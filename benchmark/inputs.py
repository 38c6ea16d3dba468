"""A run's inputs, made from ``--seed``: the VGG weights and the content and
style images, the same for the program and the reference.

The weights are drawn on the run's device with one ``torch.Generator`` in
one call, He-normal kernels and small normal biases (the pretrained VGG-19
is not in the repository). The images are smooth random textures: a sum of
bicubically upsampled normal fields at four octaves, per channel scaled to
mean 0.5 and standard deviation 0.2, clamped and rounded to 8 bits, and
handed over as PIL images, as a user's files would be. Every seed gives the
same sizes; only the values change.
"""

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

__all__ = ["trunk_layers", "make_weights", "make_image", "make_inputs", "program_weights"]

# The program validates all sixteen VGG-19 convolutions; the ones past the
# configuration's last tap are never run and are handed over as zeros.
VGG19_CONVS = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)
VGG19_WIDTHS = (3, 64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512, 512, 512, 512, 512)
BIAS_STD = 0.05
OCTAVES = (256, 64, 16, 4)  # pixels per random sample, coarse to fine
OCTAVE_WEIGHTS = (1.0, 0.5, 0.25, 0.125)


def trunk_layers(cfg):
    """The configuration's trunk as torchvision ``features`` entries:
    ``("conv", index, cin, cout)``, ``("relu", index)``, ``("pool", index)``
    in order (a conv is followed by its ReLU; ``"M"`` in the file is a
    pool)."""
    out, i = [], 0
    for entry in cfg["trunk"]:
        if entry == "M":
            out.append(("pool", i))
            i += 1
        else:
            cin, cout = entry
            out += [("conv", i, cin, cout), ("relu", i + 1)]
            i += 2
    return out


def make_weights(cfg, seed, device):
    """{conv index: (OIHW kernel, bias)} float32 on ``device``, drawn in one
    call of a generator on the device seeded with ``seed``."""
    convs = [l for l in trunk_layers(cfg) if l[0] == "conv"]
    sizes = [cout * cin * 9 + cout for _, _, cin, cout in convs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (_, i, cin, cout), n in zip(convs, sizes):
        w = flat[at:at + cout * cin * 9].view(cout, cin, 3, 3) * float(np.sqrt(2.0 / (9 * cin)))
        b = flat[at + cout * cin * 9:at + n] * BIAS_STD
        out[i] = (w.contiguous(), b.contiguous())
        at += n
    return out


def program_weights(weights):
    """The program's weight dict (``StyleTransfer(weights=...)``): HWIO
    ``conv{i}_kernel`` and ``conv{i}_bias`` host arrays for all sixteen
    VGG-19 convolutions, fetched from the device in one copy."""
    keys = sorted(weights)
    flat = torch.cat([t.reshape(-1) for i in keys for t in weights[i]]).cpu().numpy()
    out, at = {}, 0
    for i in keys:
        w, b = weights[i]
        k = flat[at:at + w.numel()].reshape(w.shape)
        out[f"conv{i}_kernel"] = k.transpose(2, 3, 1, 0)
        out[f"conv{i}_bias"] = flat[at + w.numel():at + w.numel() + b.numel()]
        at += w.numel() + b.numel()
    for k, i in enumerate(VGG19_CONVS):
        if f"conv{i}_kernel" not in out:
            cin, cout = VGG19_WIDTHS[k], VGG19_WIDTHS[k + 1]
            out[f"conv{i}_kernel"] = np.zeros((3, 3, cin, cout), np.float32)
            out[f"conv{i}_bias"] = np.zeros((cout,), np.float32)
    return out


def make_image(w, h, seed, salt, device):
    """A (w, h) RGB PIL image from ``seed`` (``salt`` tells the images of
    one run apart)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 8 + salt)
    shapes = [(max(2, -(-h // s)), max(2, -(-w // s))) for s in OCTAVES]
    flat = torch.randn(sum(3 * a * b for a, b in shapes), generator=gen, device=device)
    x, at = torch.zeros(1, 3, h, w, device=device), 0
    for (a, b), amp in zip(shapes, OCTAVE_WEIGHTS):
        field = flat[at:at + 3 * a * b].view(1, 3, a, b)
        x += amp * F.interpolate(field, size=(h, w), mode="bicubic", align_corners=False)
        at += 3 * a * b
    x = (x - x.mean(dim=(2, 3), keepdim=True)) / x.std(dim=(2, 3), keepdim=True)
    x = torch.clamp(0.5 + 0.2 * x, 0.0, 1.0)
    arr = torch.round(x[0].permute(1, 2, 0) * 255.0).to(torch.uint8).cpu().numpy()
    return Image.fromarray(arr)


def make_inputs(cfg, traffic, seed, device):
    """{"weights", "content", "style"} for one run."""
    device = torch.device(device)
    cw, ch = traffic["content"]
    sw, sh = traffic["style"]
    return {
        "weights": make_weights(cfg, seed, device),
        "content": make_image(cw, ch, seed, 1, device),
        "style": make_image(sw, sh, seed, 2, device),
    }
