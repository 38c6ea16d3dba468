"""torch-semantics Adam with the clamp to [0, 1], and the EMA of the iterate
(seeded with one update of a zero state), float64; at a new scale the
moments are warm-started (the first resized bicubically, the second
bilinearly and clamped at 0), the count carried on, the EMA fresh."""

import torch
import torch.nn.functional as F


class Optimizer:
    def __init__(self, cfg, image, mu=None, nu=None, count=0):
        self.cfg, self.x = cfg, image.double()
        self.mu = torch.zeros_like(self.x) if mu is None else mu
        self.nu = torch.zeros_like(self.x) if nu is None else nu
        self.count = count
        d = cfg["avg_decay"]
        self.ema, self.accum = (1.0 - d) * self.x, d

    def step(self, g, value_and_grad=None):
        """One update from the gradient ``g`` at ``x`` (``value_and_grad``,
        which a line search would call, is not needed)."""
        c = self.cfg
        self.count += 1
        self.mu = c["beta1"] * self.mu + (1.0 - c["beta1"]) * g
        self.nu = c["beta2"] * self.nu + (1.0 - c["beta2"]) * g * g
        bc1, bc2 = 1.0 - c["beta1"] ** self.count, 1.0 - c["beta2"] ** self.count
        update = c["step_size"] * (self.mu / bc1) / (torch.sqrt(self.nu / bc2) + c["adam_eps"])
        self.x = torch.clamp(self.x - update, 0.0, 1.0)
        d = c["avg_decay"]
        self.ema, self.accum = d * self.ema + (1.0 - d) * self.x, self.accum * d

    def first_grad(self):
        """The first gradient, as the state holds it after one step."""
        return self.mu / (1.0 - self.cfg["beta1"])

    def average(self):
        return self.ema / (1.0 - self.accum)

    def carry(self, image):
        """The optimizer of the next scale, at ``image``."""
        hw = tuple(image.shape[-2:])
        mu = F.interpolate(self.mu, size=hw, mode="bicubic", align_corners=False)
        nu = torch.clamp(F.interpolate(self.nu, size=hw, mode="bilinear",
                                       align_corners=False), min=0.0)
        return Optimizer(self.cfg, image, mu, nu, self.count)
