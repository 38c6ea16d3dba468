"""The optimization step: the W2/content/TV objective and the Adam runner.

Port of the monolithic path of ``style_transfer_tpu/step.py``: the loss is
the VGG forward, per-layer moments -> covariance, ``tr sqrtm`` of
``C_t^½·C·C_t^½`` by the coupled Newton-Schulz kernel (same-C style layers
batched into one (G, C, C) call), content MSE and TV. The runner is an eager
loop in the reference's order — gradient (image only), Adam, clamp to
[0, 1], EMA — that keeps the per-iteration losses on the device and leaves
the sync to the caller, once per chunk.
"""

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .models.vgg import INPUT, extract_features
from .ops import losses as L
from .ops.cuda.ns_sqrtm import trace_sqrtm_ns
from .utils.ema import EMAState, ema_update

__all__ = [
    "StepConfig",
    "AdamState",
    "LoopState",
    "adam_init",
    "build_loss_fn",
    "build_loss_terms_fn",
    "make_adam_runner",
]


@dataclass(frozen=True)
class StepConfig:
    """Per-scale configuration of the step."""

    content_layers: Tuple[int, ...] = (22,)
    style_layers: Tuple[int, ...] = (1, 6, 11, 20, 29)
    content_weights: Tuple[float, ...] = (0.015,)
    style_layer_weights: Tuple[float, ...] = (
        256 / 341, 64 / 341, 16 / 341, 4 / 341, 1 / 341,
    )
    tv_weight: float = 2.0
    style_loss: str = "w2"  # 'w2' | 'gram'
    content_loss: str = "mse"  # 'mse' | 'scaled'
    pooling: str = "max"
    step_size: float = 0.02
    beta1: float = 0.9
    beta2: float = 0.99
    adam_eps: float = 1e-8
    avg_decay: float = 0.99
    w2_eps: float = 1e-4
    sqrtm_iters: int = 12
    # W2 sqrt-term gradient: 'trace' = analytic ½·A^{-1/2} backward from the
    # coupled NS kernel's Z output. The reference-flavor 'lyap' needs the
    # two kernels that are not ported yet.
    w2_grad: str = "trace"

    def __post_init__(self):
        if self.w2_grad == "lyap":
            raise NotImplementedError(
                "w2_grad='lyap' is not ported yet (its NS forward and "
                "Lyapunov backward kernels are still to port), see ROADMAP")
        if self.w2_grad != "trace":
            raise ValueError(f"unknown w2_grad {self.w2_grad!r}")
        if self.style_loss not in ("w2", "gram"):
            raise ValueError(f"unknown style_loss {self.style_loss!r}")
        if self.content_loss not in ("mse", "scaled"):
            raise ValueError(f"unknown content_loss {self.content_loss!r}")

    @property
    def all_layers(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.content_layers) | set(self.style_layers)))


class AdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: int


class LoopState(NamedTuple):
    image: torch.Tensor  # NCHW f32 in [0, 1]
    opt: AdamState
    ema: EMAState


def build_loss_fn(cfg: StepConfig):
    """Returns ``loss(image, params, consts) -> scalar tensor``.

    ``consts`` is ``{'content': {layer: feats}, 'style': {layer: target}}``
    where a style target is a ``W2Target`` (w2 mode) or a Gram matrix.
    """

    def w2_total(moments, consts):
        """W2 style terms, grouped by channel count so same-C layers run
        their Newton-Schulz chains as one batched (G, C, C) kernel call."""
        groups = {}
        for layer, w in zip(cfg.style_layers, cfg.style_layer_weights):
            c = consts["style"][layer].mean.shape[-1]
            groups.setdefault(c, []).append((layer, w))
        total = 0.0
        for items in groups.values():
            means, covs, t_mean, t_cov, t_cs, weights = [], [], [], [], [], []
            for layer, w in items:
                mean, srm = moments[layer]
                means.append(mean[0])
                covs.append(L.moments_to_cov(mean, srm, cfg.w2_eps)[0])
                tgt = consts["style"][layer]
                t_mean.append(tgt.mean[0])
                t_cov.append(tgt.cov[0])
                t_cs.append(tgt.cov_sqrt[0])
                weights.append(w)
            target = L.W2Target(mean=torch.stack(t_mean), cov=torch.stack(t_cov),
                                cov_sqrt=torch.stack(t_cs))
            losses = L.w2_losses_batched(
                torch.stack(means), torch.stack(covs), target, cfg.sqrtm_iters,
                trace_sqrtm_fn=trace_sqrtm_ns,
            )
            # Python-scalar weights: a host-to-device copy here would
            # synchronize the stream in the middle of every step.
            total = total + sum(w * l for w, l in zip(weights, losses.unbind(0)))
        return total

    def style_total(moments, consts):
        if cfg.style_loss == "w2":
            return w2_total(moments, consts)
        # The reference's per-pixel-normalized Gram matrix equals the second
        # raw moment, so both style losses share the moments path.
        total = 0.0
        for layer, w in zip(cfg.style_layers, cfg.style_layer_weights):
            _, srm = moments[layer]
            total = total + w * L.scaled_mse(srm, consts["style"][layer])
        return total

    def loss_fn(image, params, consts):
        feats = extract_features(params, image, cfg.all_layers, pooling=cfg.pooling)
        moments = {l: L.w2_moments(feats[l]) for l in cfg.style_layers}
        content = 0.0
        for layer, w in zip(cfg.content_layers, cfg.content_weights):
            diff = feats[layer] - consts["content"][layer]
            sse = torch.sum(diff * diff)
            if cfg.content_loss == "mse":
                content = content + w * sse / diff.numel()
            else:  # ScaledMSE
                content = content + w * sse / (torch.sum(torch.abs(diff)) + 1e-8)
        tv = L.tv_loss(feats[INPUT])
        return content + style_total(moments, consts) + cfg.tv_weight * tv

    return loss_fn


def build_loss_terms_fn(cfg: StepConfig):
    """Per-term diagnostic: ``terms(image, params, consts) -> {name: scalar}``
    with each weighted objective component separately (the reference's
    ``SumLoss(verbose=True)``). Plain PyTorch, off the optimization path."""

    def terms(image, params, consts):
        feats = extract_features(params, image, cfg.all_layers, pooling=cfg.pooling)
        out = {}
        content_fn = L.content_mse if cfg.content_loss == "mse" else L.content_scaled
        for layer, w in zip(cfg.content_layers, cfg.content_weights):
            out[f"content_{layer}"] = w * content_fn(
                feats[layer], consts["content"][layer])
        for layer, w in zip(cfg.style_layers, cfg.style_layer_weights):
            if cfg.style_loss == "w2":
                out[f"style_w2_{layer}"] = w * L.w2_loss(
                    feats[layer], consts["style"][layer], cfg.w2_eps,
                    cfg.sqrtm_iters)
            else:
                out[f"style_gram_{layer}"] = w * L.gram_loss(
                    feats[layer], consts["style"][layer])
        out["tv"] = cfg.tv_weight * L.tv_loss(feats[INPUT])
        return out

    return terms


def adam_init(image) -> AdamState:
    return AdamState(mu=torch.zeros_like(image), nu=torch.zeros_like(image), count=0)


def _adam_apply(cfg: StepConfig, opt: AdamState, g):
    """PyTorch-semantics Adam (bias-corrected, eps outside the sqrt). The
    bias corrections are float32 host scalars, as the JAX package computes
    them in float32."""
    count = opt.count + 1
    mu = cfg.beta1 * opt.mu + (1.0 - cfg.beta1) * g
    nu = cfg.beta2 * opt.nu + (1.0 - cfg.beta2) * (g * g)
    t = np.float32(count)
    bc1 = float(np.float32(1.0) - np.power(np.float32(cfg.beta1), t))
    bc2 = float(np.float32(1.0) - np.power(np.float32(cfg.beta2), t))
    update = cfg.step_size * (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_eps)
    return update, AdamState(mu=mu, nu=nu, count=count)


def make_adam_runner(cfg: StepConfig):
    """Returns ``run(params, consts, state, n_steps) -> (state, losses)``:
    ``n_steps`` iterations of gradient -> Adam -> clamp -> EMA, with the
    per-iteration losses in an (n_steps,) tensor on the image's device."""
    loss_fn = build_loss_fn(cfg)

    def run(params, consts, state: LoopState, n_steps: int):
        image, opt, ema = state
        losses = torch.empty(n_steps, dtype=torch.float32, device=image.device)
        for k in range(n_steps):
            x = image.detach().requires_grad_(True)
            loss = loss_fn(x, params, consts)
            (g,) = torch.autograd.grad(loss, x)
            update, opt = _adam_apply(cfg, opt, g)
            image = torch.clamp(image - update, 0.0, 1.0)
            ema = ema_update(ema, image, cfg.avg_decay)
            losses[k] = loss.detach()
        return LoopState(image=image, opt=opt, ema=ema), losses

    return run
