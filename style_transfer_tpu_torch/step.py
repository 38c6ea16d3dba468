"""The optimization step: the W2/content/TV objective, the Adam runner, the
reference L-BFGS runner and the L-BFGS runner with a zoom line search.

Port of the monolithic path of ``style_transfer_tpu/step.py``: the loss is
the VGG forward, per-layer moments -> covariance, the square-root term of
``C_t^½·C·C_t^½`` (same-C style layers batched into one (G, C, C) kernel
call), content MSE and TV. With ``w2_grad='trace'`` the square-root term is
``tr sqrtm`` by the coupled Newton-Schulz kernel with the analytic ½·Z
backward; with ``'lyap'`` (the reference's own gradient) it is the full NS
square root with the iterative Lyapunov backward, both kernels.

The runners are eager loops in the reference's order that keep the
per-iteration losses on the device and leave the sync to the caller, once
per chunk: Adam is gradient (image only), Adam, clamp to [0, 1], EMA; L-BFGS
is gradient, a fixed-step L-BFGS update with no clamp, EMA; L-BFGS with the
zoom line search is gradient, the L-BFGS direction and a line search along
it (which reads each trial's value and slope to the host), no clamp, EMA.
"""

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .models.vgg import INPUT, extract_features
from .ops import losses as L
from .ops.cuda.ns_sqrtm import sqrtm_ns_lyap, trace_sqrtm_ns
from .parallel.mesh import all_reduce_
from .utils.ema import EMAState, ema_update
from .zoom_lbfgs import ZoomLBFGSState, zoom_lbfgs_init, zoom_lbfgs_update

__all__ = [
    "StepConfig",
    "AdamState",
    "LBFGSState",
    "LoopState",
    "adam_init",
    "build_loss_fn",
    "build_loss_terms_fn",
    "lbfgs_init",
    "lbfgs_step",
    "make_adam_runner",
    "make_lbfgs_runner",
    "make_lbfgs_zoom_runner",
    "zoom_lbfgs_init",
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
    # coupled NS kernel's Z output; 'lyap' = the reference's iterative
    # Lyapunov backward through the full NS square root.
    w2_grad: str = "trace"
    # Dtype of the VGG trunk: None runs it in FP32, ``torch.bfloat16`` in
    # bf16 (the statistics, the NS kernels and TV stay FP32).
    compute_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.w2_grad not in ("trace", "lyap"):
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
    image: torch.Tensor  # NCHW f32 (in [0, 1] under Adam's clamp)
    opt: "AdamState | LBFGSState | ZoomLBFGSState"
    ema: EMAState


def build_loss_fn(cfg: StepConfig, mesh=None):
    """Returns ``loss(image, params, consts) -> scalar tensor``.

    ``consts`` is ``{'content': {layer: feats}, 'style': {layer: target}}``
    where a style target is a ``W2Target`` (w2 mode) or a Gram matrix. With
    a ``mesh``, ``image`` and the content targets are this rank's slabs, the
    style targets the same on every rank, and the loss is the whole image's.
    """

    def w2_total(moments, consts):
        """W2 style terms, grouped by channel count so same-C layers run
        their Newton-Schulz chains as one batched (G, C, C) kernel call."""
        groups = {}
        for layer, w in zip(cfg.style_layers, cfg.style_layer_weights):
            c = consts["style"][layer].mean.shape[-1]
            groups.setdefault(c, []).append((layer, w))
        trace_fn = trace_sqrtm_ns if cfg.w2_grad == "trace" else None
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
                sqrtm_fn=sqrtm_ns_lyap, trace_sqrtm_fn=trace_fn,
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
        feats = extract_features(params, image, cfg.all_layers, pooling=cfg.pooling,
                                 compute_dtype=cfg.compute_dtype, mesh=mesh)
        moments = {l: L.w2_moments(feats[l], mesh) for l in cfg.style_layers}
        content = 0.0
        for layer, w in zip(cfg.content_layers, cfg.content_weights):
            diff = feats[layer].float() - consts["content"][layer].float()
            if cfg.content_loss == "mse":
                (sse,) = L.all_reduce_sum(mesh, torch.sum(diff * diff))
                content = content + w * sse / L.global_numel(diff, mesh)
            else:  # ScaledMSE
                sse, sabs = L.all_reduce_sum(mesh, torch.sum(diff * diff),
                                             torch.sum(torch.abs(diff)))
                content = content + w * sse / (sabs + 1e-8)
        tv = L.tv_loss(feats[INPUT], mesh)
        return content + style_total(moments, consts) + cfg.tv_weight * tv

    return loss_fn


def build_loss_terms_fn(cfg: StepConfig, mesh=None):
    """Per-term diagnostic: ``terms(image, params, consts) -> {name: scalar}``
    with each weighted objective component separately (the reference's
    ``SumLoss(verbose=True)``). Plain PyTorch, off the optimization path;
    sharded as :func:`build_loss_fn` with a ``mesh``."""

    def terms(image, params, consts):
        feats = extract_features(params, image, cfg.all_layers, pooling=cfg.pooling,
                                 compute_dtype=cfg.compute_dtype, mesh=mesh)
        out = {}
        content_fn = L.content_mse if cfg.content_loss == "mse" else L.content_scaled
        for layer, w in zip(cfg.content_layers, cfg.content_weights):
            out[f"content_{layer}"] = w * content_fn(
                feats[layer], consts["content"][layer], mesh=mesh)
        for layer, w in zip(cfg.style_layers, cfg.style_layer_weights):
            if cfg.style_loss == "w2":
                out[f"style_w2_{layer}"] = w * L.w2_loss(
                    feats[layer], consts["style"][layer], cfg.w2_eps,
                    cfg.sqrtm_iters, mesh=mesh)
            else:
                out[f"style_gram_{layer}"] = w * L.gram_loss(
                    feats[layer], consts["style"][layer], mesh=mesh)
        out["tv"] = cfg.tv_weight * L.tv_loss(feats[INPUT], mesh)
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


def _make_runner(cfg: StepConfig, apply, mesh=None):
    """Returns ``run(params, consts, state, n_steps) -> (state, losses)``:
    ``n_steps`` iterations of loss and gradient (image only) -> ``apply(opt,
    image, g, loss, value_and_grad) -> (image, opt)`` -> EMA, with the
    per-iteration losses in an (n_steps,) tensor on the image's device.
    ``value_and_grad(x)`` is the loss and its gradient at another image,
    each call one autograd graph, freed before it returns."""
    loss_fn = build_loss_fn(cfg, mesh)

    def run(params, consts, state: LoopState, n_steps: int):
        def value_and_grad(image):
            x = image.detach().requires_grad_(True)
            loss = loss_fn(x, params, consts)
            (g,) = torch.autograd.grad(loss, x)
            return loss.detach(), g

        image, opt, ema = state
        losses = torch.empty(n_steps, dtype=torch.float32, device=image.device)
        for k in range(n_steps):
            loss, g = value_and_grad(image)
            image, opt = apply(opt, image, g, loss, value_and_grad)
            ema = ema_update(ema, image, cfg.avg_decay)
            losses[k] = loss
        return LoopState(image=image, opt=opt, ema=ema), losses

    return run


def make_adam_runner(cfg: StepConfig, mesh=None):
    """The Adam runner (see :func:`_make_runner`): gradient -> Adam -> clamp
    to [0, 1] -> EMA, all elementwise (each rank updates its own slab)."""

    def apply(opt, image, g, *_):
        update, opt = _adam_apply(cfg, opt, g)
        return torch.clamp(image - update, 0.0, 1.0), opt

    return _make_runner(cfg, apply, mesh)


class LBFGSState(NamedTuple):
    """Fixed-size circular L-BFGS history (torch.optim.LBFGS semantics), all
    on the image's device."""

    s_hist: torch.Tensor  # (m, *image) past steps s_k = t_k * d_k
    y_hist: torch.Tensor  # (m, *image) past gradient differences
    rho: torch.Tensor  # (m,) 1 / (y_k . s_k)
    num_old: torch.Tensor  # int32: valid history entries
    head: torch.Tensor  # int32: index of the oldest entry (circular)
    d: torch.Tensor  # (*image) last search direction
    t: torch.Tensor  # f32: last step length
    prev_grad: torch.Tensor  # (*image)
    h_diag: torch.Tensor  # f32: initial Hessian scaling
    n_iter: torch.Tensor  # int32: global iteration count


_LBFGS_MEMORY = 10
_LBFGS_TOL_GRAD = 1e-7
_LBFGS_TOL_CHANGE = 1e-9
_LBFGS_YS_MIN = 1e-10


def lbfgs_init(image, memory_size: int = _LBFGS_MEMORY) -> LBFGSState:
    dev = image.device

    def scalar(v, dtype):
        return torch.full((), v, dtype=dtype, device=dev)

    return LBFGSState(
        s_hist=torch.zeros((memory_size, *image.shape), dtype=image.dtype, device=dev),
        y_hist=torch.zeros((memory_size, *image.shape), dtype=image.dtype, device=dev),
        rho=torch.zeros((memory_size,), dtype=torch.float32, device=dev),
        num_old=scalar(0, torch.int32),
        head=scalar(0, torch.int32),
        d=torch.zeros_like(image),
        t=scalar(0.0, torch.float32),
        prev_grad=torch.zeros_like(image),
        h_diag=scalar(1.0, torch.float32),
        n_iter=scalar(0, torch.int32),
    )


def _vdot(a, b, mesh=None):
    """Inner product of two images (of their slabs, summed over the ranks)."""
    return all_reduce_(torch.dot(a.reshape(-1), b.reshape(-1)), mesh)


def _lbfgs_direction(state: LBFGSState, g, lr: float, mesh=None):
    """One torch-semantics L-BFGS direction/step-length computation.

    Matches ``torch.optim.LBFGS`` with ``max_iter=1, history_size=m,
    line_search_fn=None`` (the reference's configuration): history update
    gated on ``ys > 1e-10``, two-loop recursion seeded with
    ``h_diag = ys / yy``, first-iteration step length ``min(1, 1/sum|g|) *
    lr``, then ``lr``. Every decision is a device mask (``torch.where``) and
    the two loops are unrolled over the fixed m, so nothing here reads a
    value back to the host.
    """
    m = state.s_hist.shape[0]
    dev = g.device
    first = state.n_iter == 0
    hist_shape = (m,) + (1,) * g.ndim

    # --- history update (skipped on the first iteration) -----------------
    y = g - state.prev_grad
    s = state.d * state.t
    ys = _vdot(y, s, mesh)
    insert = torch.logical_and(torch.logical_not(first), ys > _LBFGS_YS_MIN)
    slot = (state.head + state.num_old) % m
    at_slot = torch.logical_and(torch.arange(m, device=dev) == slot, insert)
    s_hist = torch.where(at_slot.view(hist_shape), s, state.s_hist)
    y_hist = torch.where(at_slot.view(hist_shape), y, state.y_hist)
    rho = torch.where(at_slot, 1.0 / torch.clamp(ys, min=_LBFGS_YS_MIN), state.rho)
    full = state.num_old == m
    num_old = torch.where(insert, torch.clamp(state.num_old + 1, max=m),
                          state.num_old)
    head = torch.where(torch.logical_and(insert, full), (state.head + 1) % m,
                       state.head)
    h_diag = torch.where(insert, ys / torch.clamp(_vdot(y, y, mesh), min=1e-30),
                         state.h_diag)

    # --- two-loop recursion, over the history in logical order -----------
    order = ((head + torch.arange(m, device=dev)) % m).long()  # oldest first
    s_l = s_hist.index_select(0, order)
    y_l = y_hist.index_select(0, order)
    rho_l = rho.index_select(0, order)
    active = (torch.arange(m, device=dev) < num_old).float()
    q = -g
    al = [None] * m
    for j in reversed(range(m)):  # newest -> oldest
        al[j] = active[j] * rho_l[j] * _vdot(s_l[j], q, mesh)
        q = q - al[j] * y_l[j]
    r = q * h_diag
    for j in range(m):
        be = active[j] * rho_l[j] * _vdot(y_l[j], r, mesh)
        r = r + active[j] * (al[j] - be) * s_l[j]

    d = torch.where(first, -g, r)
    g_l1 = all_reduce_(torch.sum(torch.abs(g)), mesh)
    t0 = torch.clamp(1.0 / torch.clamp(g_l1, min=1e-30), max=1.0)
    t = torch.where(first, t0 * lr, torch.full_like(t0, lr))
    new_state = LBFGSState(
        s_hist=s_hist, y_hist=y_hist, rho=rho, num_old=num_old, head=head,
        d=d, t=t, prev_grad=g, h_diag=h_diag, n_iter=state.n_iter + 1,
    )
    return d, t, new_state


def lbfgs_step(state: LBFGSState, image, g, lr: float, mesh=None):
    """Returns (new_image, new_state) for one reference-flavor iteration."""
    opt_cond = all_reduce_(torch.max(torch.abs(g)), mesh, "max") <= _LBFGS_TOL_GRAD
    d, t, new_state = _lbfgs_direction(state, g, lr, mesh)
    gtd = _vdot(g, d, mesh)
    take = torch.logical_and(torch.logical_not(opt_cond), gtd <= -_LBFGS_TOL_CHANGE)
    new_image = image + take.to(image.dtype) * t * d
    # If converged (opt_cond), torch returns before touching any state.
    new_state = LBFGSState(*(torch.where(opt_cond, old, new)
                             for old, new in zip(state, new_state)))
    return new_image, new_state


def make_lbfgs_runner(cfg: StepConfig, mesh=None):
    """The reference-flavour L-BFGS runner (see :func:`_make_runner`):
    gradient -> L-BFGS step -> EMA, with ``state.opt`` an :class:`LBFGSState`.

    Matches the reference's ``optim.LBFGS(max_iter=1, history_size=10)`` with
    its default lr=1.0 and no line search: a two-loop recursion over a fixed
    10-deep (s, y) history, fixed step length, and no box clamp mid-run (the
    reference clamps only under Adam). ``cfg.step_size`` is ignored. The
    history is a fixed-size device buffer, not ``torch.optim.LBFGS``'s
    Python lists, whose host-side decisions would sync the stream every
    iteration.
    """
    sharded = {} if mesh is None else {"mesh": mesh}  # the one-device call as before
    return _make_runner(
        cfg, lambda opt, image, g, *_: lbfgs_step(opt, image, g, lr=1.0, **sharded), mesh)


def make_lbfgs_zoom_runner(cfg: StepConfig, mesh=None):
    """The ``lbfgs-zoom`` runner (see :func:`_make_runner`): loss and
    gradient -> ``optax.lbfgs(memory_size=10)`` with its zoom line search
    (``zoom_lbfgs.py``), whose trials evaluate the same loss -> EMA, with
    ``state.opt`` a ``ZoomLBFGSState`` (``zoom_lbfgs_init``). No clamp and
    ``cfg.step_size`` ignored, as the JAX runner. As there, the loss and
    gradient at each iterate are computed anew, not taken from the line
    search's last trial, so the evaluations equal the reference's."""
    sharded = {} if mesh is None else {"mesh": mesh}  # the one-device call as before
    return _make_runner(
        cfg, lambda opt, image, g, loss, value_and_grad: zoom_lbfgs_update(
            opt, image, loss, g, value_and_grad, **sharded), mesh)
