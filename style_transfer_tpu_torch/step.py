"""The optimization step: the W2/content/TV objective and its targets, the
Adam runner, the reference L-BFGS runner, the L-BFGS runner with a zoom
line search, and ``OPTIMIZERS``, the table of the three.

Port of the monolithic path of ``style_transfer_tpu/step.py``: the loss is
the VGG forward, per-layer moments -> covariance, the square-root term of
``C_t^½·C·C_t^½`` (same-C style layers batched into one (G, C, C) kernel
call), content MSE and TV. With ``w2_grad='trace'`` the square-root term is
``tr sqrtm`` by the coupled Newton-Schulz kernel with the analytic ½·Z
backward; with ``'lyap'`` (the reference's own gradient) it is the full NS
square root with the iterative Lyapunov backward, both kernels.

Each runner runs one in-place step body in the reference's order, keeps
the per-iteration losses on the device and leaves the sync to the caller,
once per chunk: Adam is gradient (image only), Adam, clamp to [0, 1], EMA;
L-BFGS is gradient, a fixed-step L-BFGS update with no clamp, EMA; L-BFGS
with the zoom line search is gradient, the L-BFGS direction and a line
search along it (up to 20 trials, each a loss evaluation and one step of
the search's device state), no clamp, EMA. Each body is given as its parts
and a schedule that plays them (:class:`_Body`): Adam's and L-BFGS's one
part once, the zoom iteration's three (its head, one trial played while the
search goes on, its tail). On one card every runner plays each part as the
replay of a CUDA graph captured once per runner (once per scale in the
engine; :class:`_Runner`), the port of the JAX runners' compiled chunk;
elsewhere it calls them. The runner's warm-up and capture are spans of the
recorder (``utils/trace.py``), and the Adam and L-BFGS step times its
sections (forward, loss, backward, update) inside its graph
(:class:`_Sections`); the zoom runner times its trial graph the same way,
records each read of the search's ``go`` as a host wait and counts the
trials of each call (the ``zoom-trials`` counter).
"""

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .models.vgg import INPUT, extract_features
from .ops import losses as L
from .ops.cuda import ns_sqrtm as K
from .ops.cuda import zoom_ls as ZL
from .ops.cuda.ns_sqrtm import trace_sqrtm_ns_groups
from .parallel.mesh import all_reduce_
from .utils import trace as T
from .utils.ema import EMAState, ema_update_
from .zoom_lbfgs import (
    MAX_LINESEARCH_STEPS,
    ZoomLBFGSState,
    ZoomLBFGSUpdate,
    _vdot,
    run_trials,
    zoom_lbfgs_init,
)

__all__ = [
    "OPTIMIZERS",
    "Optimizer",
    "StepConfig",
    "AdamState",
    "LBFGSState",
    "LoopState",
    "adam_bias_corrections",
    "adam_init",
    "build_loss_fn",
    "build_loss_terms_fn",
    "capture_targets",
    "lbfgs_init",
    "lbfgs_step",
    "make_adam_runner",
    "make_lbfgs_runner",
    "make_lbfgs_zoom_runner",
    "runs_as_graph",
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
    # Rematerialise the VGG trunk in the backward, in checkpointed segments
    # (``models/vgg.py``).
    remat: bool = False

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


def _features_and_moments(cfg: StepConfig, mesh, image, params):
    """The trunk's taps and each style layer's ``w2_moments``, taken as the
    trunk makes its tap (``extract_features``' ``at_tap``): the backward
    then holds no full-resolution tap gradient while it runs the deeper
    layers."""
    moments = {}

    def at_tap(layer, feat):
        if layer in cfg.style_layers:
            moments[layer] = L.w2_moments(feat, mesh)

    feats = extract_features(params, image, cfg.all_layers, pooling=cfg.pooling,
                             compute_dtype=cfg.compute_dtype, mesh=mesh,
                             remat=cfg.remat, at_tap=at_tap)
    return feats, moments


def build_loss_fn(cfg: StepConfig, mesh=None, mark=None):
    """Returns ``loss(image, params, consts) -> scalar tensor``.

    ``consts`` is ``{'content': {layer: feats}, 'style': {layer: target}}``
    where a style target is a ``W2Target`` (w2 mode) or a Gram matrix. With
    a ``mesh``, ``image`` and the content targets are this rank's slabs, the
    style targets the same on every rank, and the loss is the whole image's.
    ``mark`` (a :class:`_Sections`' ``mark``) is called with 1 once the
    trunk and the moments are done and with 2 once the scalar loss is.
    """

    def w2_total(moments, consts):
        """W2 style terms, grouped by channel count so same-C layers run
        their Newton-Schulz chains as one batched (G, C, C) group. Under
        ``--w2-grad trace`` every group's chain goes into one call
        (``trace_sqrtm_ns_groups``: one kernel launch on a card); under
        ``lyap`` each group makes its own."""
        groups = {}
        for layer, w in zip(cfg.style_layers, cfg.style_layer_weights):
            c = consts["style"][layer].mean.shape[-1]
            groups.setdefault(c, []).append((layer, w))
        stacked = []
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
            stacked.append((torch.stack(means), torch.stack(covs), target, weights))
        if cfg.w2_grad == "trace":
            traces = trace_sqrtm_ns_groups(
                [L.w2_inner(covs, target) for _, covs, target, _ in stacked], cfg.sqrtm_iters)
            losses_of = [L.w2_losses_from_trace(means, covs, target, tr)
                         for (means, covs, target, _), tr in zip(stacked, traces)]
        else:
            losses_of = [L.w2_losses_batched(means, covs, target, cfg.sqrtm_iters)
                         for means, covs, target, _ in stacked]
        total = 0.0
        for (_, _, _, weights), losses in zip(stacked, losses_of):
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
        feats, moments = _features_and_moments(cfg, mesh, image, params)
        if mark is not None:
            mark(1)
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
        loss = content + style_total(moments, consts) + cfg.tv_weight * tv
        if mark is not None:
            mark(2)
        return loss

    return loss_fn


def build_loss_terms_fn(cfg: StepConfig, mesh=None):
    """Per-term diagnostic: ``terms(image, params, consts) -> {name: scalar}``
    with each weighted objective component separately (the reference's
    ``SumLoss(verbose=True)``). Plain PyTorch, off the optimization path;
    sharded as :func:`build_loss_fn` with a ``mesh``."""

    def terms(image, params, consts):
        feats, moments = _features_and_moments(cfg, mesh, image, params)
        out = {}
        content_fn = L.content_mse if cfg.content_loss == "mse" else L.content_scaled
        for layer, w in zip(cfg.content_layers, cfg.content_weights):
            out[f"content_{layer}"] = w * content_fn(
                feats[layer], consts["content"][layer], mesh=mesh)
        for layer, w in zip(cfg.style_layers, cfg.style_layer_weights):
            mean, srm = moments[layer]
            if cfg.style_loss == "w2":
                out[f"style_w2_{layer}"] = w * L.w2_loss_from_moments(
                    mean, srm, consts["style"][layer], cfg.w2_eps, cfg.sqrtm_iters)
            else:  # the Gram matrix is the second raw moment (``gram_loss``)
                out[f"style_gram_{layer}"] = w * L.scaled_mse(srm, consts["style"][layer])
        out["tv"] = cfg.tv_weight * L.tv_loss(feats[INPUT], mesh)
        return out

    return terms


@torch.no_grad()
def capture_targets(cfg: StepConfig, params, content, styles, mesh=None, *, spans=None,
                    share=None):
    """The ``consts`` of :func:`build_loss_fn`, the trunk in
    ``cfg.compute_dtype`` and the statistics in FP32: ``content``'s features
    (its slab's under a ``mesh``), and at each style layer the statistics of
    the (whole NCHW style image, weight) pairs of ``styles``, blended over
    (mean, second raw moment) and made a ``W2Target`` or a Gram matrix.
    ``spans(name)`` is entered around the stages ``content-feats``,
    ``style-stats`` (an image) and ``finalize``; ``share`` takes each style
    target (the engine's broadcast from rank 0)."""
    scope = spans or (lambda name: contextlib.nullcontext())
    with scope("content-feats"):
        content_feats = extract_features(
            params, content, cfg.content_layers, pooling=cfg.pooling,
            compute_dtype=cfg.compute_dtype, mesh=mesh)
    consts = {"content": {l: content_feats[l] for l in cfg.content_layers}, "style": {}}
    blended = {}
    for style, weight in styles:
        with scope("style-stats"):
            feats = extract_features(params, style, cfg.style_layers, pooling=cfg.pooling,
                                     compute_dtype=cfg.compute_dtype)
            for layer in cfg.style_layers:
                mean, srm = L.w2_moments(feats[layer])
                stats = [s * weight for s in ((mean, srm) if cfg.style_loss == "w2" else (srm,))]
                blended[layer] = ([b + c for b, c in zip(blended[layer], stats)]
                                  if layer in blended else stats)
    with scope("finalize"):
        for layer in cfg.style_layers:
            if cfg.style_loss == "w2":
                target = L.w2_target(*blended[layer], cfg.w2_eps, cfg.sqrtm_iters)
            else:
                (target,) = blended[layer]
            consts["style"][layer] = target if share is None else share(target)
    return consts


def _resize_image(x, hw, method: str = "bicubic"):
    """Resize NCHW ``x`` to (h, w) as the reference does at each crossing
    (``F.interpolate``, align_corners=False, no antialias); the JAX package's
    ``ops/resize.py`` exists to equal this call."""
    return F.interpolate(x, size=tuple(hw), mode=method, align_corners=False)


def adam_init(image) -> AdamState:
    return AdamState(mu=torch.zeros_like(image), nu=torch.zeros_like(image), count=0)


def adam_bias_corrections(cfg: StepConfig, t):
    """(1 - beta1^t, 1 - beta2^t) for a float32 tensor count ``t``, on its
    device, as the JAX package's ``_adam_apply`` computes them: float32
    betas, the power rounded to float32, then 1 - it in float32. The power
    is taken in float64 and rounded, which gives XLA's float32 ``pow``
    bit for bit for counts 1-10 000, where float32 ``pow`` routines
    differ from it by an ulp (2 ulp of the correction)."""

    def power(beta):
        return torch.pow(float(np.float32(beta)), t.double()).float()

    return 1.0 - power(cfg.beta1), 1.0 - power(cfg.beta2)


def _adam_apply(cfg: StepConfig, opt: AdamState, g):
    """PyTorch-semantics Adam (bias-corrected, eps outside the sqrt), with
    ``opt.count`` a float32 0-d tensor on the image's device: the count and
    the bias corrections never leave the device, so a captured graph
    replays them with each replay's own count."""
    count = opt.count + 1
    mu = cfg.beta1 * opt.mu + (1.0 - cfg.beta1) * g
    nu = cfg.beta2 * opt.nu + (1.0 - cfg.beta2) * (g * g)
    bc1, bc2 = adam_bias_corrections(cfg, count)
    update = cfg.step_size * (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_eps)
    return update, AdamState(mu=mu, nu=nu, count=count)


def _adam_carry(opt: AdamState, hw) -> AdamState:
    """Warm-start Adam moments at a new resolution (reference :285-295):
    first moment resized bicubic, second moment bilinear then clamped >= 0."""
    mu = _resize_image(opt.mu, hw, "bicubic")
    nu = torch.clamp(_resize_image(opt.nu, hw, "bilinear"), min=0.0)
    return AdamState(mu=mu, nu=nu, count=opt.count)


def _adam_unpack(arrays, tensor) -> AdamState:
    return AdamState(mu=tensor(arrays["adam_mu"]), nu=tensor(arrays["adam_nu"]),
                     count=int(arrays["adam_count"]))


def _write_(dst, src):
    """Copies the tensors of ``src`` into those of ``dst`` (a tensor or a
    NamedTuple of them, alike in structure) and returns ``dst``."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return dst
    return type(dst)(*map(_write_, dst, src))


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        return type(tree)(*map(_clone, tree))
    return tree


def _value_and_grad(loss_fn, params, consts):
    """``value_and_grad(x)``: the loss and its gradient at the image ``x``,
    each call one autograd graph, freed before it returns."""

    def value_and_grad(image):
        x = image.detach().requires_grad_(True)
        loss = loss_fn(x, params, consts)
        (g,) = torch.autograd.grad(loss, x)
        return loss.detach(), g

    return value_and_grad


class _Sections:
    """Marks that split a captured part into sections, one more mark than
    ``names``. The one-part step body's (:class:`_Step`) are five, ``NAMES``:
    ``forward`` (the trunk with the moments at its taps), ``loss`` (the W2
    terms with the NS chain, content, TV), ``backward`` (the image's
    gradient, with remat's recompute) and ``update`` (the optimizer, clamp,
    EMA and the state's writes). The zoom runner's are two, around one
    trial (``trial``: the loss and gradient at the trial point and the line
    search's step).

    ``fired`` lists the marks of the runner's last call in the order they
    fired (none in a call that only replays). While the runner captures
    (``recording``), each mark also records a CUDA timing event as a node
    of the graph (``external``), on the capture stream where its order
    already joins; every replay then records them anew, and :meth:`ms`
    reads the last replay's sections. Elsewhere the marks record no
    event."""

    NAMES = ("forward", "loss", "backward", "update")

    def __init__(self, names=NAMES):
        self.names = names
        self.fired, self.events, self.recording = [], None, False

    def mark(self, i: int):
        self.fired.append(i)
        if self.recording:
            self.events[i].record()

    def arm(self):
        """New events, recorded by the marks until the capture ends."""
        self.events = [torch.cuda.Event(enable_timing=True, external=True)
                       for _ in range(len(self.names) + 1)]
        self.recording = True

    def ms(self):
        """{section: ms} of the last replay (waiting for it to end)."""
        self.events[-1].synchronize()
        return {name: a.elapsed_time(b)
                for name, a, b in zip(self.names, self.events, self.events[1:])}


class _Body:
    """A step body as :class:`_Runner` runs it: its :meth:`parts` and
    :meth:`iterate`, the schedule that runs an iteration by playing them
    (``play(i)``). ``loss`` is the loss the parts last made. Around them
    the runner calls :meth:`load` (the state it holds for one it is
    handed), :meth:`begin` and :meth:`end` (the state it hands back) around
    a call and :meth:`after` each iteration. This base plays its one part
    once an iteration and holds the caller's optimizer state as it is."""

    linesearch_steps = None

    def iterate(self, play):
        play(0)

    def load(self, opt, device):
        return opt

    def begin(self, n_steps: int, device):
        pass

    def after(self, k: int, static: LoopState):
        pass

    def end(self, opt, n_steps: int):
        return opt


class _Step(_Body):
    """The one-part body: loss and gradient (image only) at
    ``static.image`` -> ``apply(opt, image, g) -> (image, opt)`` -> EMA,
    the new state written into ``static``'s own tensors."""

    def __init__(self, cfg: StepConfig, apply, mesh=None):
        self.sections = _Sections()
        self._loss_fn = build_loss_fn(cfg, mesh, self.sections.mark)
        self._apply, self._decay, self.loss = apply, cfg.avg_decay, None

    def parts(self, params, consts, static: LoopState):
        return [lambda: self.step_(params, consts, static)]

    def step_(self, params, consts, static: LoopState):
        self.sections.mark(0)
        self.loss, g = _value_and_grad(self._loss_fn, params, consts)(static.image)
        self.sections.mark(3)
        image, opt = self._apply(static.opt, static.image, g)
        ema_update_(static.ema, image, self._decay)
        _write_(static.opt, opt)
        static.image.copy_(image)
        self.sections.mark(4)


class _AdamStep(_Step):
    """Adam's body: gradient -> Adam -> clamp to [0, 1] -> EMA. The count is
    a host int in the caller's state and a float32 0-d device tensor in the
    runner's, so that each replay of a graph counts on."""

    def __init__(self, cfg: StepConfig, mesh=None):
        def apply(opt, image, g):
            update, opt = _adam_apply(cfg, opt, g)
            return torch.clamp(image - update, 0.0, 1.0), opt

        super().__init__(cfg, apply, mesh)
        self._count = None

    def load(self, opt: AdamState, device):
        self._count = int(opt.count)
        return opt._replace(count=torch.full((), float(opt.count), dtype=torch.float32,
                                             device=device))

    def end(self, opt: AdamState, n_steps: int):
        self._count += n_steps
        return opt._replace(count=self._count)


def runs_as_graph(device, mesh=None) -> bool:
    """The runners' path choice, by the path alone: on a CUDA device with no
    mesh, every runner runs each iteration as replays of captured CUDA
    graphs. A mesh (gloo stages the halos through host memory) and the CPU
    run eagerly."""
    return torch.device(device).type == "cuda" and mesh is None


@functools.lru_cache(maxsize=None)
def _capture_stream(device):
    """The side stream that graphs on ``device`` are warmed up and captured
    on, one per device, so its cuBLAS workspace is made once."""
    return torch.cuda.Stream(device=device)


def _launch_counts():
    """The launch counts of B1, B2, B3 and the line-search step kernel."""
    return (*K.launch_counts(), ZL.ls_step_.launches)


def _add_launches(counts, times: int = 1):
    K.add_launches(counts[:3], times)
    ZL.ls_step_.launches += times * counts[3]


class _ZoomPhases(_Body):
    """The zoom runner's body in three parts: :meth:`head` (loss and
    gradient at the iterate, the L-BFGS direction, the line search's start:
    :class:`ZoomLBFGSUpdate`), :meth:`trial` and :meth:`tail` (the accepted
    step, the state written, EMA); an iteration plays the head, the trial
    while the search's ``go`` holds (:func:`run_trials`), the tail. What one
    part hands the next stays referenced here, so the graphs' shared pool
    keeps it. The optimizer state is written before the image: it keeps the
    previous iterate, the image itself. ``sections`` time a trial; each call
    records its ``trials`` as the counter ``zoom-trials``, and each
    iteration's line-search evaluations in ``linesearch_steps``."""

    def __init__(self, cfg: StepConfig, mesh=None):
        self._loss_fn, self._decay = build_loss_fn(cfg, mesh), cfg.avg_decay
        self._mesh, self.max_steps = mesh, MAX_LINESEARCH_STEPS
        self.loss = self._update = None
        self.sections, self.trials = _Sections(("trial",)), 0

    def parts(self, params, consts, static: LoopState):
        return [lambda: self.head(params, consts, static), lambda: self.trial(),
                lambda: self.tail(static)]

    def iterate(self, play):
        play(0)
        self.trials += run_trials(lambda: play(1), self._update.search.go, self.max_steps)
        play(2)

    def begin(self, n_steps: int, device):
        self.trials = 0
        self.linesearch_steps = torch.empty(n_steps, dtype=torch.int32, device=device)

    def after(self, k: int, static: LoopState):
        self.linesearch_steps[k] = static.opt.linesearch_steps

    def end(self, opt, n_steps: int):
        T.counter("zoom-trials", self.trials)
        return opt

    def head(self, params, consts, static: LoopState):
        value_and_grad = _value_and_grad(self._loss_fn, params, consts)
        self.loss, g = value_and_grad(static.image)
        self._update = ZoomLBFGSUpdate(static.opt, static.image, self.loss, g,
                                       value_and_grad, self.max_steps, self._mesh)

    def trial(self):
        self.sections.mark(0)
        self._update.search.trial()
        self.sections.mark(1)

    def tail(self, static: LoopState):
        image, opt = self._update.result()
        ema_update_(static.ema, image, self._decay)
        _write_(static.opt, opt)
        static.image.copy_(image)


class _Runner:
    """``run(params, consts, state, n_steps) -> (state, losses)``: ``n_steps``
    iterations of a step body (:class:`_Body`), the per-iteration losses in
    an (n_steps,) float32 tensor on the image's device. For ``lbfgs-zoom``,
    ``linesearch_steps`` is then the chunk's line-search evaluations per
    iteration, an (n_steps,) int32 tensor on that device.

    The runner keeps the state in buffers of its own, which every
    iteration writes in place; the state handed back holds those buffers
    (:meth:`_Body.end`), and passing it back continues from them. Any other
    state is copied into new buffers (and the graphs are captured anew over
    them), so the caller's tensors are never written.

    Every path runs the body's schedule; only what a play does differs. On
    the CPU, under a mesh, or with ``eager`` (a caller's comparison), it
    calls the part. Otherwise (:meth:`graphed`) the runner is the port of
    the JAX package's ``jit`` over ``lax.scan`` with the state donated: the
    first iteration on new buffers calls the parts on a side stream (it is
    a real iteration, and it builds what is made lazily on the device: the
    ImageNet constants, the kernels' one-time attribute setup, cuDNN's
    algorithm choice, cuBLAS's workspace), the next captures each part as a
    CUDA graph over the buffers, params and consts, all in one memory pool
    of their own, and from then on a play replays the part's graph. The
    zoom iteration's host reads one bool per trial and nothing else. (The
    JAX runner's whole search runs on the device; CUDA graphs' conditional
    nodes would do that here, but PyTorch 2.11 does not expose them to
    Python.) With ``StepConfig.remat`` the trunk's recompute runs inside
    the captured backward. The allocator's cached blocks are released
    before a capture, so warm-up and capture do not hold two iterations'
    memory at once. A capture or replay that fails raises. The kernels'
    launch counts (``ops/cuda/ns_sqrtm.py``, ``ops/cuda/zoom_ls.py``) count
    each play of a graph as its capture's launches (the capture's own are
    taken back).

    The warm-up iteration and the capture are spans of the recorder
    (``utils/trace.py``), ``  warm-up`` and ``  capture`` followed by
    ``label`` (the engine's ``@S``), and the synchronize before a capture
    is a ``host_wait``; ``capture_seconds`` is the last capture span's
    seconds. The body's :class:`_Sections` (``sections``) put their events
    in the graphs: :meth:`section_ms` reads the last replay's, and while a
    profiler runs the runner records them in the recorder at its next call,
    and when the recorder is read, stamped with that replay's launch."""

    def __init__(self, body: _Body, mesh=None, eager: bool = False):
        self._body, self._mesh, self._eager = body, mesh, eager
        self.sections = body.sections
        self._static = self._handed = self._inputs = self._graphs = None
        self._warm = False
        self._stamp = self._sampled = None  # the last replay's launch, and the last sampled
        self.capture_seconds = None
        self.label = ""

    @property
    def linesearch_steps(self):
        return self._body.linesearch_steps

    def graphed(self, device) -> bool:
        """Whether this runner replays graphs on ``device``."""
        return not self._eager and runs_as_graph(device, self._mesh)

    def __call__(self, params, consts, state: LoopState, n_steps: int):
        body = self._body
        self.sections.fired = []
        if torch._C._autograd._profiler_enabled():
            self._sample()
            T.RECORDER.set_sampler(self._sample)
        if state is not self._handed:
            self._load(state)
        if self._inputs is None or any(a is not b for a, b in zip(self._inputs,
                                                                  (params, consts))):
            self._graphs = None  # the graphs hold the old ones
            self._inputs = (params, consts)
        device = self._static.image.device
        graphed = self.graphed(device)
        losses = torch.empty(n_steps, dtype=torch.float32, device=device)
        parts = body.parts(params, consts, self._static)
        body.begin(n_steps, device)
        for k in range(n_steps):
            if not graphed:
                body.iterate(lambda i: parts[i]())
                losses[k] = body.loss
            elif self._graphs is not None:
                self._replay(losses, k)
            elif self._warm:
                self._capture(parts, device)
                self._replay(losses, k)
            else:
                with T.span(f"  warm-up{self.label}"):
                    self._warm_up(parts, losses, k, device)
            body.after(k, self._static)
        s = self._static
        self._handed = s._replace(opt=body.end(s.opt, n_steps))
        return self._handed, losses

    def _load(self, state: LoopState):
        self._graphs = self._stamp = None
        self._warm = False
        self._static = _clone(state._replace(
            opt=self._body.load(state.opt, state.image.device)))

    def section_ms(self):
        """{section: ms} of the last graph replay (waiting for it to end),
        or None where no replay ran."""
        return None if self._stamp is None else self.sections.ms()

    def _sample(self):
        """Records the last replay's sections in the recorder, once."""
        if self._stamp != self._sampled:
            T.RECORDER.sample("sections", self._stamp, self.sections.ms())
            self._sampled = self._stamp

    def _warm_up(self, parts, losses, k, device):
        stream, main = _capture_stream(device), torch.cuda.current_stream(device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            self._body.iterate(lambda i: parts[i]())
            losses[k] = self._body.loss
        main.wait_stream(stream)
        self._warm = True

    def _capture(self, parts, device):
        with T.host_wait("capture-sync"):
            torch.cuda.synchronize(device)
        # The eager first iteration leaves its blocks in the allocator's
        # cache, which the capture's own pool cannot take, and the capture
        # cannot free them (no cudaFree while a stream captures): they are
        # released first, so that a canvas near the card's memory holds one
        # iteration's blocks at a time, not two.
        torch.cuda.empty_cache()
        graphs, pool = [], None
        with T.span(f"  capture{self.label}") as span:
            self.sections.arm()
            for part in parts:
                graph, before = torch.cuda.CUDAGraph(), _launch_counts()
                # thread_local: the checkpoint writer and the image saver may
                # fetch on their own threads and streams meanwhile, which
                # "global" forbids.
                with torch.cuda.graph(graph, pool=pool, stream=_capture_stream(device),
                                      capture_error_mode="thread_local"):
                    part()
                # The capture launched nothing: its counts move to the replays.
                recorded = tuple(a - b for a, b in zip(_launch_counts(), before))
                _add_launches(recorded, -1)
                graphs.append((graph, recorded))
                pool = graph.pool()
            self.sections.recording = False
        self.capture_seconds = (span.end_ns - span.start_ns) / 1e9
        self._graphs = graphs

    def _replay(self, losses, k):
        def play(i):
            graph, recorded = self._graphs[i]
            graph.replay()
            _add_launches(recorded)

        self._body.iterate(play)
        self._stamp = T.now_ns()
        losses[k] = self._body.loss


def make_adam_runner(cfg: StepConfig, mesh=None, *, eager: bool = False):
    """The Adam runner (see :class:`_Runner`): gradient -> Adam -> clamp to
    [0, 1] -> EMA, all elementwise (each rank updates its own slab)."""
    return _Runner(_AdamStep(cfg, mesh), mesh, eager)


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


def make_lbfgs_runner(cfg: StepConfig, mesh=None, *, eager: bool = False):
    """The reference-flavour L-BFGS runner (see :class:`_Runner`):
    gradient -> L-BFGS step -> EMA, with ``state.opt`` an :class:`LBFGSState`.

    Matches the reference's ``optim.LBFGS(max_iter=1, history_size=10)`` with
    its default lr=1.0 and no line search: a two-loop recursion over a fixed
    10-deep (s, y) history, fixed step length, and no box clamp mid-run (the
    reference clamps only under Adam). ``cfg.step_size`` is ignored. The
    history is a fixed-size device buffer, not ``torch.optim.LBFGS``'s
    Python lists, whose host-side decisions would sync the stream every
    iteration.
    """
    def apply(opt, image, g):
        return lbfgs_step(opt, image, g, lr=1.0, mesh=mesh)

    return _Runner(_Step(cfg, apply, mesh), mesh, eager)


def _lbfgs_unpack(arrays, tensor) -> LBFGSState:
    return LBFGSState(*(tensor(arrays[f"lbfgs_{name}"]) for name in LBFGSState._fields))


def make_lbfgs_zoom_runner(cfg: StepConfig, mesh=None, *, eager: bool = False):
    """The ``lbfgs-zoom`` runner (see :class:`_Runner`): loss and gradient
    -> ``optax.lbfgs(memory_size=10)`` with its zoom line search
    (``zoom_lbfgs.py``), whose trials evaluate the same loss -> EMA, with
    ``state.opt`` a ``ZoomLBFGSState`` (``zoom_lbfgs_init``). No clamp and
    ``cfg.step_size`` ignored, as the JAX runner. As there, the loss and
    gradient at each iterate are computed anew, not taken from the line
    search's last trial, so the evaluations equal the reference's."""
    return _Runner(_ZoomPhases(cfg, mesh), mesh, eager)


class Optimizer(NamedTuple):
    """What differs between the program's optimizers."""

    init: Callable  # image -> the state a scale starts from
    runner: Callable  # (cfg, mesh=None, *, eager=False) -> its _Runner
    # (state, (h, w)) -> the next scale's state from a scale's last, its
    # image-shaped tensors whole; None: every scale starts from ``init``
    carry: Optional[Callable]
    # save_checkpoint's keyword for the state and its keys' prefix in the
    # file (None: no checkpoint is written), and (arrays, tensor) -> the
    # state from a file's arrays, ``tensor`` putting each on the device
    checkpoint: Optional[str]
    unpack: Optional[Callable]
    no_remat_bytes_per_pixel: dict  # {trunk dtype (None: FP32): bytes a pixel}


# The optimizers the CLI offers, by name. The bytes a pixel are the peak
# device memory allocated by the graphed step without remat at 2896x2172
# with one style: `tools/remat_memory_torch.py sizes=2172x2896
# precisions=f32,bf16 optimizers=adam,lbfgs,lbfgs-zoom remat=off` on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md §6). The engine's
# one-scale runs at 31.6-66.4 Mpx allocated within 0.4% of these per pixel.
OPTIMIZERS = {
    "adam": Optimizer(adam_init, make_adam_runner, _adam_carry, "adam", _adam_unpack,
                      {None: 1818.0, torch.bfloat16: 1150.0}),
    "lbfgs": Optimizer(lbfgs_init, make_lbfgs_runner, None, "lbfgs", _lbfgs_unpack,
                       {None: 2298.0, torch.bfloat16: 1630.0}),
    "lbfgs-zoom": Optimizer(zoom_lbfgs_init, make_lbfgs_zoom_runner, None, None, None,
                            {None: 2334.0, torch.bfloat16: 1666.0}),
}
