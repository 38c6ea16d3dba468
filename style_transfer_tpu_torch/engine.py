"""StyleTransfer engine: the sqrt(2) pyramid over the Adam or L-BFGS step.

Port of ``style_transfer_tpu/engine.py`` for the optimizers ``adam``,
``lbfgs`` (the reference's fixed-step L-BFGS) and ``lbfgs-zoom`` (optax's
L-BFGS with a zoom line search) and both W2 gradients (``trace`` and the
reference's ``lyap``): the same ``StyleTransfer``/``stylize`` surface and
defaults, the same per-iteration ``STIterate`` callback contract, host-side
``numpy.random.RandomState`` inits (bit-identical to the JAX package's),
per-scale target capture with multi-style blending over (mean, second raw
moment), the Adam-moment warm-start at each scale crossing, a fresh L-BFGS
state at each scale, and checkpoint/resume in the JAX package's file
format (``utils/checkpoint.py``; not for ``lbfgs-zoom``, as there).

Tensors are NCHW on ``device``. ``get_image_tensor`` returns the JAX
package's ``(H, W, 3)`` float array; ``get_image`` a PIL image or a uint16
array. The VGG trunk runs in FP32 by default or in bf16
(``compute_dtype``); everything else runs in FP32: on CUDA, ``stylize``
turns TF32 off for matmuls and cuDNN convolutions, because the
Newton-Schulz square root diverges under single-pass low-precision products
and parity with the reference needs FP32 convolutions. ``remat`` (the JAX
engine's) rematerialises the trunk in the backward at the scales that need
it, so that one card holds a canvas whose trunk activations do not fit
whole; under ``remat=None`` a CUDA device decides by the card's measured
peak per pixel (``auto_remat``), under the expandable allocator segments
that the engine sets up on a CUDA device.

With a ``mesh`` (``parallel/mesh.py``) the engine is one rank of a sharded
run: every rank calls ``stylize`` with the same arguments, holds its slab of
each scale's canvas (the canvas snapped to shard-divisible sizes as the JAX
engine's), gathers the whole image and Adam's moments to cross a scale and
re-slices them, and takes part in every gather; only rank 0 runs the
callbacks and writes checkpoints. An interrupt stops every rank after the
same chunk: a ``KeyboardInterrupt`` from rank 0's callbacks or a Ctrl-C on
any rank (``Mesh.interrupt``) is agreed on at the chunk's end, and every
rank then raises ``KeyboardInterrupt`` out of ``stylize``.

``stylize`` records each of its phases as a span of the recorder
(``utils/trace.py``), under the JAX engine's names (``phase_totals``):
``prologue`` (from the call to the first scale), ``scale-entry@S``,
``targets@S`` (with the indented ``  targets:*`` spans inside it),
``chunk1@SxN`` / ``chunk@SxN``, ``callbacks@S`` (the ``STIterate`` loop
after a chunk), ``ckpt-snapshot@S``, ``scale-exit@S`` and ``final-image``;
the runner's ``  warm-up@S`` and ``  capture@S`` (its capture and
instantiation of the scale's CUDA graphs) lie inside the scale's first
chunk. On CUDA every phase but a chunk, the callbacks and ``final-image``
ends with a device synchronize, so its device work is billed to it and not
to the next chunk; a chunk ends in its host read of its losses. Each point
where the host blocks on the device is a ``host_wait`` of the recorder.
With ``STT_DEBUG_TIMING`` set each phase's time is printed as it ends, and
each scale's section times of the step (``step._Runner.section_ms``) at
its end.

What differs between the optimizers is ``step.OPTIMIZERS``; a scale's
entry is ``_enter_scale``. The runners (``step.py``) write the state's
tensors in place, and on the card replay CUDA graphs captured once per
scale over them, so the engine copies what must outlive a chunk: the
checkpoint snapshot is copied on the device at submit, and the memoized
host image is keyed on a count of chunks, not on the EMA state (the same
tensors every chunk). At a scale's end it reads the final state, then
drops the runner, its buffers, its graphs and their memory pool before
the next scale allocates.
"""

import math
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from PIL import Image

from .models import weights as W
from .models.vgg import cast_params, fp32_math
from .parallel.mesh import (
    all_reduce_,
    any_rank_stops,
    broadcast,
    gather_image,
    largest_slab,
    shard_image,
)
from .step import (
    OPTIMIZERS,
    LoopState,
    StepConfig,
    _resize_image,
    build_loss_terms_fn,
    capture_targets,
)
from .utils import trace as T
from .utils.checkpoint import AsyncCheckpointWriter, load_checkpoint, unpack_rng_state
from .utils.ema import EMAState, ema_get, ema_init
from .utils.scales import align_size, gen_scales, shard_align_size, size_to_fit
from .utils.trace import STIterate, host_wait, peak_device_ram, reset_peak_device_ram, span

__all__ = ["StyleTransfer", "auto_remat", "phase_totals", "predicted_peak_bytes",
           "tensor_to_image", "use_expandable_segments"]

def phase_totals(reset: bool = False) -> dict:
    """Snapshot {phase name: cumulative seconds}; optionally reset. The
    seconds of every span of the recorder (``utils/trace.py``), always
    collected; ``tools/bench_pyramid_torch.py`` attributes a run's
    non-iterating wall to these phases and the rest to "untimed"."""
    return T.phase_totals(reset)


def _pil_to_nchw(image: Image.Image, size=None, device="cpu"):
    """PIL RGB -> (1, 3, H, W) f32 in [0,1] on ``device``, optional bicubic
    resize. The uint8 bytes are uploaded and converted there (exact)."""
    if size is not None and image.size != tuple(size):
        image = image.resize(tuple(size), Image.BICUBIC)
    arr = np.asarray(image.convert("RGB"), dtype=np.uint8)
    x = torch.from_numpy(arr.copy()).to(device)
    return (x.permute(2, 0, 1)[None].to(torch.float32) / 255.0).contiguous()


def _to_nhwc(x):
    """NCHW (or (m, N, C, H, W)) tensor -> the checkpoint's channels-last
    layout, as a view."""
    return x.movedim(-3, -1)


def _from_nhwc(arr, device):
    """A checkpoint's channels-last array -> a contiguous tensor on ``device``
    with the channels at dim -3."""
    x = torch.from_numpy(np.ascontiguousarray(arr))
    return x.movedim(-1, -3).contiguous().to(device)


# remat=None rematerialises a scale whose predicted no-remat peak exceeds
# this share of the device's memory; the rest holds the CUDA context and
# the slack of the graphs' private pools (fixed segments). With expandable
# segments the allocator's cache gives back free pages under pressure, so
# what it reserves beyond that is not needed.
REMAT_MEMORY_SHARE = 0.9
# Off CUDA, remat=None keeps the JAX engine's rule (its ``auto_remat``):
# rematerialise a canvas above 14 Mpx.
JAX_REMAT_PIXELS = 14_000_000
_ALLOC_CONF_VARS = ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF")


def use_expandable_segments():
    """Gives PyTorch's CUDA caching allocator expandable segments for the
    rest of the process, unless its environment configured the allocator
    (``PYTORCH_CUDA_ALLOC_CONF`` or ``PYTORCH_ALLOC_CONF``). With fixed
    segments a step near the card's memory lost up to a third of the card
    to fragmentation, which ``auto_remat``'s margin does not cover (PERF.md
    §6). CUDA graphs' private pools keep fixed segments."""
    if not any(os.environ.get(k) for k in _ALLOC_CONF_VARS):
        torch._C._accelerator_setAllocatorSettings("expandable_segments:True")


def predicted_peak_bytes(h: int, w: int, compute_dtype=None, mesh=None,
                         optimizer: str = "adam") -> float:
    """The predicted peak device memory of the step without remat on an h x
    w canvas (``step.OPTIMIZERS``' bytes a pixel): of its largest slab under
    a ``mesh`` (ranks that share one device are not summed)."""
    if mesh is not None:
        h, w = largest_slab(h, w, mesh)
    return OPTIMIZERS[optimizer].no_remat_bytes_per_pixel[compute_dtype] * h * w


def auto_remat(h: int, w: int, compute_dtype=None, total_memory=None, mesh=None,
               optimizer: str = "adam") -> bool:
    """``remat=None``'s choice for an h x w canvas. With ``total_memory``
    (a CUDA device's bytes): whether ``predicted_peak_bytes`` exceeds
    ``REMAT_MEMORY_SHARE`` of it, which holds under expandable segments
    (``use_expandable_segments``). Without (the CPU): the JAX engine's rule
    on the canvas."""
    if total_memory is None:
        return h * w > JAX_REMAT_PIXELS
    return (predicted_peak_bytes(h, w, compute_dtype, mesh, optimizer)
            > REMAT_MEMORY_SHARE * total_memory)


def _resolve_compute_dtype(compute_dtype):
    """'auto' | 'f32' | 'float32' | None -> None (FP32 trunk); 'bf16' |
    'bfloat16' -> torch.bfloat16. The JAX package's 'auto' picks bf16 only
    on a TPU, so here it is FP32 on every device."""
    if compute_dtype in (None, "auto", "f32", "float32"):
        return None
    if compute_dtype in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {compute_dtype!r}")


class StyleTransfer:
    """Optimization-based neural style transfer in PyTorch.

    Args:
      device: torch device or name ('cuda:0', 'cpu').
      pooling: 'max' | 'average' | 'l2'.
      weights: path to VGG-19 weights (.npz native or torchvision .pth), or a
        dict of HWIO arrays; None resolves via models/weights.py.
      style_loss: 'w2' (default, reference behavior) or 'gram'.
      content_loss: 'mse' (reference default) or 'scaled'.
      w2_grad: 'trace' (analytic ½·A^{-1/2} VJP, the default) or 'lyap'
        (the reference's iterative Lyapunov backward).
      compute_dtype: VGG trunk dtype: 'auto' (FP32 on every device; the JAX
        package picks bf16 only on a TPU), 'f32'/'float32' or
        'bf16'/'bfloat16'.
      callback_chunk: iterations per host sync. Telemetry is emitted per
        iteration; wall-times within a chunk are interpolated.
      remat: rematerialise the VGG trunk in the backward (a memory tool:
        one more trunk forward per iteration, for a lower peak): None
        decides per scale (``auto_remat``: on a CUDA device when the
        predicted peak without it exceeds 90% of the device's memory, on
        the CPU above 14 Mpx, the JAX engine's rule), or a bool.
        ``remat_scales`` records each scale's choice. On a CUDA device the
        engine gives the allocator expandable segments
        (``use_expandable_segments``), which the rule assumes.
      mesh: this process's ``parallel.mesh.Mesh`` for a sharded run (its
        device replaces ``device``), or None.
    """

    def __init__(
        self,
        device="cuda:0",
        pooling: str = "max",
        *,
        weights=None,
        style_loss: str = "w2",
        content_loss: str = "mse",
        w2_grad: str = "trace",
        compute_dtype="auto",
        callback_chunk: int = 50,
        remat: Optional[bool] = None,
        mesh=None,
    ):
        if remat not in (None, True, False):
            raise ValueError(f"remat must be None, True or False, not {remat!r}")
        self.remat = remat
        # Each scale's {"w", "h", "remat", "predicted_peak_mib"} (the
        # predicted no-remat peak: None where the rule did not decide).
        self.remat_scales = []
        self.mesh = mesh
        self._scale_mesh = None  # the mesh placed on the current canvas
        self.device = torch.device(device if mesh is None else mesh.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device!r} requested but CUDA is not available")
            use_expandable_segments()
        if pooling not in ("max", "average", "l2"):
            raise ValueError(f"unknown pooling mode {pooling!r}")
        self.pooling = pooling
        # Validates the loss modes now.
        StepConfig(style_loss=style_loss, content_loss=content_loss, w2_grad=w2_grad)
        self.style_loss = style_loss
        self.content_loss = content_loss
        self.w2_grad = w2_grad
        self.compute_dtype = _resolve_compute_dtype(compute_dtype)
        self.callback_chunk = int(callback_chunk)

        # Default layer configuration (Gatys et al. 2015 taps, reference
        # weighting, ref :315-322).
        self.content_layers = [22]
        self.style_layers = [1, 6, 11, 20, 29]
        sw = [256, 64, 16, 4, 1]
        total = sum(abs(w) for w in sw)
        self.style_layer_weights = [w / total for w in sw]

        if isinstance(weights, dict):
            params, self.weights_source = weights, "caller-provided"
        else:
            params, self.weights_source = W.resolve_params(weights)
        self.params = W.params_from_jax(params, self.device)
        self._params_cast = None  # the params in compute_dtype, made once

        self.image = None  # (1, 3, H, W) f32 current iterate
        self.average = None  # EMAState
        self._last_cfg = self._last_consts = None
        self._rng = np.random.RandomState(0)
        # The averaged iterate's version, one more each time ``average`` is
        # set (every chunk), and the version the cached host image is of.
        self._avg_version = 0
        self._img_cache_key = None
        self._img_cache = None
        self._whole_avg = None  # under a mesh: the EMA's whole image (_set_average)

    # ------------------------------------------------------------------ API

    def seed(self, seed: int):
        self._rng = np.random.RandomState(seed)

    def get_image_tensor(self):
        """Current averaged iterate as an (H, W, 3) f32 ndarray in [0, 1].

        Memoized per chunk: the state changes once per chunk but callbacks
        run per iteration, so the device is read once a chunk however many
        callbacks (the web preview's feed) ask. The key is the chunk's
        version, not the EMA state, whose tensors the runners reuse."""
        if self.average is None:
            return None
        if self._img_cache_key != self._avg_version:
            img = self._avg_image()[0].permute(1, 2, 0)
            with host_wait("image"):
                img = img.detach().cpu()
            self._img_cache = np.clip(img.numpy(), 0.0, 1.0)
            self._img_cache_key = self._avg_version
        return self._img_cache

    def get_image_device(self):
        """The averaged iterate clamped to [0, 1] as a (1, H, W, 3) tensor on
        the device: a fresh tensor that the optimization never writes, so a
        saver thread can fetch it while the run goes on."""
        if self.average is None:
            return None
        return torch.clamp(self._avg_image(), 0.0, 1.0).permute(0, 2, 3, 1)

    def get_image(self, image_type: str = "pil"):
        if self.average is None:
            return None
        return tensor_to_image(self.get_image_tensor(), image_type)

    def loss_terms(self):
        """Per-term weighted losses of the current iterate (diagnostic;
        reference SumLoss(verbose=True) parity; under a mesh every rank
        calls it). Returns {name: float}."""
        if self.image is None or self._last_cfg is None:
            return None
        terms = build_loss_terms_fn(self._last_cfg, self._scale_mesh)
        with fp32_math(self.device), torch.no_grad():
            out = terms(self.image, self._step_params(), self._last_consts)
        return {k: float(v) for k, v in out.items()}

    def canvas(self, content_size, scale, align=None):
        """(w, h) optimization canvas for ``scale``; ``align`` > 1 rounds
        both dims to that multiple, 1 keeps the exact reference sizing, and
        None keeps it on one device and under a mesh snaps to
        shard-divisible dims (``utils/scales.shard_align_size``, the JAX
        engine's rule)."""
        cw, ch = size_to_fit(content_size, scale, scale_up=True)
        if align is not None and align > 1:
            return align_size((cw, ch), align)
        if align is None and self.mesh is not None:
            return shard_align_size((cw, ch), *self.mesh.grid)
        return (cw, ch)

    # ------------------------------------------------------------ internals

    @property
    def _is_rank0(self):
        return self.mesh is None or self.mesh.rank == 0

    def _shard(self, x):
        """This rank's slab of a whole-image tensor on the current canvas."""
        return shard_image(x, self._scale_mesh)

    def _whole(self, x):
        """The whole image of a tensor held on the current canvas, on every
        rank (a collective under a mesh). At a scale too small to shard every
        rank holds the whole image already, and rank 0's is taken, so the
        ranks leave the scale equal."""
        if self.mesh is None:
            return x
        if self._scale_mesh is None:
            return broadcast(x)
        return gather_image(x, self._scale_mesh)

    def _set_average(self, ema):
        """Sets the averaged iterate that ``get_image*`` read (at a scale's
        entry and each chunk's end), a new version of it, and publishes it:
        under a mesh every rank gathers its whole image (the callbacks run
        on rank 0 only and cannot call a collective)."""
        self.average = ema
        self._avg_version += 1
        if self.mesh is not None:
            self._whole_avg = self._whole(ema_get(ema))

    def _avg_image(self):
        return ema_get(self.average) if self.mesh is None else self._whole_avg

    def _step_params(self):
        """The params as the trunk consumes them: cast to ``compute_dtype``
        and the trunk's memory format once per engine, not once per step."""
        if self.compute_dtype is None:
            return self.params
        if self._params_cast is None:
            self._params_cast = cast_params(self.params, self.compute_dtype, self.mesh)
        return self._params_cast

    def _scale_remat(self, ch, cw, optimizer):
        """Whether the current scale (a ch x cw canvas) rematerialises the
        trunk, recorded in ``remat_scales``. Under a mesh the ranks agree
        (one all-reduce), so that they run the same segments."""
        predicted = None
        if self.remat is not None:
            remat = self.remat
        elif self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            remat = auto_remat(ch, cw, self.compute_dtype, total, self._scale_mesh,
                               optimizer)
            predicted = predicted_peak_bytes(ch, cw, self.compute_dtype, self._scale_mesh,
                                             optimizer) / 2**20
            if self.mesh is not None:
                flag = torch.tensor([float(remat)], device=self.device)
                remat = bool(all_reduce_(flag, self.mesh, op="max").item())
        else:
            remat = auto_remat(ch, cw)
        self.remat_scales.append({"w": cw, "h": ch, "remat": remat,
                                  "predicted_peak_mib": predicted})
        if remat:
            print(f"Rematerialising the trunk at {cw}x{ch}"
                  + ("" if predicted is None else
                     f" (predicted peak without: {predicted:.0f} MiB)"))
        return remat

    def _init_image(self, init, content_image, style_images, style_weights, hw):
        ch, cw = hw
        if init == "content":
            return _pil_to_nchw(content_image, (cw, ch), self.device)
        if init == "gray":
            x = self._rng.uniform(size=(1, ch, cw, 3)).astype(np.float32)
            return self._nhwc_to_device(x / 255.0 + 0.5)
        if init == "uniform":
            x = self._rng.uniform(size=(1, ch, cw, 3)).astype(np.float32)
            return self._nhwc_to_device(x)
        if init == "normal":
            return self._nhwc_to_device(
                _trunc_normal(self._rng, (1, ch, cw, 3), 0.5, 0.25))
        if init == "style_stats":
            mean = np.zeros(3, np.float64)
            var = np.zeros(3, np.float64)
            for img, w in zip(style_images, style_weights):
                arr = np.asarray(img.convert("RGB"), dtype=np.float64) / 255.0
                mean += arr.mean(axis=(0, 1)) * w
                var += arr.var(axis=(0, 1), ddof=1) * w
            chans = [
                _trunc_normal(self._rng, (1, ch, cw, 1), mean[c],
                              math.sqrt(max(var[c], 0.0)))
                for c in range(3)
            ]
            return self._nhwc_to_device(np.concatenate(chans, axis=-1))
        raise ValueError(
            "init must be one of 'content', 'gray', 'uniform', 'normal', 'style_stats'"
        )

    def _nhwc_to_device(self, arr):
        """Host (1, H, W, 3) array (the RandomState draw order) -> NCHW."""
        x = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
        return x.permute(0, 3, 1, 2).contiguous().to(self.device)

    def _capture_targets(self, content, style_images, style_weights, scale,
                         style_scale_fac, style_size, cfg):
        """The scale's targets (``step.capture_targets``, each stage a
        ``  targets:*`` span) from the style images sized for ``scale``.
        Under a mesh rank 0's style targets are taken, so that the ranks'
        losses agree bit for bit."""

        def styles():
            for img, weight in zip(style_images, style_weights):
                if style_size is None:
                    sw, sh = size_to_fit(img.size, round(scale * style_scale_fac))
                else:
                    sw, sh = size_to_fit(img.size, style_size)
                print(f"Processing style image ({sw}x{sh})...")
                yield _pil_to_nchw(img, (sw, sh), self.device), weight

        return capture_targets(
            cfg, self._step_params(), content, styles(), self._scale_mesh,
            spans=lambda name: span(f"  targets:{name}", self.device),
            share=None if self.mesh is None else _broadcast_target)

    # --------------------------------------------------------------- stylize

    def _load_resume(self, checkpoint, optimizer, scales, content_size, align):
        """Loads ``checkpoint`` for a resume, refusing (with the JAX
        package's messages) a state that this run cannot continue."""
        resume_state = load_checkpoint(checkpoint)
        ck_opt = resume_state.get("optimizer", "adam")
        if ck_opt != optimizer:
            raise ValueError(
                f"checkpoint {checkpoint!r} was written with optimizer "
                f"{ck_opt!r}; refusing to resume with {optimizer!r} "
                "(the trajectories are not compatible)"
            )
        start = resume_state["scale_index"]
        if start >= len(scales):
            raise ValueError(
                f"checkpoint scale index {start} is out of range "
                f"for the current pyramid of {len(scales)} scales — were "
                "--min-scale/--end-scale changed since the checkpoint?"
            )
        meta = resume_state.get("meta", {})
        exp_cw, exp_ch = self.canvas(content_size, scales[start], align)
        got = (meta.get("w"), meta.get("h"))
        if None not in got and got != (exp_cw, exp_ch):
            raise ValueError(
                f"checkpoint geometry {got[0]}x{got[1]} does not match the "
                f"recomputed canvas {exp_cw}x{exp_ch} at scale "
                f"{start + 1} — content image or "
                "--end-scale/--min-scale/--align changed since the "
                "checkpoint was written"
            )
        if meta.get("transposed", False):
            raise ValueError(
                "checkpoint was written with internal orientation "
                "transposed=True, which this package does not use — write "
                "it with --transpose-wide off to resume it here"
            )
        if "rng" in resume_state and "rng_keys" in resume_state:
            unpack_rng_state(self._rng, resume_state["rng"], resume_state["rng_keys"])
        print(
            f"Resuming from {checkpoint}: scale {start + 1}/"
            f"{len(scales)}, iteration {resume_state['done_iters']}"
        )
        return resume_state

    def _from_file(self, arr):
        """A checkpoint's array as a tensor on the device: an image-shaped
        one NCHW (this rank's slab of it under a mesh)."""
        if arr.ndim >= 4:
            return self._shard(_from_nhwc(arr, self.device))
        return torch.from_numpy(np.array(arr)).to(self.device)

    def _enter_scale(self, scale, content_image, style_images, style_weights, whole, *,
                     optimizer="adam", content_weight=0.015, tv_weight=2.0,
                     step_size=0.02, avg_decay=0.99, style_scale_fac=1.0,
                     style_size=None, align=None, carried=None, resume_state=None):
        """A scale's entry, with ``stylize``'s keywords: sets the scale's
        mesh, ``image`` (``whole`` resized and clamped, or the resume file's)
        and ``average``, and returns ((w, h), ``StepConfig``, targets, the
        runner's first state, runner). The optimizer state is the file's,
        ``carried`` carried into the scale, or new (``step.OPTIMIZERS``)."""
        spec = OPTIMIZERS[optimizer]
        with span(f"scale-entry@{scale}", self.device):
            cw, ch = self.canvas(content_image.size, scale, align)
            self._scale_mesh = None if self.mesh is None else self.mesh.on_canvas(ch, cw)
            content = self._shard(_pil_to_nchw(content_image, (cw, ch), self.device))
            if resume_state is None:
                self.image = self._shard(torch.clamp(_resize_image(whole, (ch, cw)), 0.0, 1.0))
                self._set_average(ema_init(self.image, avg_decay))
            else:
                self.image = self._shard(whole)
                self._set_average(EMAState(
                    value=self._from_file(resume_state["ema_value"]),
                    accum=self._from_file(resume_state["ema_accum"])))
            layers = len(self.content_layers)
            cfg = StepConfig(
                content_layers=tuple(self.content_layers), style_layers=tuple(self.style_layers),
                content_weights=(content_weight / layers,) * layers,
                style_layer_weights=tuple(self.style_layer_weights), tv_weight=tv_weight,
                style_loss=self.style_loss, content_loss=self.content_loss,
                w2_grad=self.w2_grad, pooling=self.pooling, step_size=step_size,
                avg_decay=avg_decay, compute_dtype=self.compute_dtype,
                remat=self._scale_remat(ch, cw, optimizer))

        print(f"Processing content image ({cw}x{ch})...")
        with span(f"targets@{scale}", self.device):
            consts = self._capture_targets(content, style_images, style_weights, scale,
                                           style_scale_fac, style_size, cfg)
        self._last_cfg, self._last_consts = cfg, consts

        with span(f"scale-entry@{scale}", self.device):
            if resume_state is not None:
                opt = spec.unpack(resume_state, self._from_file)
            elif carried is None:
                opt = spec.init(self.image)
            else:
                opt = _map_images(self._shard, spec.carry(carried, (ch, cw)))
            runner = spec.runner(cfg, self._scale_mesh)
            runner.label = f"@{scale}"
            # The runner copies the state into buffers of its own (and hands
            # those back) at its first call.
            state = LoopState(image=self.image, opt=opt, ema=self.average)
        return (cw, ch), cfg, consts, state, runner

    def stylize(
        self,
        content_image,
        style_images,
        *,
        style_weights=None,
        content_weight: float = 0.015,
        tv_weight: float = 2.0,
        optimizer: str = "adam",
        min_scale: int = 128,
        end_scale: int = 512,
        iterations: int = 500,
        initial_iterations: int = 1000,
        step_size: float = 0.02,
        avg_decay: float = 0.99,
        init: str = "content",
        style_scale_fac: float = 1.0,
        style_size: int = None,
        align: int = None,
        callback=None,
        checkpoint: str = None,
        checkpoint_every: int = 500,
        resume: bool = False,
    ):
        spec = OPTIMIZERS.get(optimizer)
        if spec is None:
            raise ValueError("optimizer must be one of " + ", ".join(map(repr, OPTIMIZERS)))
        job = dict(optimizer=optimizer, content_weight=content_weight, tv_weight=tv_weight,
                   step_size=step_size, avg_decay=avg_decay,
                   style_scale_fac=style_scale_fac, style_size=style_size, align=align)
        with fp32_math(self.device):
            # From the call to the first scale: the inputs, the initial image.
            with span("prologue", self.device):
                min_scale = min(min_scale, end_scale)
                if style_weights is None:
                    style_weights = [1 / len(style_images)] * len(style_images)
                else:
                    total = sum(abs(w) for w in style_weights)
                    style_weights = [w / total for w in style_weights]
                if len(style_images) != len(style_weights):
                    raise ValueError(
                        "style_images and style_weights must have the same length")

                scales = gen_scales(min_scale, end_scale)
                self.remat_scales = []
                resume_state = None
                start_scale_idx = 0
                if resume and checkpoint and Path(checkpoint).is_file():
                    resume_state = self._load_resume(
                        checkpoint, optimizer, scales, content_image.size, align)
                    start_scale_idx = resume_state["scale_index"]
                    whole = _from_nhwc(resume_state["image"], self.device)
                else:
                    cw, ch = self.canvas(content_image.size, scales[0], align)
                    whole = self._init_image(
                        init, content_image, style_images, style_weights, (ch, cw))

                # Checkpoints are written on a background thread, every
                # ``checkpoint_every`` iterations and at every scale end. The
                # runners write the state's tensors in place, so the snapshot
                # is a copy made on the device at submit: what the writer
                # fetches is the state of the snapshot's iteration even while
                # the next chunks run.
                checkpointing = checkpoint is not None and spec.checkpoint is not None
                if checkpoint is not None and not checkpointing:
                    written = " and ".join(k for k, v in OPTIMIZERS.items() if v.checkpoint)
                    print(
                        f"Warning: --checkpoint supports the {written} "
                        "optimizers; no checkpoints will be written for this "
                        f"{optimizer} run (its optax state is not serialized)."
                    )
            ckpt_writer = (AsyncCheckpointWriter() if checkpointing and self._is_rank0
                           else None)
            iters_since_ckpt = 0
            try:
                carried = None
                for scale_idx in range(start_scale_idx, len(scales)):
                    scale = scales[scale_idx]
                    resuming_here = (resume_state is not None
                                     and scale_idx == start_scale_idx)
                    (cw, ch), _, consts, state, runner = self._enter_scale(
                        scale, content_image, style_images, style_weights, whole,
                        carried=carried, resume_state=resume_state if resuming_here else None,
                        **job)
                    carried = None
                    actual_its = initial_iterations if scale == scales[0] else iterations

                    reset_peak_device_ram(self.device)
                    done = (min(resume_state["done_iters"], actual_its)
                            if resuming_here else 0)
                    t_prev = time.time()
                    first_chunk = True
                    while done < actual_its:
                        n = min(self.callback_chunk, actual_its - done)
                        # A chunk's phase ends in its host read, which waits
                        # for the chunk's device work.
                        with span(f"{'chunk1' if first_chunk else 'chunk'}@{scale}x{n}"):
                            state, losses_dev = runner(self._step_params(), consts, state, n)
                            with host_wait("losses"):
                                losses = losses_dev.cpu().numpy().astype(np.float64)
                        first_chunk = False
                        self.image = state.image
                        self._set_average(state.ema)
                        done += n
                        t_now = time.time()
                        # The snapshot goes to the writer BEFORE the
                        # callbacks, so an interrupt raised by a callback
                        # still leaves a resumable checkpoint (the finally
                        # below flushes the write in flight).
                        if checkpointing:
                            iters_since_ckpt += n
                            if iters_since_ckpt >= checkpoint_every or done >= actual_its:
                                with span(f"ckpt-snapshot@{scale}", self.device):
                                    self._submit_checkpoint(
                                        ckpt_writer, checkpoint, state, optimizer,
                                        scale_idx, done, (cw, ch, scale))
                                iters_since_ckpt = 0
                        stop = False
                        # No closing synchronize: the chunk's read left the
                        # device idle, and a preview's fetch is its own.
                        if callback is not None and self._is_rank0:
                            with span(f"callbacks@{scale}"):
                                ram = peak_device_ram(self.device)
                                try:
                                    for k in range(n):
                                        callback(STIterate(
                                            w=cw, h=ch, i=done - n + k + 1, i_max=actual_its,
                                            loss=float(losses[k]),
                                            time=t_prev + (t_now - t_prev) * (k + 1) / n,
                                            gpu_ram=ram,
                                        ))
                                except KeyboardInterrupt:
                                    if self.mesh is None:
                                        raise
                                    stop = True
                        t_prev = t_now
                        # Under a mesh the ranks stop together, after this
                        # chunk: rank 0's interrupted callback or any rank's
                        # Ctrl-C (the launcher's SIGINT flag) stops them all.
                        if self.mesh is not None:
                            with host_wait("stop-flag"):
                                stops = any_rank_stops(self.mesh, stop)
                            if stops:
                                raise KeyboardInterrupt

                    sections = runner.section_ms() if T.DEBUG_TIMING else None
                    if sections is not None:
                        print(f"[timing] sections@{scale} (ms, last replay): "
                              + ", ".join(f"{k} {v:.3f}" for k, v in sections.items()),
                              flush=True)
                    # Each new scale starts from the previous scale's averaged
                    # iterate (ref :495-497); an optimizer state that carries
                    # into the next scale (Adam's moments) is taken whole, to
                    # be resized. Then the runner, its graphs and the buffers
                    # no longer needed go.
                    with span(f"scale-exit@{scale}", self.device):
                        if spec.carry is not None:
                            carried = _map_images(self._whole, state.opt)
                        self.image = torch.clamp(ema_get(state.ema), 0.0, 1.0)
                        self.average = state.ema
                        whole = self._whole(self.image)
                        runner = state = None
            finally:
                if ckpt_writer is not None:
                    try:
                        ckpt_writer.close()
                    except Exception as err:
                        print(f"Warning: checkpoint write failed: {err}")
        with span("final-image"):
            return self.get_image()

    def _submit_checkpoint(self, writer, path, state, optimizer, scale_idx, done,
                           geometry):
        """Hands a copy of the chunk's state, made on the device in the
        checkpoint's channels-last layout, to the writer thread, which
        fetches it while the next chunks write the state in place. Under a
        mesh every rank gathers the whole state and rank 0, the only one
        with a writer, submits it."""
        whole = self._whole
        opt = _map_images(whole, state.opt)
        image, ema_value = whole(state.image), whole(state.ema.value)
        if writer is None:
            return

        def snap(x):
            if not isinstance(x, torch.Tensor):
                return x
            return _to_nhwc(x).contiguous() if x.ndim >= 4 else x.clone()

        opt = type(opt)(*map(snap, opt))
        if writer.error is not None:
            print(f"Warning: checkpoint write failed: {writer.error}")
            writer.error = None
        cw, ch, scale = geometry
        rng = np.random.RandomState()
        rng.set_state(self._rng.get_state())  # a copy: the live one may advance
        writer.submit(
            path,
            image=snap(image),
            ema=EMAState(value=snap(ema_value), accum=snap(state.ema.accum)),
            scale_index=scale_idx,
            done_iters=done,
            meta={"w": cw, "h": ch, "scale": scale, "transposed": False},
            optimizer=optimizer,
            rng=rng,
            **{OPTIMIZERS[optimizer].checkpoint: opt},
        )


def _map_images(fn, opt):
    """An optimizer state with ``fn`` applied to its image-shaped tensors
    (4-D or more: images, and histories of them), the rest as it is."""
    return type(opt)(*(fn(f) if isinstance(f, torch.Tensor) and f.ndim >= 4 else f
                       for f in opt))


def _broadcast_target(t):
    """Rank 0's style target (a ``W2Target`` or a Gram matrix) on every rank."""
    return type(t)(*map(broadcast, t)) if isinstance(t, tuple) else broadcast(t)


def tensor_to_image(arr, image_type: str = "pil"):
    """(H, W, 3) or (1, H, W, 3) [0,1] float array -> PIL / uint16 ndarray
    (reference get_image semantics, :335-347). A torch tensor is fetched
    from its device here, so a writer thread can call it."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.clip(np.asarray(arr), 0.0, 1.0)
    if arr.ndim == 4:
        arr = arr[0]
    if image_type.lower() == "pil":
        return Image.fromarray(np.uint8(np.round(arr * 255.0)))
    if image_type.lower() == "np_uint16":
        return np.uint16(np.round(arr * 65535.0))
    raise ValueError("image_type must be 'pil' or 'np_uint16'")


def _trunc_normal(rng, shape, mean, std, lo=0.0, hi=1.0):
    """Truncated normal in [lo, hi] via rejection (host-side init only)."""
    if std <= 0:
        return np.full(shape, np.clip(mean, lo, hi), np.float32)
    out = rng.normal(mean, std, size=shape)
    bad = (out < lo) | (out > hi)
    while bad.any():
        out[bad] = rng.normal(mean, std, size=int(bad.sum()))
        bad = (out < lo) | (out > hi)
    return out.astype(np.float32)
