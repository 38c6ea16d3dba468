"""Rank programs that hold the sharded step against the one-device step.

:func:`run` builds a problem from a numpy seed (an image, a content image and
a style image, and the deterministic ``random_params(0)`` weights),
evaluates the loss and its gradient at the image, then takes ``steps``
iterations of the optimizer, either sharded over a mesh or on one device.
It returns what it computed as whole-image arrays, so the two runs can be
compared; :func:`run_ranks` is the same as a rank program for
``launch.launch``. :func:`stylize_ranks` runs the sharded engine, for
interrupts and resumes. They live in the package, not in the tests, so that
the processes the launcher starts import torch only.

A spec is a dict: ``hw`` (the canvas), and optionally ``seed`` (1),
``cfg`` (``StepConfig`` keyword arguments), ``steps`` (0), ``optimizer``
(a name of ``step.OPTIMIZERS``, 'adam') and ``init`` ('gray': the engine's gray init, drawn from
the image's numbers).
"""

from pathlib import Path

import numpy as np
import torch

from ..models.weights import params_from_jax, random_params
from ..step import (OPTIMIZERS, LoopState, StepConfig, build_loss_fn, build_loss_terms_fn,
                    capture_targets)
from ..utils.ema import ema_init
from .mesh import gather_image, shard_image

__all__ = ["problem", "run", "run_ranks", "stylize_ranks", "fail_on_rank"]

_PARAMS = {}  # device -> the weights, made once per process (about 1 s)


def _params(device):
    if device not in _PARAMS:
        _PARAMS[device] = params_from_jax(random_params(0), device)
    return _PARAMS[device]


def problem(spec):
    """(image, content, style) as (1, H, W, 3) float32 arrays from the
    spec's seed (style 64x64)."""
    rng = np.random.RandomState(spec.get("seed", 1))
    h, w = spec["hw"]
    image = rng.rand(1, h, w, 3).astype(np.float32)
    content = rng.rand(1, h, w, 3).astype(np.float32)
    style = rng.rand(1, 64, 64, 3).astype(np.float32)
    if spec.get("init") == "gray":
        image = (image / np.float32(255.0) + np.float32(0.5)).astype(np.float32)
    return image, content, style


def run(spec, mesh=None, device="cpu"):
    """The spec's evaluation and iterations, on this rank's slab when
    ``mesh`` is given (on ``device`` otherwise). Returns float32 arrays:
    ``loss`` (at the image), ``terms`` (``build_loss_terms_fn``'s weighted
    terms in name order), ``grad`` (whole, NCHW) and, with steps,
    ``losses`` and the final ``image`` (whole, NCHW)."""
    device = torch.device(device) if mesh is None else mesh.device
    cfg = StepConfig(**spec.get("cfg", {}))
    params = _params(device)
    image, content, style = (
        torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(device)
        for a in problem(spec))
    m = None if mesh is None else mesh.on_canvas(*spec["hw"])
    x0 = shard_image(image, m)
    consts = capture_targets(cfg, params, shard_image(content, m), [(style, 1.0)], m)

    x = x0.clone().requires_grad_(True)
    loss = build_loss_fn(cfg, m)(x, params, consts)
    (g,) = torch.autograd.grad(loss, x)
    with torch.no_grad():
        terms = build_loss_terms_fn(cfg, m)(x0, params, consts)
    out = {"loss": loss.detach(), "grad": gather_image(g, m),
           "terms": torch.stack([terms[k] for k in sorted(terms)])}
    steps = spec.get("steps", 0)
    if steps:
        optimizer = OPTIMIZERS[spec.get("optimizer", "adam")]
        state = LoopState(image=x0, opt=optimizer.init(x0), ema=ema_init(x0, cfg.avg_decay))
        state, losses = optimizer.runner(cfg, m)(params, consts, state, steps)
        out["losses"] = losses
        out["image"] = gather_image(state.image, m)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def run_ranks(mesh, specs, out_dir):
    """Rank program: :func:`run` of each spec, saved by every rank as
    ``spec{i}_rank{r}.npz`` in ``out_dir``."""
    for i, spec in enumerate(specs):
        np.savez(Path(out_dir) / f"spec{i}_rank{mesh.rank}.npz", **run(spec, mesh))


def _stylize_images():
    """A 128x96 gradient content and an 80x80 random style image (the
    tests' conftest images)."""
    from PIL import Image

    yy, xx = np.mgrid[0:96, 0:128]
    content = np.stack([xx / 128 * 255, yy / 96 * 255, (xx + yy) / 224 * 255], -1)
    style = np.random.RandomState(7).randint(0, 255, (80, 80, 3))
    return Image.fromarray(content.astype(np.uint8)), Image.fromarray(style.astype(np.uint8))


def stylize_ranks(mesh, runs, out_dir):
    """Rank program: one sharded ``StyleTransfer(callback_chunk=5)`` runs
    ``stylize`` once per entry of ``runs`` (its keyword arguments; a path
    ``checkpoint`` is taken inside ``out_dir``), in turn. With ``stop_at``
    = (scale index, iteration), rank 0's callback raises
    ``KeyboardInterrupt`` at that iteration, as a user's Ctrl-C in the
    one-device CLI does. Each rank saves ``run{j}_rank{r}.npz``: whether
    ``stylize`` raised ``KeyboardInterrupt`` (``stopped``), the EMA's
    bias-correction count and whole-image shape where it stopped (equal on
    ranks that stopped after the same chunk), and on rank 0 the iterates'
    (w, h, i) and losses."""
    import torch.distributed as dist

    from ..engine import StyleTransfer

    content, style = _stylize_images()
    st = StyleTransfer(mesh=mesh, weights=random_params(0), callback_chunk=5)
    for j, kw in enumerate(runs):
        kw = dict(kw)
        stop_at = kw.pop("stop_at", None)
        if kw.get("checkpoint"):
            kw["checkpoint"] = str(Path(out_dir) / kw["checkpoint"])
        its = []

        def callback(it):
            its.append(it)
            scale = len({(i.w, i.h) for i in its}) - 1
            if (scale, it.i) == stop_at:
                raise KeyboardInterrupt

        stopped = False
        try:
            st.stylize(content, [style], callback=callback if mesh.rank == 0 else None, **kw)
        except KeyboardInterrupt:
            stopped = True
        # Rank 0's checkpoint is on disk once its stylize has returned; the
        # next run's ranks each read it.
        dist.barrier()
        np.savez(Path(out_dir) / f"run{j}_rank{mesh.rank}.npz", stopped=stopped,
                 accum=st.average.accum.cpu().numpy(),
                 hw=np.array(st.get_image_tensor().shape),
                 its=np.array([(i.w, i.h, i.i) for i in its]).reshape(-1, 3),
                 losses=np.array([i.loss for i in its]))


def fail_on_rank(mesh, rank):
    """Rank program: rank ``rank`` raises while the others wait for it in
    a collective."""
    import torch.distributed as dist

    if mesh.rank == rank:
        raise RuntimeError(f"rank {rank} failed on purpose")
    dist.barrier()
