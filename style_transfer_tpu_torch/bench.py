"""Benchmark: Adam iterations per second at 512 px, the reference's headline
unit of work (one VGG-19 forward and image-gradient backward, the W2 style
loss through the Newton-Schulz kernels, content MSE and TV, Adam, clamp,
EMA).

    python3 -m style_transfer_tpu_torch.bench [--device cuda:0] [--size 512]
        [--chunk 50] [--timed-chunks 4] [--precision f32|bf16]
        [--w2-grad trace|lyap]

The port's counterpart of the JAX package's ``bench.py``: one warm-up chunk,
then ``--timed-chunks`` chunks ended by one host read of the losses, which
must be finite. Prints ONE JSON line:

  {"metric": "adam_iters_per_sec_512px", "value": N, "unit": "it/s",
   "vs_baseline": N, "device": "<torch.cuda.get_device_name>"}

A non-default ``--precision`` or ``--w2-grad`` suffixes the metric name
(``_bf16``, ``_lyap``). ``vs_baseline`` is it/s over 26.7, the reference's
published RTX 3090 pyramid time expressed as 512x512 iterations per second
(derived in the JAX package's ``bench.py``). ``build_step`` makes the step
and its inputs as the JAX package's ``__graft_entry__._build`` does.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from .engine import _resolve_compute_dtype, use_expandable_segments
from .models.vgg import cast_params, fp32_math
from .models.weights import params_from_jax, random_params
from .parallel.checks import problem
from .step import OPTIMIZERS, LoopState, StepConfig, capture_targets
from .utils.ema import ema_init

__all__ = ["BASELINE_512_ITS", "build_step", "main"]

BASELINE_512_ITS = 26.7  # RTX 3090 equivalent (the JAX package's bench.py)


def build_step(h, w, *, device="cuda:0", w2_grad="trace", compute_dtype="auto",
               optimizer="adam", seed=0, eager=False, remat=False, **cfg_kw):
    """The step at (h, w) and its inputs, as ``__graft_entry__._build``
    makes them: a ``RandomState(seed)`` image and content of (h, w) and a
    64x64 style (``parallel.checks.problem``), ``random_params(0)``, the
    targets (``step.capture_targets``), the initial state of
    ``step.OPTIMIZERS[optimizer]`` and an EMA of decay 0.99.
    ``remat`` and ``cfg_kw`` go to ``StepConfig`` (``remat=True``
    rematerialises the trunk). The runner runs with TF32 off, as
    ``stylize`` does, and is the one the engine takes on ``device``: on the
    card, Adam and L-BFGS replay a CUDA graph of the step (``eager=True``
    runs the same body eagerly, for a comparison), under the engine's
    allocator settings (``engine.use_expandable_segments``).

    Returns ``(runner, params, consts, state)``; ``runner(params, consts,
    state, n)`` runs n iterations and returns ``(state, losses)``, writing
    its own buffers (it never writes the ``state`` given); ``runner.run`` is
    the step's runner (its ``capture_seconds``) and ``runner.cfg`` its
    ``StepConfig``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but CUDA is not available")
        use_expandable_segments()
    spec = OPTIMIZERS[optimizer]
    cfg = StepConfig(w2_grad=w2_grad, compute_dtype=_resolve_compute_dtype(compute_dtype),
                     remat=remat, **cfg_kw)
    params = params_from_jax(random_params(0), device)
    if cfg.compute_dtype is not None:
        params = cast_params(params, cfg.compute_dtype)
    image, content, style = (torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(device)
                             for a in problem({"hw": (h, w), "seed": seed}))

    with fp32_math(device):
        consts = capture_targets(cfg, params, content, [(style, 1.0)])
    state = LoopState(image=image, opt=spec.init(image), ema=ema_init(image, 0.99))
    run = spec.runner(cfg, eager=eager)

    def runner(params, consts, state, n_steps):
        with fp32_math(device):
            return run(params, consts, state, n_steps)

    runner.run, runner.cfg = run, cfg
    return runner, params, consts, state


def _parser():
    p = argparse.ArgumentParser(
        prog="python3 -m style_transfer_tpu_torch.bench",
        description="Adam iterations per second of the step at SIZE x SIZE.")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--timed-chunks", type=int, default=4)
    p.add_argument("--precision", choices=("f32", "bf16"), default="f32")
    p.add_argument("--w2-grad", choices=("trace", "lyap"), default="trace")
    return p


def main(argv=None):
    """Runs the bench, prints its JSON line and returns the record."""
    args = _parser().parse_args(argv)
    runner, params, consts, state = build_step(
        args.size, args.size, device=args.device, w2_grad=args.w2_grad,
        compute_dtype=args.precision)
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"bench device: {args.device} ({name})", file=sys.stderr)

    state, losses = runner(params, consts, state, args.chunk)  # warm-up
    losses.cpu()
    t0 = time.perf_counter()
    for _ in range(args.timed_chunks):
        state, losses = runner(params, consts, state, args.chunk)
    losses = losses.cpu().numpy()  # the one host read waits for every chunk
    dt = time.perf_counter() - t0

    iters = args.timed_chunks * args.chunk
    its_per_sec = iters / dt
    if not np.isfinite(losses).all():
        raise RuntimeError("non-finite loss in benchmark")
    print(f"{iters} iters in {dt:.3f}s -> {its_per_sec:.2f} it/s @ {args.size}px "
          f"(final loss {losses[-1]:.4f})", file=sys.stderr)
    metric = f"adam_iters_per_sec_{args.size}px"
    metric += "_bf16" if args.precision == "bf16" else ""
    metric += "_lyap" if args.w2_grad == "lyap" else ""
    record = {
        "metric": metric,
        "value": round(its_per_sec, 2),
        "unit": "it/s",
        "vs_baseline": round(its_per_sec / BASELINE_512_ITS, 3),
        "device": name,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
