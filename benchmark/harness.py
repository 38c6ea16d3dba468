"""One run of one cell: set-up, the measured window, the traced stretch,
the check.

The cell's configuration, traffic and limits are files found by the names
in ``BENCHMARK.json``, and what depends on the configuration's optimizer
or loss is a file found by that name (:mod:`benchmark.plugin`). The
traffic's ``kind`` picks the window:

* ``step``: the runner of the configuration's optimizer at one scale
  (``runners/<optimizer>.py``; for Adam ``step.make_adam_runner`` with the
  engine's ``StepConfig``, graph replays on the card), from the state that
  ``StyleTransfer.stylize`` would start the scale with. Set-up builds the
  scale's entry from the engine's pieces and runs the first three
  iterations (the first eager, the second captured into the CUDA graph);
  the window goes on from there in chunks of ``chunk`` iterations, each
  ended by the host read of its losses, as ``stylize`` does. Chunks start
  while the next one, at the last one's time, still ends within the
  window; there is always one.
* ``pyramid``: whole ``StyleTransfer.stylize`` calls over the traffic's
  scales, back to back, started by the same rule. Set-up runs one
  ``stylize`` at ``warm_iterations`` a scale, which the check compares.

``--trace 1`` runs the same window, then profiles ``trace_chunks`` more
chunks or ``trace_images`` more images, recording the device alone; the
per-layer metrics read that stretch and the window's own numbers. A second
stretch records the host's calls too, for the breakdown's idle gaps: the
same again, or in a pyramid cell a shorter stylization where the traffic
names one (``trace_host_iterations``).

The pyramid cells drive ``StyleTransfer.stylize``, the program's public
entry. A step cell needs one scale's runner, which the program has no entry
for: it takes the engine's own internals (``StyleTransfer.canvas``,
``_scale_remat``, ``_capture_targets``, ``_init_image``, ``_step_params``,
``_pil_to_nchw``, ``_resize_image``) and the step module's runner, state
and ``StepConfig``, and so follows them as they change. The reference runs
once the window is closed, the peak memory read and the program's state
freed.
"""

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import check, counts, plugin
from .inputs import make_inputs, program_weights

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "style_transfer_tpu")

__all__ = ["Cell", "load_cell", "run_cell", "forbidden_modules", "program_first_steps",
           "reference_first_steps", "numbers"]


class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, spec, name):
        cell = next(w for w in spec["workloads"] if w["name"] == name)
        conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
        self.name, self.chips = name, cell["chips"]
        self.cfg = json.loads((ROOT / conf["file"]).read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
        self.limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]
        self.kind = self.traffic["kind"]


def load_cell(name):
    return Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), name)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ------------------------------------------------------------------ program


def _program():
    import style_transfer_tpu_torch.engine as engine
    import style_transfer_tpu_torch.step as step
    import style_transfer_tpu_torch.utils.ema as ema

    return engine, step, ema


# What the program fixes: a configuration states these for the reference,
# and they have to be what the program runs. Every other setting is handed
# to the program.
_ENGINE_FIXED = ("content_layers", "style_layers", "style_layer_weights")
_STEP_FIXED = ("w2_eps", "sqrtm_iters", "beta1", "beta2", "adam_eps")


def _check_fixed(cfg, st, step):
    """Raises where the configuration states a setting the program fixes
    otherwise: the file holds what runs."""
    d = step.StepConfig()
    runs = {k: tuple(getattr(st, k)) for k in _ENGINE_FIXED}
    runs.update({k: getattr(d, k) for k in _STEP_FIXED})
    for key, have in runs.items():
        if key not in cfg:
            continue
        want = cfg[key]
        if key == "style_layer_weights":
            sw = np.abs(np.asarray(want, np.float64))
            same = np.allclose(sw / sw.sum(), have, rtol=1e-12, atol=0)
        else:
            same = (tuple(want) if isinstance(want, list) else want) == have
        if not same:
            raise ValueError(f"configuration {key}={want!r}, the program runs {have!r}")


def _engine(cfg, traffic, inputs, device):
    engine, step, _ = _program()
    st = engine.StyleTransfer(
        device, pooling=cfg["pooling"], weights=program_weights(inputs["weights"]),
        style_loss=cfg["style_loss"], content_loss=cfg["content_loss"],
        w2_grad=cfg["w2_grad"], compute_dtype=cfg["precision"],
        callback_chunk=traffic["chunk"])
    _check_fixed(cfg, st, step)
    return st


def _stylize_kw(cfg, traffic, iterations=None):
    return dict(content_weight=cfg["content_weight"], tv_weight=cfg["tv_weight"],
                optimizer=cfg["optimizer"], min_scale=traffic["min_scale"],
                end_scale=traffic["end_scale"], step_size=cfg["step_size"],
                avg_decay=cfg["avg_decay"], init=cfg["init"],
                iterations=iterations or traffic["iterations"],
                initial_iterations=iterations or traffic["initial_iterations"])


class StepRun:
    """A step cell's program: the runner of the configuration's optimizer
    at one scale (``runners/<optimizer>.py``), with the targets, image and
    state that ``StyleTransfer.stylize`` would start that scale with. The
    scale's entry is built as ``stylize`` builds it, from the engine's own
    pieces (its canvas, remat rule, targets and initial image)."""

    def __init__(self, cfg, traffic, inputs, device):
        import torch

        engine, step, ema = _program()
        self.torch, self.engine, self.device = torch, engine, torch.device(device)
        self.opt = plugin.load("runners", cfg["optimizer"])
        st = _engine(cfg, traffic, inputs, device)
        scale, content_img, style_img = traffic["scale"], inputs["content"], inputs["style"]
        cw, ch = st.canvas(content_img.size, scale)
        layers = len(st.content_layers)
        self.cfg = step.StepConfig(
            content_layers=tuple(st.content_layers), style_layers=tuple(st.style_layers),
            content_weights=(cfg["content_weight"] / layers,) * layers,
            style_layer_weights=tuple(st.style_layer_weights), tv_weight=cfg["tv_weight"],
            style_loss=st.style_loss, content_loss=st.content_loss, w2_grad=st.w2_grad,
            pooling=st.pooling, step_size=cfg["step_size"], avg_decay=cfg["avg_decay"],
            compute_dtype=st.compute_dtype,
            remat=st._scale_remat(ch, cw, cfg["optimizer"]))
        with engine.fp32_math(self.device):
            content = engine._pil_to_nchw(content_img, (cw, ch), self.device)
            self.consts = st._capture_targets(content, [style_img], [1.0], scale, 1.0, None,
                                              self.cfg)
            whole = st._init_image(cfg["init"], content_img, [style_img], [1.0], (ch, cw))
            image = torch.clamp(engine._resize_image(whole, (ch, cw)), 0.0, 1.0)
        self.params = st._step_params()
        self.x0 = image
        self.state = step.LoopState(image=image, opt=self.opt.init(step, image),
                                    ema=ema.ema_init(image, self.cfg.avg_decay))
        self.runner = self.opt.runner(step, self.cfg)

    def run(self, n):
        """``n`` iterations; returns their losses, still on the device."""
        with self.engine.fp32_math(self.device):
            self.state, losses = self.runner(self.params, self.consts, self.state, n)
        return losses

    def first_steps(self, steps):
        """The first ``steps`` iterations: their losses, the first gradient
        as the optimizer's state holds it after one step, and the image's
        change over the steps, fetched to the host in float64."""
        first = self.run(1)
        grad1 = self.opt.first_grad(self.cfg, self.state.opt).cpu()
        rest = self.run(steps - 1)
        change = (self.state.image.double() - self.x0.double()).cpu()
        losses = self.torch.cat([first, rest]).cpu().numpy().astype(np.float64)
        return {"losses": list(losses), "grad1": grad1, "change": change}


class PyramidRun:
    """A pyramid cell's program: one engine, and its warm stylization."""

    def __init__(self, cfg, traffic, inputs, device):
        self.cfg, self.traffic, self.inputs = cfg, traffic, inputs
        self.st = _engine(cfg, traffic, inputs, device)
        self.nonfinite = 0

    def stylize(self, iterations=None, record=None):
        def callback(it):
            if not math.isfinite(it.loss):
                self.nonfinite += 1
            if record is not None:
                record.append(it.loss)

        self.st.stylize(self.inputs["content"], [self.inputs["style"]], callback=callback,
                        **_stylize_kw(self.cfg, self.traffic, iterations))

    def first_steps(self, iterations):
        losses = []
        self.stylize(iterations, losses)
        return {"losses": losses, "image": np.array(self.st.get_image_tensor(), np.float64)}


def program_first_steps(cell, inputs, device):
    """The program's set-up up to the window: (its run, what it produced)."""
    t = cell.traffic
    if cell.kind == "step":
        run = StepRun(cell.cfg, t, inputs, device)
        _reset_peak(run.device)
        return run, run.first_steps(t["first_steps"])
    run = PyramidRun(cell.cfg, t, inputs, device)
    return run, run.first_steps(t["warm_iterations"])


def reference_first_steps(cell, inputs, mode=None):
    from . import reference

    t = cell.traffic
    if cell.kind == "step":
        return reference.first_steps(cell.cfg, t, inputs, steps=t["first_steps"], mode=mode)
    return reference.pyramid(cell.cfg, t, inputs, t["warm_iterations"], mode=mode)


def numbers(cell, produced, ref):
    return (check.step_numbers if cell.kind == "step" else check.pyramid_numbers)(produced, ref)


# ------------------------------------------------------------------ device


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def power_limit():
    """The card's power limit in W by ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


# ------------------------------------------------------------------ windows


def _each(kind, times):
    """One line on standard error: the window's first, median and last
    chunk or image."""
    print(f"[benchmark] {len(times)} {kind}: first {times[0]:.4f} s, median "
          f"{float(np.median(times)):.4f} s, last {times[-1]:.4f} s", file=sys.stderr, flush=True)


def _step_window(run, chunk, seconds):
    """Chunks back to back; returns (start, seconds, chunks, non-finite
    losses)."""
    bad, times = 0, []
    _sync(run.device)
    t0 = now = time.perf_counter()
    while True:
        c0 = now
        losses = run.run(chunk).cpu().numpy()  # the chunk's host read
        bad += int((~np.isfinite(losses)).sum())
        now = time.perf_counter()
        times.append(now - c0)
        if now - t0 + (now - c0) > seconds:
            _each("chunks", times)
            return t0, now - t0, len(times), bad


def _pyramid_window(run, seconds):
    """Whole stylizations back to back; returns (start, seconds, images,
    images with a non-finite loss)."""
    failed, times = 0, []
    t0 = now = time.perf_counter()
    while True:
        i0, before = now, run.nonfinite
        run.stylize()
        failed += run.nonfinite > before
        now = time.perf_counter()
        times.append(now - i0)
        if now - t0 + (now - i0) > seconds:
            _each("images", times)
            return t0, now - t0, len(times), failed


def _traced(device, body, host=False):
    """Runs ``body`` under the profiler; returns the stretch's Trace. On the
    card it records the device's activity alone, unless ``host``: the
    profiler's record of every host call slows the host, and an idle share
    read from that stretch would count the profiler's own time."""
    import torch

    from .metrics._kernels import read_profile

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts = [torch.profiler.ProfilerActivity.CUDA] + (acts if host else [])
    with torch.profiler.profile(activities=acts) as prof:
        _sync(device)
        t0 = time.perf_counter()
        body()
        _sync(device)
        window = time.perf_counter() - t0
    return read_profile(prof, window)


def _reader(name):
    return plugin.load("metrics", name).read


def _log(stage, t0):
    """One line on standard error: a stage's seconds."""
    print(f"[benchmark] {stage}: {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    return time.perf_counter()


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ a run


def run_cell(cell, seed, seconds, trace, device="cuda:0", t_start=None):
    """Runs the cell once and returns the result line's dict, whose last
    key, ``compared``, holds each number compared beside its limit."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cfg, t = cell.cfg, cell.traffic
    inputs = make_inputs(cfg, t, seed, device)
    run, produced = program_first_steps(cell, inputs, device)
    t_log = _log("set-up", t_start)
    ctx = {"kind": cell.kind, "cfg": cfg, "traffic": t, "trace": None, "phases": None}
    if cell.kind == "step":
        start, window, chunks, failed = _step_window(run, t["chunk"], seconds)
        attempted = chunks * t["chunk"]
        ctx["ms_per_iter"] = 1e3 * window / attempted
        e2e = {"ms_per_iter": ctx["ms_per_iter"]}
    else:
        from style_transfer_tpu_torch.engine import phase_totals

        _sync(device)
        _reset_peak(device)
        phase_totals(reset=True)
        start, window, attempted, failed = _pyramid_window(run, seconds)
        ctx.update(phases=phase_totals(), images=attempted, image_s=window / attempted)
        e2e = {"image_s": ctx["image_s"]}
    e2e["setup_s"] = start - t_start
    t_log = _log(f"window ({attempted} {'iterations' if cell.kind == 'step' else 'images'})", t_log)
    peak = _peak(device)
    e2e["peak_mib"] = peak / 2**20
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name,
           "count": 1, "memory_peak_bytes": peak}
    limit_w = power_limit() if device.type == "cuda" else None
    if limit_w is not None:
        dev["power_limit_w"] = limit_w
    stretch = None
    if trace:
        if cell.kind == "step":
            n = t["trace_chunks"]

            def body():
                for _ in range(n):
                    run.run(t["chunk"]).cpu()
            ctx["traced_iterations"] = n * t["chunk"]
        else:
            n = t["trace_images"]

            def body():
                for _ in range(n):
                    run.stylize()
            ctx["traced_iterations"] = n * sum(k for _, _, k in counts.scale_canvases(t))
        stretch = ctx["trace"] = _traced(device, body)
        dev.update(busy_s=stretch.busy_s(), window_s=stretch.window_s)
        t_log = _log(f"traced stretch ({len(stretch.ops)} device operations)", t_log)
        print(f"[benchmark] device seconds by bucket: {json.dumps(stretch.by_bucket())}",
              file=sys.stderr, flush=True)
        # A stretch with the host's calls, for what the host did in the
        # device's idle gaps: the same again, or in a pyramid cell one
        # stylization at ``trace_host_iterations`` a scale (reading a whole
        # image's host and device events takes a minute and more).
        if cell.kind == "pyramid" and t.get("trace_host_iterations"):
            def body():
                run.stylize(t["trace_host_iterations"])
        hosted = _traced(device, body, host=True)
        ctx["idle_gaps"] = hosted.idle_gaps()
        t_log = _log(f"traced stretch with the host ({hosted.window_s:.3f} s)", t_log)
        hosted = None
    metrics, breakdown = {}, None
    if trace and device.type == "cuda":  # a CPU run reads no device metric
        ctx.update(_work(cell, name))
        for m in cell.per_layer:
            value = _reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    if trace:
        breakdown = {"device_ops": [[n, s] for n, s in ctx["trace"].top_ops()],
                     "idle_gaps": [[n, s] for n, s in ctx["idle_gaps"]]}
    # The trace's millions of host objects would slow the reference's
    # Python: it goes first.
    run = ctx = stretch = None
    _free(device)
    ref = reference_first_steps(cell, inputs)
    compared, correct = check.judge(numbers(cell, produced, ref), cell.limits)
    t_log = _log("reference and check", t_log)
    result = {"correct": bool(correct and failed == 0), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


def _work(cell, device_name):
    """The work counts and peaks the readers take."""
    cfg, t = cell.cfg, cell.traffic
    p = counts.peaks(device_name)
    out = {"peak": counts.peak_flops(cfg, device_name)}
    if "sqrtm_iters" in cfg:  # a Newton-Schulz chain runs
        out["ns_least_s"] = counts.ns_least_s(cfg, p["tf32_dense"], p["hbm_bytes_per_s"])
    if cell.kind == "step":
        w, h = counts.size_to_fit(t["content"], t["scale"], scale_up=True)
        out["flops_per_iter"] = counts.step_flops(cfg, h, w)
        out["trunk_least_s"] = counts.trunk_least_s(cfg, h, w, out["peak"], p["hbm_bytes_per_s"])
    else:
        out["flops_per_image"] = sum(k * counts.step_flops(cfg, h, w)
                                     for w, h, k in counts.scale_canvases(t))
    return out
