"""Timed full-pyramid run of the PyTorch port (the reference's headline
workload) -> one JSON line.

Usage: python3 tools/bench_pyramid_torch.py [END_SCALE=2896] [--label L]
           [--out FILE.json] [--precision f32|bf16] [--device cuda:0]
           [--optimizer adam|lbfgs|lbfgs-zoom]

The port's counterpart of ``tools/bench_pyramid.py``: the same synthetic
content/style pair at the reference aspect (a 2896x2172 content and a
512x512 style from ``RandomState(0)``), ``random_params(0)``, ``seed(0)``
and the engine's default pyramid (min_scale 128, 1000 initial + 500
iterations a scale). Prints ONE JSON line on stdout:

  {"metric": "pyramid_wall", "value": <total s>, "unit": "s",
   "end_scale": N, "label": L, "iter_wall": s, "overhead_wall": s,
   "phases": {family: s}, "untimed": s, "captures": {scale: s},
   "device": name,
   "scales": {"WxH": {"wall": s, "iters": n, "ms_per_iter": m,
                      "peak_mib": MiB}, ...}}

``iter_wall`` sums each scale's iterating time, from its first to its last
``STIterate.time`` stamp (chunk-interpolated, so n - 1 intervals); the rest
of the wall is ``overhead_wall``. ``phases`` groups the engine's
``phase_totals`` by family (``targets@512`` and ``targets@2896`` both land
in ``targets``; the indented rows nest inside their phase and are skipped);
what no phase covers is ``untimed``. ``captures`` holds each scale's
indented ``  capture@S`` row: the host time of capturing and instantiating
its CUDA graphs of the step (one; three for ``lbfgs-zoom``), inside that
scale's first chunk (absent where the engine runs eagerly: on the CPU). A
non-default ``--optimizer`` suffixes the metric name (``_lbfgs``,
``_lbfgs_zoom``). ``peak_mib`` is the scale's peak
device memory (``STIterate.gpu_ram``; 0 on the CPU). Per-scale lines go to
stderr.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def run(end_scale, *, device="cuda:0", precision="f32", label="unlabeled",
        iterations=None, initial_iterations=None, optimizer="adam"):
    """Runs the pyramid to ``end_scale`` and returns the record (iteration
    counts default to the engine's)."""
    import torch

    from style_transfer_tpu_torch.engine import StyleTransfer, phase_totals
    from style_transfer_tpu_torch.models.weights import random_params

    rng = np.random.RandomState(0)
    content = Image.fromarray((rng.rand(2172, 2896, 3) * 255).astype(np.uint8))
    style = Image.fromarray((rng.rand(512, 512, 3) * 255).astype(np.uint8))

    st = StyleTransfer(device=device, weights=random_params(0), compute_dtype=precision)
    st.seed(0)
    its_kw = {k: v for k, v in (("iterations", iterations),
                                ("initial_iterations", initial_iterations))
              if v is not None}

    by_scale = {}

    def cb(it):
        by_scale.setdefault(f"{it.w}x{it.h}", []).append(it)

    phase_totals(reset=True)
    t0 = time.perf_counter()
    st.stylize(content, [style], end_scale=end_scale, callback=cb, optimizer=optimizer,
               **its_kw)
    total = time.perf_counter() - t0

    scales = {}
    for key, its in by_scale.items():
        wall = its[-1].time - its[0].time
        n = len(its)
        scales[key] = {
            "wall": round(wall, 2),
            "iters": n,
            "ms_per_iter": round(wall / max(n - 1, 1) * 1000, 2),
            "peak_mib": round(max(i.gpu_ram for i in its) / 2**20, 1),
        }

    phases, captures = {}, {}
    for name, secs in phase_totals().items():
        if name.startswith("  capture@"):
            captures[name.split("@")[1]] = round(secs, 3)
        if name.startswith(" "):
            continue
        fam = name.split("@")[0]
        phases[fam] = round(phases.get(fam, 0.0) + secs, 2)

    iter_wall = sum(s["wall"] for s in scales.values())
    for k, v in scales.items():
        print(f"scale {k}: {v['wall']:.1f}s ({v['iters']} iters, "
              f"{v['ms_per_iter']:.1f} ms/iter, peak {v['peak_mib']:.1f} MiB)",
              file=sys.stderr)
    print(f"TOTAL pyramid to {end_scale}: {total:.1f}s "
          f"(in-scale {iter_wall:.1f}s, overhead {total - iter_wall:.1f}s)",
          file=sys.stderr)
    ph = ", ".join(f"{k} {v:.1f}s" for k, v in sorted(phases.items(), key=lambda kv: -kv[1]))
    print(f"phases: {ph}; untimed {total - sum(phases.values()):.1f}s", file=sys.stderr)
    if captures:
        print("graph capture per scale (inside its first chunk): "
              + ", ".join(f"{k} {v:.3f}s" for k, v in captures.items()), file=sys.stderr)
    return {
        "metric": "pyramid_wall" + ("" if optimizer == "adam"
                                    else "_" + optimizer.replace("-", "_")),
        "value": round(total, 2),
        "unit": "s",
        "end_scale": end_scale,
        "label": label,
        "iter_wall": round(iter_wall, 2),
        "overhead_wall": round(total - iter_wall, 2),
        "phases": phases,
        "untimed": round(total - sum(phases.values()), 2),
        "captures": captures,
        "device": (torch.cuda.get_device_name(st.device) if st.device.type == "cuda"
                   else "cpu"),
        "scales": scales,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("end_scale", nargs="?", type=int, default=2896)
    p.add_argument("--label", default="unlabeled")
    p.add_argument("--out", default=None)
    p.add_argument("--precision", choices=("f32", "bf16"), default="f32")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--optimizer", choices=("adam", "lbfgs", "lbfgs-zoom"), default="adam")
    args = p.parse_args(argv)
    record = run(args.end_scale, device=args.device, precision=args.precision,
                 label=args.label, optimizer=args.optimizer)
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return record


if __name__ == "__main__":
    main()
