"""Readings that the limits of ``correct`` are set from, over many seeds.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--modes program,lower,half_batch,altered,unchanged] [--others N] \\
        [--out FILE.jsonl]

For each seed the run's inputs are made and the reference run once; then
each mode's output is compared with it, by the numbers of
:mod:`benchmark.check`:

* ``program``: the program's set-up as a run of the cell makes it (its
  first steps, or its warm stylization), without the window;
* ``lower``: the controls, the reference put in the program's place with a
  stated precision one step lower (``reference/lowp.py``: the trunk in TF32
  below FP32 or fp8 below bf16, and the statistics' products in TF32,
  ``tf32_ns``), each read under its own name;
* ``half_batch``, ``altered``, ``unchanged``: a fault planted in the
  reference put in the program's place (``reference/model.py``).

The modes other than ``program`` run on the first ``--others`` seeds only.
Prints one JSON line per seed and mode, then one with each mode's largest
and smallest reading of each number and the limits that
:func:`propose_limits` sets from them. Needs a CUDA device, as a run does.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.reference.lowp import CONV, STATS  # noqa: E402

CONTROLS = CONV + STATS


def propose_limits(out):
    """{number: {"lower", "upper", "from", "limit"}} from ``readings``'
    output. The lower reading is the program's largest; the upper the
    smallest of: each control's (where that is 3 times the lower or more),
    each fault's (10 times), the unchanged state's (3 times). The limit lies
    between them at lower^0.3 * upper^0.7: more room above the lower than
    below the upper. None where no upper reading exists."""
    prog = out["program"]
    limits = {}
    for k in prog[0]:
        lower = max(r[k] for r in prog)
        ups = []
        for mode, rs in out.items():
            if mode == "program" or not rs:
                continue
            least = min(r[k] for r in rs)
            need = 3 if mode in CONTROLS or mode == "unchanged" else 10
            if least >= need * lower:
                ups.append((least, mode))
        if not ups or lower <= 0:
            limits[k] = {"lower": lower, "upper": min(ups)[0] if ups else None,
                         "from": min(ups)[1] if ups else None, "limit": None}
            continue
        upper, source = min(ups)
        limits[k] = {"lower": lower, "upper": upper, "from": source,
                     "limit": float(f"{lower ** 0.3 * upper ** 0.7:.2g}")}
    return limits


def readings(cell, seeds, modes, device, emit=print, others=None):
    """{mode: [numbers per seed]}; ``emit`` gets each line. The modes other
    than ``program`` run on the first ``others`` seeds only."""
    from benchmark import harness
    from benchmark.inputs import make_inputs
    from benchmark.reference.lowp import LOWER

    modes = [n for m in modes for n in (LOWER[cell.cfg["precision"]] if m == "lower" else (m,))]
    out = {m: [] for m in modes}
    for at, seed in enumerate(seeds):
        inputs = make_inputs(cell.cfg, cell.traffic, seed, device)
        produced = {}
        if "program" in modes:
            t0 = time.perf_counter()
            run, produced["program"] = harness.program_first_steps(cell, inputs, device)
            run = None
            harness._free(device)
            t_prog = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = harness.reference_first_steps(cell, inputs)
        t_ref = time.perf_counter() - t0
        for mode in modes:
            if mode != "program" and others is not None and at >= others:
                continue
            if mode != "program":
                produced[mode] = harness.reference_first_steps(cell, inputs, mode=mode)
            nums = harness.numbers(cell, produced[mode], ref)
            out[mode].append(nums)
            emit(json.dumps({"workload": cell.name, "seed": seed, "mode": mode,
                             "numbers": nums, "program_s": t_prog if mode == "program" else None,
                             "reference_s": t_ref}))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program,lower,half_batch,altered,unchanged")
    p.add_argument("--others", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    modes = args.modes.split(",")
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    out = readings(cell, seeds, modes, torch.device("cuda:0"), emit, args.others)
    summary = {m: {k: [min(r[k] for r in rs), max(r[k] for r in rs)] for k in rs[0]}
               for m, rs in out.items() if rs}
    limits = propose_limits(out) if out.get("program") else None
    emit(json.dumps({"workload": cell.name, "summary": summary, "limits": limits, "seeds": seeds,
                     "device": torch.cuda.get_device_name(0),
                     "power_limit_w": harness.power_limit(),
                     "seconds": time.perf_counter() - _T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
