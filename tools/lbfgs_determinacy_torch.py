"""How far an L-BFGS trajectory is determined, graph and eager.

Usage: python3 tools/lbfgs_determinacy_torch.py [device=cuda:0] [seeds=6]
    [iters=10] [sizes=96x128,384x512] [optimizer=lbfgs] [w2_grad=lyap]
    [inits=uniform,gray] [eager_runs=2]

For each init (``uniform``: ``bench.build_step``'s random image; ``gray``:
the engine's gray init, 0.5 plus that draw over 255), each size (HxW) and
each seed, ``optimizer`` (``lbfgs`` or ``lbfgs-zoom``) with ``w2_grad`` in
FP32 runs ``iters`` iterations from the same state once by the runner the
engine takes on ``device`` (on the card, replays of CUDA graphs) and
``eager_runs`` times by the eager runner. It prints, per init and size,
the largest relative loss difference of each seed, graph against the first
eager run and eager against eager (the largest pair), and the same two
per iteration, the largest over the seeds. Under cuDNN's default
algorithms two eager runs differ in rounding, and the L-BFGS trajectory
magnifies it, for the reference L-BFGS where its first, tiny step makes
the first curvature pair (ROADMAP C); the eager column says how far that
goes without any graph, and the per-iteration rows for how many
iterations the trajectory stays determined.

``measure()`` returns ``{(init, (h, w)): (graph_vs_eager, eager_vs_eager)}``,
each a list over the seeds.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from style_transfer_tpu_torch.bench import build_step  # noqa: E402
from style_transfer_tpu_torch.step import OPTIMIZERS, LoopState  # noqa: E402
from style_transfer_tpu_torch.utils.ema import ema_init  # noqa: E402


def gray_start(state, optimizer="lbfgs"):
    """``state`` with its image moved to the engine's gray init (0.5 plus
    the image's uniform draw over 255) and fresh EMA and optimizer states
    (``lbfgs`` or ``lbfgs-zoom``)."""
    image = state.image / 255.0 + 0.5
    return LoopState(image=image, opt=OPTIMIZERS[optimizer].init(image),
                     ema=ema_init(image, 0.99))


def _rel(a, b):
    return np.abs(a - b) / np.abs(b)


def measure(device="cuda:0", seeds=6, iters=10, sizes=((96, 128), (384, 512)),
            optimizer="lbfgs", w2_grad="lyap", inits=("uniform", "gray"), eager_runs=2):
    make = OPTIMIZERS[optimizer].runner
    out = {}
    for init in inits:
        for h, w in sizes:
            ge, ee, ge_it, ee_it = [], [], np.zeros(iters), np.zeros(iters)
            for seed in range(seeds):
                runner, params, consts, state = build_step(
                    h, w, device=device, optimizer=optimizer, w2_grad=w2_grad,
                    compute_dtype="f32", seed=seed)
                if init == "gray":
                    state = gray_start(state, optimizer)
                eager = make(runner.cfg, eager=True)
                runs = []
                for run in (runner,) + (eager,) * eager_runs:
                    _, losses = run(params, consts, state, iters)
                    runs.append(losses.cpu().numpy().astype(np.float64))
                g = _rel(runs[0], runs[1])
                e = np.max([_rel(a, b) for i, b in enumerate(runs[1:])
                            for a in runs[i + 2:]], axis=0)
                ge.append(float(g.max()))
                ee.append(float(e.max()))
                ge_it, ee_it = np.maximum(ge_it, g), np.maximum(ee_it, e)
            out[(init, (h, w))] = (ge, ee)
            print(f"{optimizer} {w2_grad} {init} {w}x{h}, seeds 0-{seeds - 1}, iterations "
                  f"1-{iters}: max rel loss diff graph against eager "
                  + " ".join(f"{x:.1e}" for x in ge)
                  + f"; eager against eager ({eager_runs} runs) "
                  + " ".join(f"{x:.1e}" for x in ee), flush=True)
            for name, it in (("graph against eager", ge_it), ("eager against eager", ee_it)):
                print(f"  per iteration, largest over the seeds, {name}: "
                      + " ".join(f"{x:.1e}" for x in it), flush=True)
    return out


def main(argv):
    kw = dict(a.split("=", 1) for a in argv)
    device = kw.get("device", "cuda:0")
    if device.startswith("cuda"):
        print(torch.cuda.get_device_name(torch.device(device)))
    sizes = tuple(tuple(int(v) for v in s.split("x"))
                  for s in kw.get("sizes", "96x128,384x512").split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    measure(device, int(kw.get("seeds", 6)), int(kw.get("iters", 10)), sizes,
            kw.get("optimizer", "lbfgs"), kw.get("w2_grad", "lyap"),
            tuple(kw.get("inits", "uniform,gray").split(",")), int(kw.get("eager_runs", 2)))


if __name__ == "__main__":
    main(sys.argv[1:])
