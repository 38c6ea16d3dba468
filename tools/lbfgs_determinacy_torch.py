"""How far the reference L-BFGS trajectory is determined, graph and eager.

Usage: python3 tools/lbfgs_determinacy_torch.py [device=cuda:0] [seeds=6]
    [iters=10] [sizes=96x128,384x512]

For each init (``uniform``: ``bench.build_step``'s random image; ``gray``:
the engine's gray init, 0.5 plus that draw over 255), each size (HxW) and
each seed, (lbfgs, lyap) in FP32 runs ``iters`` iterations three times from
the same state: once by the runner the engine takes on ``device`` (on the
card, replays of a CUDA graph of the step) and twice by the eager runner.
It prints, per init and size, the largest relative loss difference of each
seed, graph against eager and eager against eager. Under cuDNN's default
algorithms two eager runs differ in rounding, and the L-BFGS trajectory
magnifies it where its first, tiny step makes the first curvature pair
(ROADMAP C); the second column says how far that goes without any graph.

``measure()`` returns ``{(init, (h, w)): (graph_vs_eager, eager_vs_eager)}``,
each a list over the seeds.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from style_transfer_tpu_torch.bench import build_step  # noqa: E402
from style_transfer_tpu_torch.step import (  # noqa: E402
    LoopState,
    lbfgs_init,
    make_lbfgs_runner,
)
from style_transfer_tpu_torch.utils.ema import ema_init  # noqa: E402


def gray_start(state):
    """``state`` with its image moved to the engine's gray init (0.5 plus
    the image's uniform draw over 255) and fresh L-BFGS and EMA states."""
    image = state.image / 255.0 + 0.5
    return LoopState(image=image, opt=lbfgs_init(image), ema=ema_init(image, 0.99))


def _rel(a, b):
    return float((np.abs(a - b) / np.abs(b)).max())


def measure(device="cuda:0", seeds=6, iters=10, sizes=((96, 128), (384, 512))):
    out = {}
    for init in ("uniform", "gray"):
        for h, w in sizes:
            ge, ee = [], []
            for seed in range(seeds):
                runner, params, consts, state = build_step(
                    h, w, device=device, optimizer="lbfgs", w2_grad="lyap",
                    compute_dtype="f32", seed=seed)
                if init == "gray":
                    state = gray_start(state)
                eager = make_lbfgs_runner(runner.cfg, eager=True)
                runs = []
                for run in (runner, eager, eager):
                    _, losses = run(params, consts, state, iters)
                    runs.append(losses.cpu().numpy().astype(np.float64))
                ge.append(_rel(runs[0], runs[1]))
                ee.append(_rel(runs[2], runs[1]))
            out[(init, (h, w))] = (ge, ee)
            print(f"{init} {w}x{h}, seeds 0-{seeds - 1}, iterations 1-{iters}: max rel loss "
                  "diff graph against eager " + " ".join(f"{x:.1e}" for x in ge)
                  + "; eager against eager " + " ".join(f"{x:.1e}" for x in ee), flush=True)
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
    measure(device, int(kw.get("seeds", 6)), int(kw.get("iters", 10)), sizes)


if __name__ == "__main__":
    main(sys.argv[1:])
