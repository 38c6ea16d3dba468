#!/usr/bin/env python3
"""Peak device memory and ms/iter of the graphed step with the VGG trunk
rematerialised and without, through the step or through the engine.

    python3 tools/remat_memory_torch.py [sizes=2172x2896,1086x1448]
        [precisions=f32,bf16] [optimizers=adam] [remat=off,on] [iters=4]
        [eager=0] [engine=0]

For each size (HxW), precision, optimizer and remat setting:

* ``engine=0``: ``bench.build_step``'s (optimizer, trace) step at HxW runs
  on the runner the engine takes on the card (CUDA graph replays;
  ``eager=1``: the eager runner), a chunk of 2 iterations (the eager first
  one and the capture), then a timed chunk of ``iters``; ``remat`` is
  ``off`` or ``on``;
* ``engine=1``: ``StyleTransfer.stylize`` runs one scale of ``iters`` + 2
  iterations on a canvas of HxW (a seeded random content of that aspect,
  ``end_scale`` max(H, W), ``align`` 1; random weights), as a user's call
  would; ``remat`` is ``auto``, ``on`` or ``off`` (``remat=None``, True,
  False), and the record holds the engine's choice and predicted peak.

Both run under the engine's allocator settings
(``engine.use_expandable_segments``; printed). Each run prints one JSON
line: ms/iter of the timed iterations, the peak MiB allocated over the
whole run (capture included) and reserved, the peak bytes per pixel, the
last loss, whether the allocator held an expandable segment, and whether
PyTorch warned that cuDNN cannot take a convolution too large to split by
batch. A setting that runs out of device memory
prints ``"oom": true`` with PyTorch's message, and the next one runs.
Copied into an older tree's ``tools/``, it measures that tree's step with
``remat=off``. Prints the card's name, power limit and cuDNN version first.
Needs one GPU.
"""

import gc
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from style_transfer_tpu_torch.bench import build_step  # noqa: E402

LARGE_CONV_WARNING = "cuDNN cannot be used for large non-batch-splittable convolutions"
ENGINE_REMAT = {"auto": None, "on": True, "off": False}


def card():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _step_run(h, w, precision, optimizer, remat, iters, device, eager, out):
    # remat=off passes nothing, so that the script also measures a tree
    # from before remat (an old-against-new comparison).
    runner, params, consts, state = build_step(
        h, w, device=device, compute_dtype=precision, optimizer=optimizer, eager=eager,
        **({"remat": True} if remat == "on" else {}))
    state, _ = runner(params, consts, state, 2)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    state, losses = runner(params, consts, state, iters)
    loss = float(losses[-1])  # waits for the chunk
    out.update(ms_iter=(time.perf_counter() - t0) / iters * 1e3, loss=loss)


def _engine_run(h, w, precision, optimizer, remat, iters, device, out):
    from PIL import Image

    from style_transfer_tpu_torch import StyleTransfer
    from style_transfer_tpu_torch.models.weights import random_params

    rng = np.random.RandomState(0)
    content = Image.fromarray(rng.randint(0, 256, (max(h // 8, 1), max(w // 8, 1), 3),
                                          dtype=np.uint8))
    style = Image.fromarray(rng.randint(0, 256, (64, 64, 3), dtype=np.uint8))
    st = StyleTransfer(device=device, weights=random_params(0), compute_dtype=precision,
                       remat=ENGINE_REMAT[remat])
    its = []
    st.stylize(content, [style], optimizer=optimizer, min_scale=max(h, w),
               end_scale=max(h, w), initial_iterations=iters + 2, align=1,
               callback=its.append)
    (rec,) = st.remat_scales
    out.update(canvas=[rec["h"], rec["w"]], chose_remat=rec["remat"],
               predicted_peak_mib=rec["predicted_peak_mib"],
               ms_iter=(its[-1].time - its[1].time) / (len(its) - 2) * 1e3,
               loss=float(its[-1].loss))


def measure(h, w, precision="f32", optimizer="adam", remat="off", iters=4,
            device="cuda:0", eager=False, engine=False):
    """One run at h x w; returns its record (see the module docstring)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    out = {"h": h, "w": w, "precision": precision, "optimizer": optimizer, "remat": remat,
           "eager": eager, "engine": engine, "oom": False}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            if engine:
                _engine_run(h, w, precision, optimizer, remat, iters, device, out)
            else:
                _step_run(h, w, precision, optimizer, remat, iters, device, eager, out)
        except torch.OutOfMemoryError as err:
            out.update(oom=True, oom_message=str(err).split(" See documentation")[0])
    gc.collect()
    pixels = h * w if "canvas" not in out else out["canvas"][0] * out["canvas"][1]
    peak = torch.cuda.max_memory_allocated(device)
    out.update(peak_mib=peak / 2**20,
               peak_reserved_mib=torch.cuda.max_memory_reserved(device) / 2**20,
               bytes_per_px=peak / pixels,
               expandable_segments=any(seg.get("is_expandable", False)
                                       for seg in torch.cuda.memory_snapshot()),
               large_conv_warning=any(LARGE_CONV_WARNING in str(c.message) for c in caught))
    return out


def main(argv):
    kw = dict(a.split("=", 1) for a in argv)
    if not torch.cuda.is_available():
        print("remat_memory_torch.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = {k: os.environ[k] for k in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF")
           if k in os.environ}
    print(card(), f"cuDNN {torch.backends.cudnn.version()}, allocator environment {env} "
          "(none: the engine's expandable segments)", flush=True)
    sizes = [tuple(int(v) for v in s.split("x"))
             for s in kw.get("sizes", "2172x2896,1086x1448").split(",")]
    engine = kw.get("engine", "0") == "1"
    for h, w in sizes:
        for precision in kw.get("precisions", "f32,bf16").split(","):
            for optimizer in kw.get("optimizers", "adam").split(","):
                for remat in kw.get("remat", "off,on").split(","):
                    rec = measure(h, w, precision, optimizer, remat, int(kw.get("iters", 4)),
                                  eager=kw.get("eager", "0") == "1", engine=engine)
                    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
