#!/usr/bin/env python3
"""What the checkpoint writer costs the loop at a print-size scale, with
its side-stream fetch and with a plain ``.cpu()`` fetch, in turns on one GPU.

    python3 tools/checkpoint_fetch_ab.py [TURNS]

Runs one 1448x1086 scale of ``chip_smoke.py``'s content through the CLI (30
iterations in chunks of 10, the main path) three ways: plain; with
``--checkpoint-every 10`` (the writer fetches on a side stream into pinned
memory); and the same with the fetch replaced by the writer thread's plain
``.cpu()``, which queues on the default stream. In turns plain, side, cpu,
cpu, side, plain, TURNS times (default 1); prints ms/iter over iterations
11-30 of each run and the writer thread's time per checkpoint. Needs one
CUDA device.
"""

import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main():
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("checkpoint_fetch_ab.py: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as C
    from style_transfer_tpu_torch.utils import checkpoint as ckmod

    turns = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    C._banner()
    big = ["--min-scale", str(C.BIG_SCALE), "--end-scale", str(C.BIG_SCALE), "-ii", "30",
           "--callback-chunk", "10"]
    ready_event = ckmod._ready_event
    results = {"plain": [], "side": [], "cpu": []}
    try:
        with C._timed_checkpoint_writes() as writes, tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            content, style = C._images(tmp)
            for way in ["plain", "side", "cpu", "cpu", "side", "plain"] * turns:
                # Without a ready event the writer takes save_checkpoint's
                # own fetch, a .cpu() per array.
                ckmod._ready_event = ready_event if way == "side" else (lambda state: None)
                flags = [] if way == "plain" else [
                    "--checkpoint", str(tmp / "ck.npz"), "--checkpoint-every", "10"]
                del writes[:]
                its, _, _ = C._run_cli(tmp, content, style, f"ab-{way}", big + flags)
                ms = (its[29]["time"] - its[9]["time"]) / 20 * 1e3
                results[way].append(ms)
                print(f"[{way}] {ms:.2f} ms/iter over iterations 11-30; writes "
                      + ", ".join(f"{s * 1e3:.1f} ms ({b / 2**20:.2f} MiB)"
                                  for _, _, s, b in writes))
    finally:
        ckmod._ready_event = ready_event
    for way, ms in results.items():
        print(f"{way}: " + ", ".join(f"{m:.2f}" for m in ms) + " ms/iter")
    return 0


if __name__ == "__main__":
    sys.exit(main())
