#!/usr/bin/env python3
"""Peak device memory of each VGG-19 conv's forward and backward at the
slab shapes of a 2-rank (2x1) sharded run, beside the whole image's.

    python3 tools/conv_slab_memory.py [H W]      # default 136 181

For each conv up to layer 28 and each rank's slab (``parallel/mesh.py``'s
bounds), three layouts are run in FP32 (TF32 off) with cuDNN's default
algorithm choice: the whole image with ``padding=1`` (one device), the slab
padded by its halo and the zero border with ``padding=0`` (the sharded
trunk), and the slab padded in rows only with ``padding=(0, 1)``. Prints
the peak memory above the inputs of one forward plus backward, in MiB
(cuDNN's workspace included). Needs one GPU.
"""

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from style_transfer_tpu_torch.models.weights import (  # noqa: E402
    CONV_CHANNELS, CONV_INDICES, POOL_INDICES)
from style_transfer_tpu_torch.parallel.mesh import Mesh, slab_bounds  # noqa: E402


def _peak_mib(shape, weight, padding):
    x = torch.randn(shape, device=weight.device, requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    F.conv2d(x, weight, padding=padding).sum().backward()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def main(h=136, w=181):
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), f"canvas {h}x{w}, 2 ranks (2x1)")
    for rank in range(2):
        mesh = Mesh(grid=(2, 1), rank=rank, device=torch.device("cuda:0"))
        (r0, r1), _ = slab_bounds(h, w, mesh)
        for i in (c for c in CONV_INDICES if c <= 28):
            k = sum(1 for p in POOL_INDICES if p < i)
            cin, cout = CONV_CHANNELS[i]
            hs, ws = (r1 >> k) - (r0 >> k), w >> k
            weight = torch.randn(cout, cin, 3, 3, device="cuda:0", requires_grad=True)
            one = _peak_mib((1, cin, h >> k, ws), weight, 1)
            halo = _peak_mib((1, cin, hs + 2, ws + 2), weight, 0)
            rows = _peak_mib((1, cin, hs + 2, ws), weight, (0, 1))
            print(f"rank {rank} conv {i} ({cin}->{cout}, slab {hs}x{ws}): peak MiB "
                  f"one device {one:.1f}, halo-padded {halo:.1f}, rows only {rows:.1f}",
                  flush=True)


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))
