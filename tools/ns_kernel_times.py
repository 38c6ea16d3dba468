#!/usr/bin/env python3
"""Device time of the port's Newton-Schulz kernels, without the host.

    python3 tools/ns_kernel_times.py [TREE]

Builds the kernels of the package tree TREE (default: this checkout) and,
at the W2 loss's group shapes (C = 64, 128, 256 with G = 1, C = 512 with
G = 2; rank-deficient inputs, 12 iterations), prints for B1
(``ns_sqrtm_yz``, each group launched alone), B2 (``ns_sqrtm``) and B3
(``lyap_bwd``) the device time per call summed over the call's kernels by
``torch.profiler`` (10 calls after 3 warm-up), their per-step sum, and
each kernel's error against its plain version; then B1 per step as the
main path launches it, the four groups in one grouped launch
(``ns_sqrtm_yz_groups``), beside the per-group kernels
(``ns_sqrtm_yz_serial``, one kernel chain a group). ``chip_smoke.py`` times
calls with CUDA events, which at small C include the wrapper's host time;
this script reads the card's own. Needs one CUDA device. Pointed at another
tree (a parent's export, or a copy with one change), it times that tree's
kernels, so two designs can be compared on one card in one call; a tree
without the grouped launch prints its B1 per step as the per-group sum.
"""

import sys
from pathlib import Path

TREE = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
SHAPES = [(1, 64), (1, 128), (1, 256), (2, 512)]
ITERS = 12


def main():
    sys.path.insert(0, str(TREE.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("ns_kernel_times.py: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from style_transfer_tpu_torch.ops.cuda import build
    from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K

    build.load()
    print(f"{torch.cuda.get_device_name(0)}; kernels of {TREE}")

    def rel(x, ref):
        return ((x - ref).abs().max() / ref.abs().max()).item()

    def device_us(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 10

    total, mats = {}, []
    for g, n in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn((g, n, n // 4), generator=gen, device="cuda")
        a = (x @ x.transpose(1, 2) / n + 1e-4 * torch.eye(n, device="cuda")).contiguous()
        mats.append(a)
        grad = torch.randn((g, n, n), generator=gen, device="cuda")
        y = K.ns_sqrtm_plain(a, ITERS)
        calls = {"ns_sqrtm_yz": lambda: K.ns_sqrtm_yz(a, ITERS),
                 "ns_sqrtm": lambda: K.ns_sqrtm(a, ITERS),
                 "lyap_bwd": lambda: K.lyap_bwd(y, grad, ITERS)}
        errs = (rel(K.ns_sqrtm_yz(a, ITERS)[1], K.ns_sqrtm_yz_plain(a, ITERS)[1]),
                rel(K.ns_sqrtm(a, ITERS), y),
                rel(K.lyap_bwd(y, grad, ITERS), K.lyap_bwd_plain(y, grad, ITERS)))
        out = []
        for name, fn in calls.items():
            us = device_us(fn)
            total[name] = total.get(name, 0.0) + us
            out.append(f"{name} {us:.1f} us")
        print(f"({g},{n},{n}): " + ", ".join(out)
              + "; err Z %.2e, Y %.2e, Q %.2e of max" % errs)
    print("per step: " + ", ".join(f"{k} {v:.1f} us" for k, v in total.items()))
    if hasattr(K, "ns_sqrtm_yz_groups"):
        grouped = device_us(lambda: K.ns_sqrtm_yz_groups(mats, ITERS))
        serial = [device_us(lambda a=a: K.ns_sqrtm_yz_serial(a, ITERS)) for a in mats]
        print(f"B1 per step, the four groups in one launch: {grouped:.1f} us; the "
              f"per-group kernels {[round(v, 1) for v in serial]}, sum {sum(serial):.1f} us")
    else:
        print(f"B1 per step, the per-group kernels: {total['ns_sqrtm_yz']:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
