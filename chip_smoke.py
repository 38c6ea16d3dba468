#!/usr/bin/env python3
"""Smoke run of the PyTorch port (style_transfer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one Hopper card and nvcc. Phases,
each of which exits non-zero on failure:

1. setup: versions, the card's name and power limit, and the build of the
   CUDA kernels from the checkout's sources (timed);
2. kernel against plain version: the coupled Newton-Schulz kernel against its
   plain PyTorch version at the W2 loss's group shapes, a ragged shape and a
   rank-deficient case, on inputs formed as in the loss (C_t^½·C·C_t^½ from
   random features): tr(Y) to rtol 1e-4, Z to 1e-3 of max|Z|, the autograd
   gradient to 1e-3 of its max, and both versions timed with CUDA events;
3. card against CPU: the same 128 px, 10-iteration run on cuda and on cpu,
   losses to rtol 1e-3;
4. the main path through the CLI: a 640x480 content and a 512x512 style PNG
   through ``style_transfer_tpu_torch.cli.main`` over the pyramid
   128 -> 512 (5 scales, 20 iterations each), with finite decreasing losses,
   a 512x384 output, and exactly 4 groups x 100 iterations of kernel
   launches.

Everything runs in FP32 (TF32 off for matmuls and cuDNN). The weights are
the deterministic He-normal ``random_params(0)``. The last stdout line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
TAPS = {1: 64, 6: 128, 11: 256, 20: 512, 29: 512}
ITERS = 12
KERNEL_RTOL_TRACE = 1e-4
KERNEL_TOL_Z = 1e-3
CPU_RTOL = 1e-3


def _banner():
    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


def _build():
    from style_transfer_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.load()
    secs = time.perf_counter() - t0
    print(f"kernel build: {secs:.2f} s ({build.library_path().name})")
    log = build.library_path().with_suffix(".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    return secs


def _loss_inputs(device, g, c, hw, seed):
    """(g, c, c) inner matrices C_t^½·C·C_t^½ as the W2 loss forms them,
    from random post-ReLU features of ``hw`` pixels."""
    import torch

    from style_transfer_tpu_torch.ops import losses as L

    gen = torch.Generator(device=device).manual_seed(seed)

    def feats():
        x = torch.randn((g, c, *hw), generator=gen, device=device)
        return torch.relu(x) + 0.05 * x.abs()

    mean, srm = L.w2_moments(feats())
    tgt = L.w2_target(*L.w2_moments(feats()))
    return (tgt.cov_sqrt @ (L.moments_to_cov(mean, srm) @ tgt.cov_sqrt)).contiguous()


def _rank_deficient(device, n, rank, seed):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((1, n, rank), generator=gen, device=device)
    return (x @ x.transpose(1, 2) / n + 1e-4 * torch.eye(n, device=device)).contiguous()


def _time_pair(kern, plain, reps=25):
    """Median per-call milliseconds of each version from CUDA events, taken
    in turns (plain, kernel, kernel, plain) after a warm-up call of each."""
    import torch

    def one(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    kern()
    plain()
    samples = {kern: [], plain: []}
    for fn in (plain, kern, kern, plain):
        samples[fn] += [one(fn) for _ in range(reps)]
    return statistics.median(samples[kern]), statistics.median(samples[plain])


def _kernel_phase():
    import torch

    from style_transfer_tpu_torch.models.vgg import feature_shape
    from style_transfer_tpu_torch.ops import sqrtm as S
    from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K

    dev = torch.device("cuda", 0)
    cases = []
    for layer_c in sorted({c for c in TAPS.values()}):
        layers = [l for l, c in TAPS.items() if c == layer_c]
        h, w, _ = feature_shape(layers[0], 384, 512)  # the 512x384 canvas
        cases.append((f"({len(layers)},{layer_c},{layer_c})",
                      _loss_inputs(dev, len(layers), layer_c, (h, w), layer_c), True))
    cases.append(("(1,100,100) ragged", _loss_inputs(dev, 1, 100, (40, 40), 100), False))
    cases.append(("(1,512,512) rank 64 + 1e-4 I", _rank_deficient(dev, 512, 64, 7), False))

    max_abs_err, step_ms, step_plain_ms = 0.0, 0.0, 0.0
    for name, a, on_path in cases:
        y, z = K.ns_sqrtm_yz(a, ITERS)
        py, pz = K.ns_sqrtm_yz_plain(a, ITERS)
        torch.cuda.synchronize()
        tr, ptr = S._batch_trace(y), S._batch_trace(py)
        tr_err = ((tr - ptr).abs() / ptr.abs()).max().item()
        z_err = ((z - pz).abs().max() / pz.abs().max()).item()
        if not (torch.isfinite(y).all() and torch.isfinite(z).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        if tr_err > KERNEL_RTOL_TRACE or z_err > KERNEL_TOL_Z:
            raise AssertionError(f"{name}: tr(Y) rel err {tr_err:.3g} (limit "
                                 f"{KERNEL_RTOL_TRACE}), Z err {z_err:.3g} of max|Z| "
                                 f"(limit {KERNEL_TOL_Z})")
        # Gradient through TraceSqrtmNS against the plain autograd version.
        wts = torch.linspace(0.5, 1.5, a.shape[0], device=dev)
        ak = a.clone().requires_grad_(True)
        (gk,) = torch.autograd.grad((K.trace_sqrtm_ns(ak, ITERS) * wts).sum(), ak)
        ap = a.clone().requires_grad_(True)
        (gp,) = torch.autograd.grad((S.trace_sqrtm_ns(ap, ITERS) * wts).sum(), ap)
        torch.cuda.synchronize()
        g_err = ((gk - gp).abs().max() / gp.abs().max()).item()
        if g_err > KERNEL_TOL_Z:
            raise AssertionError(f"{name}: gradient err {g_err:.3g} of max (limit "
                                 f"{KERNEL_TOL_Z})")

        ms, plain_ms = _time_pair(lambda: K.ns_sqrtm_yz(a, ITERS),
                                  lambda: K.ns_sqrtm_yz_plain(a, ITERS))
        g_, c_ = a.shape[0], a.shape[-1]
        tflops = 3 * 2 * c_ ** 3 * ITERS * g_ / (ms * 1e-3) / 1e12
        print(f"kernel {name}: tr(Y) rel err {tr_err:.2e}, Z err {z_err:.2e} of "
              f"max|Z|, grad err {g_err:.2e}; kernel {ms:.4f} ms "
              f"({tflops:.2f} TFLOP/s FP32), plain {plain_ms:.4f} ms")
        if on_path:
            max_abs_err = max(max_abs_err, (y - py).abs().max().item(),
                              (z - pz).abs().max().item())
            step_ms += ms
            step_plain_ms += plain_ms
    print(f"kernel per step (the four groups): {step_ms:.4f} ms, plain "
          f"{step_plain_ms:.4f} ms")
    return max_abs_err, step_ms, step_plain_ms


def _images(tmp):
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(0)
    h, w = 480, 640
    yy, xx = np.mgrid[0:h, 0:w]
    content = np.stack([xx / w, yy / h, (xx + yy) / (h + w)], -1) * 200
    content += rng.uniform(0, 55, (h, w, 3))
    style = rng.randint(0, 255, (64, 64, 3)).astype(np.float64)
    style = np.kron(style, np.ones((8, 8, 1)))  # 512x512, blocky texture
    paths = tmp / "content.png", tmp / "style.png"
    Image.fromarray(content.astype(np.uint8)).save(paths[0])
    Image.fromarray(style.astype(np.uint8)).save(paths[1])
    return paths


def _card_vs_cpu_phase(content_path, style_path):
    import numpy as np
    from PIL import Image

    from style_transfer_tpu_torch import StyleTransfer
    from style_transfer_tpu_torch.models.weights import random_params

    params = random_params(0)
    losses = []
    for device in ("cuda:0", "cpu"):
        st = StyleTransfer(device=device, weights=params, callback_chunk=10)
        its = []
        with Image.open(content_path) as c, Image.open(style_path) as s:
            st.stylize(c.convert("RGB"), [s.convert("RGB")], min_scale=128,
                       end_scale=128, iterations=10, initial_iterations=10,
                       callback=its.append)
        losses.append(np.array([i.loss for i in its]))
    card, cpu = losses
    rel = np.abs(card - cpu) / np.abs(cpu)
    print(f"card vs cpu at 128 px, 10 iterations: max rel loss diff {rel.max():.2e} "
          f"(limit {CPU_RTOL}); first/last loss card {card[0]:.7g}/{card[-1]:.7g}, "
          f"cpu {cpu[0]:.7g}/{cpu[-1]:.7g}")
    if not rel.max() <= CPU_RTOL:
        raise AssertionError("card and cpu losses disagree")


def _cli_phase(tmp, content_path, style_path):
    import numpy as np
    from PIL import Image

    from style_transfer_tpu_torch import cli
    from style_transfer_tpu_torch.models.weights import random_params, save_params
    from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K

    weights = tmp / "vgg19_random0.npz"
    save_params(random_params(0), weights)
    out, trace = tmp / "out.png", tmp / "trace.json"
    argv = [str(content_path), str(style_path), "--devices", "cuda:0",
            "--end-scale", "512", "--min-scale", "128", "-i", "20", "-ii", "20",
            "-o", str(out), "--trace", str(trace), "--vgg-weights", str(weights)]
    K.ns_sqrtm_yz.launches = 0
    t0 = time.perf_counter()
    cli.main(argv)
    wall = time.perf_counter() - t0
    launches = K.ns_sqrtm_yz.launches

    its = json.loads(trace.read_text())["iterates"]
    by_scale = {}
    for it in its:
        by_scale.setdefault((it["w"], it["h"]), []).append(it)
    sizes = list(by_scale)
    print(f"CLI pyramid: {len(its)} iterations over scales {sizes} in {wall:.2f} s")
    for (w, h), s in by_scale.items():
        ms_iter = (s[-1]["time"] - s[0]["time"]) / (len(s) - 1) * 1e3
        peak = max(i["gpu_ram"] for i in s) / 2**20
        print(f"  {w}x{h}: {ms_iter:.2f} ms/iter, peak memory {peak:.1f} MiB, "
              f"loss {s[0]['loss']:.6g} -> {s[-1]['loss']:.6g}")
    if sizes != [(128, 96), (181, 136), (256, 192), (362, 272), (512, 384)]:
        raise AssertionError(f"unexpected pyramid {sizes}")
    if not all(len(s) == 20 for s in by_scale.values()):
        raise AssertionError("each scale should run 20 iterations")
    losses = np.array([i["loss"] for i in its])
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss")
    first = by_scale[sizes[0]]
    if not first[-1]["loss"] < first[0]["loss"]:
        raise AssertionError("the first scale's loss did not decrease")
    with Image.open(out) as img:
        if img.size != (512, 384):
            raise AssertionError(f"output is {img.size}, expected (512, 384)")
        arr = np.asarray(img.convert("RGB"))
        if arr.std() == 0:
            raise AssertionError("output image is constant")
    print(f"kernel launches over the CLI run: {launches} (expected 4 groups x 100 "
          "iterations = 400)")
    if launches != 400:
        raise AssertionError(f"kernel launched {launches} times, expected 400")
    return launches


def main():
    if not (REPO / "style_transfer_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: style_transfer_tpu_torch not found beside this "
              "script; run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke run needs the GPU",
              file=sys.stderr)
        return 1
    # Full FP32 for every matmul and cuDNN convolution (see engine.py).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = "setup"
    try:
        card = _banner()
        _build()
        phase = "kernel against plain version"
        max_abs_err, ms, plain_ms = _kernel_phase()
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            content_path, style_path = _images(tmp)
            phase = "card against CPU"
            _card_vs_cpu_phase(content_path, style_path)
            phase = "main path through the CLI"
            launches = _cli_phase(tmp, content_path, style_path)
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke.py: FAILED in phase: {phase}", file=sys.stderr)
        return 1
    sys.stdout.flush()
    print(card)
    print(json.dumps({"kernels": [{
        "name": "ns_sqrtm_yz",
        "route": "cuda",
        "source": "style_transfer_tpu_torch/csrc/ns_sqrtm.cu",
        "replaces": "style_transfer_tpu/ops/pallas/ns_sqrtm.py:73",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
