#!/usr/bin/env python3
"""Smoke run of the PyTorch port (style_transfer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one Hopper card and nvcc. Phases,
each of which exits non-zero on failure:

1. setup: versions, the card's name and power limit, and the build of the
   CUDA kernels from the checkout's sources (timed);
2. kernels against plain versions, at the W2 loss's group shapes, ragged
   shapes on both sides of the regime boundary (C=100, 200, 300) and a
   rank-deficient case, on inputs formed as in the loss (C_t^½·C·C_t^½ from
   random features), each kernel and its plain version timed with CUDA
   events beside the kernel's bound (the larger of 3x its FP32 FLOP over the
   TF32 tensor-core peak, the 3xTF32 route, and its bytes over the memory
   rate; the FP32-FMA bound of earlier reports is printed beside it);
   single-pass TF32's error on the plain chain is printed, not checked;
   and each kernel captured alone into a CUDA graph and replayed must equal
   its eager launch bit for bit at every shape (C = 64, 100, 128, 200, 256,
   300, 512: both regimes):
   - the coupled NS kernel (B1): tr(Y) to rtol 1e-4, Z to 1e-3 of max|Z|,
     the trace autograd gradient to 1e-3 of its max; then its grouped
     launch at the main path's four groups at once (the one B1 launch a
     loss evaluation) with the same checks, the C = 512 group bit for bit
     against the per-group kernels, its graph replay bit for bit, and its
     device time beside the four groups' launched one at a time;
   - the NS forward kernel (B2): Y to 1e-4 of max|Y|;
   - the Lyapunov backward kernel (B3), on the plain NS square root of the
     input with the loss's own gradient -(2w/C)·I and with a random one: Q
     to 1e-3 of max|Q|; the ``SqrtmNSLyap`` autograd gradient against the
     plain ``sqrtm_ns_lyap`` gradient to 1e-3 of its max;
   then the zoom line search's step kernel (``csrc/zoom_ls.cu``, not the
   port of a TPU kernel) against its plain version, bit for bit on every
   field of the state and on ``go`` (NaN as NaN), step by step over the
   searches of ``tests/fixtures/zoom_ls_searches.json`` (the toys of
   ``tests/test_torch_zoom.py``, a NaN value, an infinite slope, the step
   limit at 3 and at 20), a zero-width interval, a cubic with a negative
   radical and 400 random states (seed 0, with NaN and inf); its time per
   call against the plain version's, and once from a graph;
3. card against CPU: the same 128 px, 10-iteration run on cuda and on cpu
   for (adam, trace), (adam, lyap), (lbfgs, lyap) and (lbfgs-zoom, trace),
   losses to rtol 1e-3 (lbfgs-zoom from iteration 6: 5e-3, see
   ``ZOOM_CPU_RTOL``), and for lbfgs-zoom (graph replays on the card, eager
   on the CPU) the same line-search evaluations in every iteration on both
   devices, read from the runners' records (``_Runner.linesearch_steps``);
4. the main path through the CLI: a 640x480 content and a 512x512 style PNG
   through ``style_transfer_tpu_torch.cli.main`` over the pyramid
   128 -> 512 (5 scales, 20 iterations each), with finite decreasing losses,
   a 512x384 output, and exactly 100 B1 launches (one grouped launch a loss
   evaluation for the four W2 groups);
5. the reference-flavour path through the CLI: the same pyramid with
   ``--w2-grad lyap``, under Adam and under ``--optimizer lbfgs``, each with
   the checks of phase 4 and exactly 400 launches each of B2 and B3 and none
   of B1;
6. steady state of the step at 512x384 for (adam, trace), (adam, lyap),
   (lbfgs, lyap) and (lbfgs-zoom, trace) with the FP32 trunk, (lbfgs-zoom,
   trace) once more by the eager runner, and (adam, trace), (adam, lyap)
   with the bf16 trunk, each step made by
   ``style_transfer_tpu_torch.bench.build_step``: ms/iter (and loss
   evaluations per iteration for lbfgs-zoom), peak memory, and from
   ``tools/profile_step_torch.py`` the device's busy share, the NS kernels'
   time per iteration and the costliest kernels;
7. checkpoint/resume through the CLI: phases 4 and 5's pyramids once more
   (the spread of two runs under cuDNN's default algorithm choice, printed);
   then, under cuDNN's deterministic algorithms, each pyramid
   uninterrupted, with ``--checkpoint --checkpoint-every 10`` interrupted
   by a KeyboardInterrupt from the callback at iteration 10 of the third
   scale, and ``--resume``d to the end: the resumed losses equal the
   uninterrupted run's from the resume point on to rtol 1e-5 (bit-identity
   printed), the output its image within 1/255, and the kernels launch for
   the 50 resumed iterations only; the checkpoint's size and the writer
   thread's write time, its device fetch included; then, with cuDNN's
   default again, one 1448x1086 scale, plain, with ``--checkpoint-every
   10`` and with ``--save-every 10``, ms/iter of each;
8. the web preview: phase 4's pyramid with ``--web`` on 127.0.0.1 and a
   standard-library client that reads ``/``, the WebSocket events (at least
   one STIterate of the running canvas, then WIDone) and ``/image`` (a JPEG
   of the canvas with the ICC profile);
9. ``--precision bf16``: the bf16 trunk's taps within 5e-2 of the FP32 ones
   at 512x384, and the CLI pyramid in bf16 with phase 4's checks (100 B1
   launches), its output's PSNR against phase 4's FP32 output;
10. the lbfgs-zoom path through the CLI (graph replays): phase 4's
    pyramid with ``--optimizer lbfgs-zoom``, phase 4's checks, B1 launched
    once per loss evaluation (at least 100, equal to the iterations and the
    line searches' evaluations, from the runners' records), the
    line-search kernel once per trial, B2 and B3 never; launches / 100
    printed as the evaluations per iteration;
11. fidelity on the card: the committed fingerprint fixture
    (``tests/fixtures/vgg19_random_he0_fingerprint.json``, made by the JAX
    package's CPU trunk) reproduced by the card's FP32 trunk; LPIPS (alex
    and vgg16, random bundles) on the card against the CPU to rtol 1e-4;
    PSNR, SSIM and the VGG-distance proxy (on the card) of phase 9's bf16
    output against phase 4's FP32 output;
12. the sharded path (``parallel/``): ranks that share the one card under
    gloo, started by the CLI's ``--devices cuda:0 cuda:0`` (this checks
    function, not scaling: the ranks share one H100, and NCCL refuses two
    ranks on one device). The backend, world size and grid are printed,
    and each rank's kernel launches, peak memory and time in the halo
    exchanges and all-reduces come from the ``ranks`` entry of the trace:
    - phase 4's pyramid on 2 ranks (2x1): per-scale losses against phase
      4's to rtol 1e-3, exactly 100 B1 launches on each rank, the gathered
      output's PSNR against phase 4's printed;
    - one 1448x1086 scale (``--align 1``, phase 7's canvas), 30 iterations
      on 2 ranks: ms/iter beside phase 7's plain run, per-rank peak memory,
      halo and all-reduce ms per iteration, losses against phase 7's plain
      run to rtol 1e-3;
    - 4 ranks (2x2) at 512x384, 20 iterations, against the one-device run
      to rtol 1e-3;
    - (lbfgs, lyap) over 128 -> 256 from the gray init on 2 ranks, 10
      iterations a scale: B2 and B3 launches on each rank equal to the
      one-device run's (120 each), losses to rtol 1e-3;
    - the stop: phase 4's pyramid on 2 ranks as a subprocess in its own
      session, checkpoints every 10 iterations, SIGINT to its process group
      once the third scale's first checkpoint exists (a terminal's Ctrl-C):
      exit 0 within 60 s with the output and the trace (with ``ranks``),
      stopped after a chunk before the end; ``--resume`` on 2 ranks to the
      end, its losses against the first leg's to rtol 1e-3 and B1 launched
      once per resumed iteration on each rank;
13. BASELINE.json config #5 at print size, ``random_params(0)``, FP32: the
    CLI pyramid 128 -> 2896x2172 (ten scales, 10 iterations each, chunks
    of 5) with ``--web`` (phase 8's client reads at least one event of the
    2896 scale, then the JPEG) and ``-o out.tif``: finite losses, a
    2896x2172 16-bit TIFF with the sRGB profile (the file equals the
    port's own encoding of its pixels), 100 B1 launches; ms/iter of the
    2048 and 2896 scales over their last 5 iterations, peak memory per
    scale, the 2896 scale's entry time. Then the 2896 scale alone (10
    iterations): FP32, bf16 (``--precision bf16``) and on 2 ranks sharing
    the card (``--align 1``, losses against the FP32 one-device run to
    rtol 1e-3, 10 B1 launches on each rank), ms/iter and peak memory of
    each (per rank, with halo and all-reduce ms/iter, for the 2 ranks);
14. BASELINE.json configs #3 and #4: card against CPU (phase 3's harness,
    128 px, 10 iterations, rtol 1e-3) for average pooling, L2 pooling with
    the scaled content loss, the Gram loss from the ``style_stats`` init,
    and three styles weighted [2, -1, 1] with content weight 0.15 and TV
    weight 20; then phase 4's pyramid and checks through the CLI with
    ``--pooling average``, ``--pooling l2 --content-loss scaled``,
    ``--style-loss gram --init style_stats --style-scale-fac 0.7 --align
    8`` (the aligned canvases, and no NS launch: Gram takes no square
    root), ``--style-size 256``, and the three styles with
    ``--style-weights 2 -1 1 --content-weight 0.15 --tv-weight 20``; 100
    B1 launches on each W2 leg. The weighted blend is one W2 target (the
    blended moments), so its loss is still a distance and falls as phase
    4's does;
15. the measurement tools on the card: ``tools/bench_pyramid_torch.py``'s
    ``run`` of the pyramid 128 -> 512 at the engine's iteration counts
    (1000 + 4 x 500), with each scale's iterations, its phases plus
    ``untimed`` equal to its wall within 0.05 s, 0 <= ``overhead_wall`` <
    the wall, and 1 B1 launch per iteration; ``style_transfer_tpu_torch.
    bench`` at 512x512 for (trace, f32), (trace, bf16) and (lyap, f32),
    each printing its JSON line; ``tools/profile_step_torch.py``'s
    ``profile`` at 512x384, its buckets summing to its device kernel time
    within 1%;
16. graph against eager: (adam, trace), (adam, lyap), (lbfgs, lyap) and
    (lbfgs-zoom, trace) in FP32 and (adam, trace) in bf16, at 128x96,
    512x384 and 1448x1086, and (lbfgs-zoom, lyap) at 512x384, each step
    made by ``bench.build_step`` and run 20 iterations (a chunk of 5, then
    a timed chunk of 15) by the graph runner and by the eager runner
    (``eager=True``, twice) from the same state (for both L-BFGS the gray
    init, as in phase 3): under cuDNN's default algorithms the losses
    within rtol 1e-3 (for the reference L-BFGS over its first 10
    iterations, ``LBFGS_DETERMINED``, for lbfgs-zoom over its first 7,
    ``ZOOM_DETERMINED``; every difference printed beside the two eager
    runs' own), then under its deterministic algorithms (graphs captured
    under them) losses, final image and, for lbfgs-zoom, the line-search
    evaluations of every iteration bit-identical; ms/iter of each, the graph runner's busy share
    (``profile_step_torch.profile_runner``), its capture and instantiate
    time, peak memory of each and kernel launches per iteration (equal; for
    lbfgs-zoom B1 once per evaluation and the line-search kernel once per
    trial in each run); for (lbfgs-zoom, trace) also the ms/iter of a graph
    runner whose trial graph holds the plain line-search step in place of
    its kernel;
17. remat on the card (``--remat``, ``StepConfig.remat``): (a)
    ``bench.build_step``'s (adam, trace) step with and without remat as
    graph replays, 20 iterations, at 512x384 (losses and image bit for bit
    under cuDNN's deterministic algorithms, within rtol 1e-3 under its
    default ones) and 1448x1086 (within 1e-3), ms/iter and peak memory of
    each; (b) phase 13's one-scale 2896x2172 legs, FP32 and bf16, with
    ``--remat on``: peak memory below phase 13's legs (which ``--remat
    auto`` ran without remat, as their traces must say), losses within rtol
    1e-3 of theirs, 10 B1 launches each, ms/iter of each; (c)
    ``tools/large_conv_probe_torch.py`` at 8192x6144 (conv1_2's
    convolution, ReLU and max pooling on a 64-channel canvas past 2^31
    elements, against the same ops on its halves) must pass; then at
    8192x6144 (50.3 Mpx; relu1_1 about 3.2e9 elements) ``--remat off`` (a
    subprocess) must end in CUDA's out-of-memory error, and ``--remat auto``
    must choose remat and run 3 iterations to finite losses, 3 B1
    launches: its peak memory, ms/iter,
    the predicted peak without remat, and whether PyTorch warned that cuDNN
    refused a convolution. The phase's seconds are printed.

On the card the engine, ``bench.build_step`` and the tools run every
optimizer as graph replays (``step._Runner``): Adam and the reference
L-BFGS one CUDA graph of the step per scale, lbfgs-zoom three (the
iteration's head, one trial replayed while the search's device flag says
so, the tail); the sharded runs stay eager. A kernel launch inside a graph
counts once per replay, so every launch check above counts the iterations
(and trials) that ran, as with the eager runner.

Everything but phase 9, the bf16 rows of phase 6, the bf16 output of
phase 11, the bf16 legs of phases 13 and 17 and the bf16 bench of phase 15
runs in FP32 (TF32 off for matmuls and cuDNN). The weights are the
deterministic He-normal ``random_params(0)``. The last stdout line is ``{"ok": true, "device":
{...}}``; the line before it lists the kernels, the one before that the
card's name and power limit.
"""

import contextlib
import json
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
TAPS = {1: 64, 6: 128, 11: 256, 20: 512, 29: 512}
ITERS = 12
LAYER_WEIGHTS = {1: 256 / 341, 6: 64 / 341, 11: 16 / 341, 20: 4 / 341, 29: 1 / 341}
KERNEL_RTOL_TRACE = 1e-4
KERNEL_TOL_Z = 1e-3
KERNEL_TOL_Y = 1e-4
KERNEL_TOL_Q = 1e-3
CPU_RTOL = 1e-3
# The zoom L-BFGS leg from the gray init at 128 px, iterations 6-10: on the
# CPU, every gradient multiplied by (1 + e N(0, 1)) for any e from 1e-7 to
# 1e-3 moves those losses by up to 2.0e-3 (21 runs; the line searches never
# changed), and the card's gradient at the gray init differs from the CPU's
# by 3.7e-2 of its max (a nearly constant image's W2 gradient magnifies
# feature differences): those iterations are determined to float32 only to
# about 2e-3 (ROADMAP C). Iterations 1-5 stay at CPU_RTOL, and every
# line-search step must match.
ZOOM_CPU_RTOL = 5e-3
RESUME_RTOL = 1e-5
LPIPS_RTOL = 1e-4
BF16_TAP_TOL = 5e-2  # of max, the JAX package's bound (tests/test_vgg.py)
SHARDED_RTOL = 1e-3  # sharded against one-device card runs: the CPU bar
PYRAMID = [(128, 96), (181, 136), (256, 192), (362, 272), (512, 384)]
BIG_SCALE, BIG_CANVAS = 1448, (1448, 1086)  # a print-size scale of the content
# BASELINE.json config #5: the content's pyramid 128 -> 2896 (ten scales).
PRINT_SCALE = 2896
PRINT_PYRAMID = [(128, 96), (181, 136), (256, 192), (362, 272), (512, 384), (724, 543),
                 (1024, 768), (1448, 1086), (2048, 1536), (2896, 2172)]
DEVICE = "cuda:0"
# Published H100 SXM peaks: dense TF32 on the tensor cores, FP32 outside
# them, and HBM3.
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SRC = "style_transfer_tpu_torch/csrc/ns_sqrtm.cu"
PALLAS = "style_transfer_tpu/ops/pallas/ns_sqrtm.py"
# The kernels of csrc/ carry these prefixes (the ptxas report's filter):
# the NS kernels stt_nsk_, the line-search step stt_zls_.
KERNEL_PREFIX = r"stt_(?:nsk|zls)_"
# The line-search step kernel: its source, the JAX code whose search it
# steps (optax.lbfgs's update inside the JAX runner's compiled chunk; not a
# pallas_call), and the searches it is checked on.
LS_SRC = "style_transfer_tpu_torch/csrc/zoom_ls.cu"
LS_REPLACES = "style_transfer_tpu/step.py:673"
LS_FIXTURE = REPO / "tests" / "fixtures" / "zoom_ls_searches.json"
LS_RANDOM = 400
# name -> (products of 2C^3 per matrix that the inputs need, C x C matrices
# read + written, the TPU kernel it replaces). NS's first iteration has no
# product by Z_0 = I; B2 skips the last Z product, B3 the last a product.
KERNELS = {
    "ns_sqrtm_yz": (3 * ITERS - 2, 3, f"{PALLAS}:73"),
    "ns_sqrtm": (3 * ITERS - 3, 2, f"{PALLAS}:57"),
    "lyap_bwd": (6 * ITERS - 1, 3, f"{PALLAS}:92"),
}


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
    """Builds the kernels and prints each entry function's registers, shared
    memory and spills from the ptxas report."""
    import re

    from style_transfer_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.load()
    secs = time.perf_counter() - t0
    print(f"kernel build: {secs:.2f} s ({build.library_path().name})")
    name = None
    for line in build.library_path().with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:  # the kernels' names are lower case; the mangling is not
            k = re.search(KERNEL_PREFIX + r"[a-z_]+", m.group(1))
            tmpl = re.search(r"ILi(\d+)E", m.group(1))
            name = (k.group(0) if k else m.group(1)) + (f"<{tmpl.group(1)}>" if tmpl else "")
        elif name and ("spill" in line or "registers" in line):
            print(f"  ptxas {name}: {line.strip().removeprefix('ptxas info    : ')}")
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


def _bound_ms(name, g, c):
    """(least milliseconds the card needs for one call, the FP32-FMA figure
    of earlier reports, its FLOP). The least time is the larger of the
    FP32-accurate route's tensor-core work, 3 TF32 passes per product over
    the TF32 peak, and the bytes (each input read once, each output written
    once) over the memory rate; the FP32-FMA figure puts the FLOP over the
    FP32 peak instead."""
    products, mats, _ = KERNELS[name]
    flop = products * 2 * c ** 3 * g
    byte_ms = mats * 4 * c * c * g / PEAK_BYTES * 1e3
    return (max(3 * flop / PEAK_TF32 * 1e3, byte_ms),
            max(flop / PEAK_FP32 * 1e3, byte_ms), flop)


def _rel_err(x, ref):
    return ((x - ref).abs().max() / ref.abs().max()).item()


def _check(name, err, limit, what):
    if not err <= limit:
        raise AssertionError(f"{name}: {what} {err:.3g} (limit {limit})")


def _graph_replay_equal(fn):
    """Whether ``fn()``'s kernel launch, captured alone into a CUDA graph on
    a side stream and replayed, gives outputs equal bit for bit to the
    eager launch of ``fn()`` (made first, which also does the kernel's
    one-time setup outside the capture)."""
    import torch

    eager = fn()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    for t in out:
        t.fill_(float("nan"))  # the capture ran nothing; the replay must write them
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(eager, out))


def _kernel_phase():
    import torch

    from style_transfer_tpu_torch.models.vgg import feature_shape
    from style_transfer_tpu_torch.ops import sqrtm as S
    from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K

    dev = torch.device("cuda", 0)
    cases = []  # (name, input, per-matrix style weights or None off the path)
    for layer_c in sorted({c for c in TAPS.values()}):
        layers = [l for l, c in TAPS.items() if c == layer_c]
        h, w, _ = feature_shape(layers[0], 384, 512)  # the 512x384 canvas
        cases.append((f"({len(layers)},{layer_c},{layer_c})",
                      _loss_inputs(dev, len(layers), layer_c, (h, w), layer_c),
                      [LAYER_WEIGHTS[l] for l in layers]))
    cases.append(("(1,100,100) ragged", _loss_inputs(dev, 1, 100, (40, 40), 100), None))
    cases.append(("(1,200,200) ragged, cluster regime",
                  _loss_inputs(dev, 1, 200, (48, 64), 200), None))
    cases.append(("(1,300,300) ragged, GEMM regime",
                  _loss_inputs(dev, 1, 300, (48, 64), 300), None))
    cases.append(("(1,512,512) rank 64 + 1e-4 I", _rank_deficient(dev, 512, 64, 7), None))

    stats = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                     fp32_fma_bound_ms=0.0) for k in KERNELS}

    def record(kname, case, a, ms, plain_ms, abs_err, on_path):
        g_, c_ = a.shape[0], a.shape[-1]
        bound, fma_bound, flop = _bound_ms(kname, g_, c_)
        print(f"  {kname} {case}: kernel {ms:.4f} ms ({flop / (ms * 1e-3) / 1e12:.2f} "
              f"TFLOP/s FP32-accurate, {bound / ms:.1%} of its bound {bound:.4f} ms; "
              f"FP32-FMA bound {fma_bound:.4f} ms), plain {plain_ms:.4f} ms")
        if not bound <= ms:
            raise AssertionError(f"{kname} {case}: {ms} ms is below its bound {bound} ms")
        if on_path:
            st = stats[kname]
            st["max_abs_err"] = max(st["max_abs_err"], abs_err)
            st["ms"] += ms
            st["plain_ms"] += plain_ms
            st["bound_ms"] += bound
            st["fp32_fma_bound_ms"] += fma_bound

    for name, a, weights in cases:
        on_path = weights is not None
        g_, c_ = a.shape[0], a.shape[-1]
        wts = torch.tensor(weights or [1.0] * g_, device=dev)

        # B1: the coupled NS kernel and its trace autograd.
        y, z = K.ns_sqrtm_yz(a, ITERS)
        py, pz = K.ns_sqrtm_yz_plain(a, ITERS)
        torch.cuda.synchronize()
        if not (torch.isfinite(y).all() and torch.isfinite(z).all()):
            raise AssertionError(f"{name}: non-finite ns_sqrtm_yz output")
        tr, ptr = S._batch_trace(y), S._batch_trace(py)
        tr_err = ((tr - ptr).abs() / ptr.abs()).max().item()
        z_err = _rel_err(z, pz)
        _check(name, tr_err, KERNEL_RTOL_TRACE, "ns_sqrtm_yz tr(Y) rel err")
        _check(name, z_err, KERNEL_TOL_Z, "ns_sqrtm_yz Z err of max|Z|")
        ak = a.clone().requires_grad_(True)
        (gk,) = torch.autograd.grad((K.trace_sqrtm_ns(ak, ITERS) * wts).sum(), ak)
        ap = a.clone().requires_grad_(True)
        (gp,) = torch.autograd.grad((S.trace_sqrtm_ns(ap, ITERS) * wts).sum(), ap)
        g_err = _rel_err(gk, gp)
        _check(name, g_err, KERNEL_TOL_Z, "trace gradient err of max")
        print(f"kernels at {name}: ns_sqrtm_yz tr(Y) rel err {tr_err:.2e}, Z err "
              f"{z_err:.2e} of max|Z|, trace grad err {g_err:.2e}")
        if c_ >= 256:  # single-pass TF32 on the plain chain, for the record
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                ty, tz = K.ns_sqrtm_yz_plain(a, ITERS)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            ttr = ((S._batch_trace(ty) - ptr).abs() / ptr.abs()).max().item()
            print(f"single-pass TF32 plain chain at {name} (not a check): tr(Y) rel err "
                  f"{ttr:.2e}, Y err {_rel_err(ty, py):.2e} of max|Y|, Z err "
                  f"{_rel_err(tz, pz):.2e} of max|Z|")
        ms, plain_ms = _time_pair(lambda: K.ns_sqrtm_yz(a, ITERS),
                                  lambda: K.ns_sqrtm_yz_plain(a, ITERS))
        record("ns_sqrtm_yz", name, a, ms, plain_ms,
               max((y - py).abs().max().item(), (z - pz).abs().max().item()), on_path)

        # B2: the NS forward, Y only.
        y2 = K.ns_sqrtm(a, ITERS)
        py2 = K.ns_sqrtm_plain(a, ITERS)
        torch.cuda.synchronize()
        if not torch.isfinite(y2).all():
            raise AssertionError(f"{name}: non-finite ns_sqrtm output")
        y2_err = _rel_err(y2, py2)
        _check(name, y2_err, KERNEL_TOL_Y, "ns_sqrtm Y err of max|Y|")

        # B3: the Lyapunov backward on the plain square root, with the loss's
        # own gradient -(2w/C) I and with a random one.
        eye = torch.eye(c_, device=dev)
        g_loss = (-2.0 * wts / c_)[:, None, None] * eye
        gen = torch.Generator(device=dev).manual_seed(c_)
        g_rand = torch.randn((g_, c_, c_), generator=gen, device=dev)
        q_errs, q_abs = [], 0.0
        for gr in (g_loss.contiguous(), g_rand):
            q = K.lyap_bwd(py2, gr, ITERS)
            pq = K.lyap_bwd_plain(py2, gr, ITERS)
            torch.cuda.synchronize()
            if not torch.isfinite(q).all():
                raise AssertionError(f"{name}: non-finite lyap_bwd output")
            q_errs.append(_rel_err(q, pq))
            q_abs = max(q_abs, (q - pq).abs().max().item())
            _check(name, q_errs[-1], KERNEL_TOL_Q, "lyap_bwd Q err of max|Q|")

        # SqrtmNSLyap (B2 forward, B3 backward) against the plain autograd,
        # through the loss's trace form.
        ak = a.clone().requires_grad_(True)
        (gk,) = torch.autograd.grad(
            (S._batch_trace(K.sqrtm_ns_lyap(ak, ITERS)) * wts).sum(), ak)
        ap = a.clone().requires_grad_(True)
        (gp,) = torch.autograd.grad(
            (S._batch_trace(S.sqrtm_ns_lyap(ap, ITERS)) * wts).sum(), ap)
        lg_err = _rel_err(gk, gp)
        _check(name, lg_err, KERNEL_TOL_Q, "SqrtmNSLyap gradient err of max")
        print(f"kernels at {name}: ns_sqrtm Y err {y2_err:.2e} of max|Y|; lyap_bwd "
              f"Q err {q_errs[0]:.2e} (loss gradient), {q_errs[1]:.2e} (random) of "
              f"max|Q|; SqrtmNSLyap grad err {lg_err:.2e}")
        ms, plain_ms = _time_pair(lambda: K.ns_sqrtm(a, ITERS),
                                  lambda: K.ns_sqrtm_plain(a, ITERS))
        record("ns_sqrtm", name, a, ms, plain_ms, (y2 - py2).abs().max().item(), on_path)
        g_path = g_loss.contiguous()
        ms, plain_ms = _time_pair(lambda: K.lyap_bwd(py2, g_path, ITERS),
                                  lambda: K.lyap_bwd_plain(py2, g_path, ITERS))
        record("lyap_bwd", name, a, ms, plain_ms, q_abs, on_path)

        # The graph leg: each kernel captured alone into a CUDA graph and
        # replayed, bit for bit its eager launch (the cluster regime's launch
        # attribute included).
        same = {"ns_sqrtm_yz": _graph_replay_equal(lambda: K.ns_sqrtm_yz(a, ITERS)),
                "ns_sqrtm": _graph_replay_equal(lambda: (K.ns_sqrtm(a, ITERS),)),
                "lyap_bwd": _graph_replay_equal(lambda: (K.lyap_bwd(py2, g_rand, ITERS),))}
        print(f"graph replay against eager launch at {name}, bit-identical: {same}")
        if not all(same.values()):
            raise AssertionError(f"{name}: a graph replay differs from its eager launch")

    stats["ns_sqrtm_yz"]["grouped_ms"] = _grouped_phase(
        [(name, a) for name, a, weights in cases if weights is not None])
    for kname, st in stats.items():
        print(f"{kname} per step (the four groups): kernel {st['ms']:.4f} ms, plain "
              f"{st['plain_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms "
              f"({st['bound_ms'] / st['ms']:.1%} of the bound; FP32-FMA bound "
              f"{st['fp32_fma_bound_ms']:.4f} ms)")
        if not st["bound_ms"] <= st["ms"]:
            raise AssertionError(f"{kname}: per-step time below its bound")
    return stats


def _device_ms(fn, reps=10):
    """Device milliseconds per call of ``fn``'s NS kernels (``stt_nsk_``),
    from ``torch.profiler`` after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "stt_nsk_" in e.name) / reps / 1e3


def _grouped_phase(cases):
    """B1's grouped launch at the main path's four groups (one launch a
    loss evaluation): each group against the plain chain at phase 2's
    tolerances, the C > 256 group bit for bit against the per-group kernels
    (``ns_sqrtm_yz_serial``), a graph replay bit for bit against the eager
    launch, and its device time beside the four groups' launched one at a
    time and by the per-group kernels. Returns the grouped launch's ms."""
    import torch

    from style_transfer_tpu_torch.ops import sqrtm as S
    from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K

    mats = [a for _, a in cases]
    out = K.ns_sqrtm_yz_groups(mats, ITERS)
    for (name, a), (y, z) in zip(cases, out):
        py, pz = K.ns_sqrtm_yz_plain(a, ITERS)
        tr, ptr = S._batch_trace(y), S._batch_trace(py)
        _check(name, ((tr - ptr).abs() / ptr.abs()).max().item(), KERNEL_RTOL_TRACE,
               "grouped ns_sqrtm_yz tr(Y) rel err")
        _check(name, _rel_err(z, pz), KERNEL_TOL_Z, "grouped ns_sqrtm_yz Z err of max|Z|")
        if a.shape[-1] > 256:
            sy, sz = K.ns_sqrtm_yz_serial(a, ITERS)
            if not (torch.equal(y, sy) and torch.equal(z, sz)):
                raise AssertionError(f"{name}: the grouped launch differs from the "
                                     "per-group kernels")
    if not _graph_replay_equal(lambda: [t for yz in K.ns_sqrtm_yz_groups(mats, ITERS)
                                        for t in yz]):
        raise AssertionError("the grouped launch's graph replay differs from its eager launch")
    grouped = _device_ms(lambda: K.ns_sqrtm_yz_groups(mats, ITERS))
    alone = [_device_ms(lambda a=a: K.ns_sqrtm_yz(a, ITERS)) for a in mats]
    serial = [_device_ms(lambda a=a: K.ns_sqrtm_yz_serial(a, ITERS)) for a in mats]
    names = [name for name, _ in cases]
    print(f"grouped B1 launch at {names}: device {grouped:.4f} ms a loss evaluation; "
          f"each group launched alone {[round(v, 4) for v in alone]} (sum "
          f"{sum(alone):.4f}); the per-group kernels {[round(v, 4) for v in serial]} (sum "
          f"{sum(serial):.4f}); bit for bit at C > 256, graph replay bit for bit")
    return grouped


def _ls_cases(dev):
    """The line-search step kernel's inputs: (name, start state, trials
    [(value, slope), ...], step limit). The fixture's searches from their
    starts; a zoom state whose interval has zero width; one whose trial
    leaves a cubic with no critical point (a negative radical, NaN, so the
    next step is the quadratic's or the midpoint); LS_RANDOM random
    states (seed 0: fields N(0, 3), half of them zooming, NaN and inf in
    some values and slopes), one trial each."""
    import numpy as np
    import torch

    from style_transfer_tpu_torch.ops.cuda import zoom_ls as ZL

    fixture = json.loads(LS_FIXTURE.read_text())
    if fixture["fields"] != list(ZL.LS_FIELDS):
        raise AssertionError("the searches fixture's fields are not LS_FIELDS")
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    cases = []
    for search in fixture["searches"]:
        state, _ = ZL.ls_init(*map(scalar, search["init"]))
        cases.append((search["name"], state, search["trials"], search["max_steps"]))
    zero_width = dict(value_init=1.0, slope_init=-1.0, low=0.5, value_low=0.9,
                      slope_low=-0.5, high=0.5, value_high=0.9, slope_high=-0.5,
                      cubic_ref=0.25, value_cubic_ref=0.95, safe_stepsize=0.5,
                      safe_value=0.9, stepsize=0.5, decrease_error=0.0, interval_found=1.0,
                      count=3.0)
    cases.append(("zero-width interval",
                  scalar([zero_width.get(f, 0.0) for f in ZL.LS_FIELDS]),
                  [[0.9, -0.5]], 20))
    monotone = dict(value_init=1.0, slope_init=-1.0, low=0.0, value_low=1.0, slope_low=-1.0,
                    high=1.0, value_high=-0.3, slope_high=-1.0, cubic_ref=1.0,
                    value_cubic_ref=-0.3, safe_value=1.0, stepsize=0.5, interval_found=1.0,
                    count=2.0)
    cases.append(("negative cubic radical",
                  scalar([monotone.get(f, 0.0) for f in ZL.LS_FIELDS]),
                  [[0.5, -1.0]], 20))
    rng = np.random.RandomState(0)
    specials = [float("nan"), float("inf"), -float("inf")]
    for k in range(LS_RANDOM):
        fields = dict(zip(ZL.LS_FIELDS, 3 * rng.randn(len(ZL.LS_FIELDS))))
        fields.update(interval_found=float(k % 2), done=0.0, failed=0.0,
                      count=float(rng.randint(0, 19)),
                      safe_stepsize=abs(fields["safe_stepsize"]) * (k % 3 > 0))
        value, slope = rng.randn(2)
        if k % 7 == 0:
            value = specials[k % 3]
        if k % 11 == 0:
            slope = specials[(k // 11) % 3]
        cases.append((f"random {k}", scalar([fields[f] for f in ZL.LS_FIELDS]),
                      [[value, slope]], 20))
    return cases


def _cubic_radical(state):
    """The radical of the cubic that the next zoom trial would try, from a
    state's fields (the plain version's arithmetic)."""
    from style_transfer_tpu_torch.ops.cuda import zoom_ls as ZL

    f = dict(zip(ZL.LS_FIELDS, state.unbind(0)))
    return ZL._cubic(f["low"], f["value_low"], f["slope_low"], f["high"], f["value_high"],
                     f["cubic_ref"], f["value_cubic_ref"])[2]


def zoom_ls_against_plain(dev):
    """Phase 2's line-search leg (see the module docstring). Returns its
    record: steps compared, mismatches (must be 0), kernel launches, max
    abs difference over the non-NaN fields, the searches that failed, ran
    into their limit, or had a NaN value, negative radicals seen, and the
    graph leg's result."""
    import torch

    from style_transfer_tpu_torch.ops.cuda import zoom_ls as ZL

    def same(a, b):
        return bool(((a.view(torch.int32) == b.view(torch.int32))
                     | (a.isnan() & b.isnan())).all())

    launches0 = ZL.ls_step_.launches
    rec = dict(steps=0, mismatches=0, max_abs_err=0.0, failed=0, at_limit=0, nan_value=0,
               negative_radical=0)
    for name, start, trials, max_steps in _ls_cases(dev):
        ks, ps = start.clone(), start.clone()
        kg = torch.ones((), dtype=torch.bool, device=dev)
        pg = kg.clone()
        for value, slope in trials:
            v, sl = (torch.tensor(x, dtype=torch.float32, device=dev) for x in (value, slope))
            ZL.ls_step_(ks, kg, v, sl, max_steps)
            ZL.ls_step_plain_(ps, pg, v, sl, max_steps)
            rec["steps"] += 1
            rec["nan_value"] += value != value
            if not same(ks, ps) or bool(kg) != bool(pg):
                rec["mismatches"] += 1
                if rec["mismatches"] <= 3:
                    print(f"  line-search step mismatch at {name}: kernel {ks.tolist()} "
                          f"{bool(kg)}, plain {ps.tolist()} {bool(pg)}")
            finite = ~(ks.isnan() | ps.isnan())
            if finite.any():
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         (ks - ps)[finite].abs().max().item())
            zooming = bool(pg) and ps[ZL.LS_FIELDS.index("interval_found")].item() == 1.0
            rec["negative_radical"] += zooming and bool(_cubic_radical(ps) < 0)
            if not bool(pg):
                break
        fields = dict(zip(ZL.LS_FIELDS, ps.tolist()))
        rec["failed"] += fields["failed"] == 1.0
        rec["at_limit"] += fields["failed"] == 1.0 and fields["count"] == max_steps
    rec["launches"] = ZL.ls_step_.launches - launches0

    # One trial's step captured alone into a graph and replayed, against
    # its eager launch.
    start, _ = ZL.ls_init(*(torch.tensor(x, device=dev) for x in (1.0, -1.0)))
    v, sl = (torch.tensor(x, device=dev) for x in (2.0, 1.5))
    eager_state, eager_go = start.clone(), torch.ones((), dtype=torch.bool, device=dev)
    ZL.ls_step_(eager_state, eager_go, v, sl, 20)
    state, go = start.clone(), torch.ones((), dtype=torch.bool, device=dev)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream):
        ZL.ls_step_(state, go, v, sl, 20)
    state.copy_(start)
    go.fill_(True)
    graph.replay()
    torch.cuda.synchronize()
    rec["graph_equal"] = torch.equal(state, eager_state) and bool(go) == bool(eager_go)
    return rec


def _ls_phase(dev):
    """Phase 2's line-search leg with its timing: per call, the kernel and
    the plain version on one state (CUDA events), and the bound."""
    import torch

    from style_transfer_tpu_torch.ops.cuda import zoom_ls as ZL

    rec = zoom_ls_against_plain(dev)
    print(f"line-search step kernel against its plain version: {rec['steps']} steps, "
          f"{rec['mismatches']} mismatches (bits of every field and go, NaN as NaN), max "
          f"abs diff {rec['max_abs_err']:.3g}; searches failed {rec['failed']} ({rec['at_limit']}"
          f" at their limit), NaN values {rec['nan_value']}, negative cubic radicals "
          f"{rec['negative_radical']}; graph replay equal to the eager launch: "
          f"{rec['graph_equal']}")
    if rec["mismatches"] or not rec["graph_equal"] or rec["launches"] != rec["steps"]:
        raise AssertionError(f"line-search step kernel: {rec}")
    if not (rec["failed"] and rec["at_limit"] and rec["nan_value"]
            and rec["negative_radical"]):
        raise AssertionError(f"line-search step check missed a case: {rec}")
    # Each timed call steps its own state on (the same work whatever the
    # values: one thread, every branch of the plain version).
    start, _ = ZL.ls_init(*(torch.tensor(x, device=dev) for x in (1.0, -1.0)))
    v, sl = (torch.tensor(x, device=dev) for x in (0.9, -0.95))
    (ks, kg), (ps, pg) = ((start.clone(), torch.ones((), dtype=torch.bool, device=dev))
                          for _ in range(2))
    ms, plain_ms = _time_pair(lambda: ZL.ls_step_(ks, kg, v, sl, 20),
                              lambda: ZL.ls_step_plain_(ps, pg, v, sl, 20))
    # A call reads the state, the value and the slope once and writes the
    # state and go once; its ~100 float operations take 1e-12 s at the
    # FP32 peak, so bytes bound it.
    nbytes = (2 * len(ZL.LS_FIELDS) + 2) * 4 + 1
    bound = nbytes / PEAK_BYTES * 1e3
    print(f"  per call: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
          f"{bound * 1e6:.3f} ns ({nbytes} bytes)")
    return dict(max_abs_err=rec["max_abs_err"], ms=ms, plain_ms=plain_ms, bound_ms=bound)


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


@contextlib.contextmanager
def _linesearch_counts():
    """Yields a list to which each lbfgs-zoom iteration's line-search
    evaluations are appended (the runner's own value and gradient not
    counted), read from each runner's record of its chunk
    (``_Runner.linesearch_steps``) as the chunk returns: graph replays
    never call the host's update."""
    from style_transfer_tpu_torch import step as S

    counts, call = [], S._Runner.__call__

    def recording(self, *args, **kw):
        out = call(self, *args, **kw)
        if self.linesearch_steps is not None:
            counts.extend(self.linesearch_steps.tolist())
        return out

    S._Runner.__call__ = recording
    try:
        yield counts
    finally:
        S._Runner.__call__ = call


def _card_vs_cpu_phase(content_path, style_path):
    import numpy as np
    from PIL import Image

    from style_transfer_tpu_torch import StyleTransfer
    from style_transfer_tpu_torch.models.weights import random_params

    params = random_params(0)
    # The L-BFGS legs start from the gray init: from the content init the
    # reference L-BFGS trajectory parts under float32 rounding noise (see
    # tests/test_torch_lbfgs.py), so no two FP32 implementations follow it,
    # and the zoom L-BFGS's last iterations are determined only to about
    # 2e-3 (tests/test_torch_zoom.py).
    for optimizer, w2_grad, init in (("adam", "trace", "content"),
                                     ("adam", "lyap", "content"),
                                     ("lbfgs", "lyap", "gray"),
                                     ("lbfgs-zoom", "trace", "gray")):
        losses, evals = [], []
        for device in ("cuda:0", "cpu"):
            st = StyleTransfer(device=device, weights=params, w2_grad=w2_grad,
                               callback_chunk=10)
            its = []
            with Image.open(content_path) as c, Image.open(style_path) as s, \
                    _linesearch_counts() as counts:
                st.stylize(c.convert("RGB"), [s.convert("RGB")], min_scale=128,
                           end_scale=128, iterations=10, initial_iterations=10,
                           optimizer=optimizer, init=init, callback=its.append)
            losses.append(np.array([i.loss for i in its]))
            evals.append(counts)
        card, cpu = losses
        rel = np.abs(card - cpu) / np.abs(cpu)
        limit, limits = np.full(10, CPU_RTOL), f"{CPU_RTOL}"
        if optimizer == "lbfgs-zoom":
            limit[5:] = ZOOM_CPU_RTOL
            limits += f", {ZOOM_CPU_RTOL} from iteration 6"
        print(f"card vs cpu ({optimizer}, {w2_grad}, {init} init) at 128 px, 10 "
              f"iterations: max rel loss diff {rel.max():.2e} (limit {limits}); "
              f"first/last loss card {card[0]:.7g}/{card[-1]:.7g}, cpu "
              f"{cpu[0]:.7g}/{cpu[-1]:.7g}")
        if optimizer == "lbfgs-zoom":
            print("  rel loss diff per iteration: "
                  + " ".join(f"{r:.1e}" for r in rel))
            print(f"  line-search evaluations per iteration: card {evals[0]}, cpu "
                  f"{evals[1]}; evaluations per iteration with the runner's own "
                  f"{1 + sum(evals[0]) / 10:.2f} (card), {1 + sum(evals[1]) / 10:.2f} (cpu)")
            print(f"  the loss's gradient at the gray init, card against cpu: "
                  f"{_gray_init_gradient_diff(content_path, style_path):.2e} of its max")
            if evals[0] != evals[1]:
                raise AssertionError("card and cpu line searches took different steps")
        if not (rel <= limit).all():
            raise AssertionError(f"card and cpu losses disagree ({optimizer}, {w2_grad})")


def _gray_init_gradient_diff(content_path, style_path):
    """max |g_card - g_cpu| / max |g_cpu| of the loss's image gradient at
    the 128 px gray init (the same host draw on both devices)."""
    import torch
    from PIL import Image

    from style_transfer_tpu_torch import StyleTransfer
    from style_transfer_tpu_torch import step as S
    from style_transfer_tpu_torch.engine import _pil_to_nchw
    from style_transfer_tpu_torch.models.weights import random_params

    grads = []
    for device in ("cuda:0", "cpu"):
        st = StyleTransfer(device=device, weights=random_params(0))
        cfg = S.StepConfig()
        with Image.open(content_path) as c, Image.open(style_path) as s:
            content = _pil_to_nchw(c.convert("RGB"), (128, 96), st.device)
            image = st._init_image("gray", None, None, None, (96, 128))
            consts = st._capture_targets(content, [s.convert("RGB")], [1.0], 128, 1.0,
                                         None, cfg)
        x = image.requires_grad_(True)
        (g,) = torch.autograd.grad(S.build_loss_fn(cfg)(x, st.params, consts), x)
        grads.append(g.cpu())
    return ((grads[0] - grads[1]).abs().max() / grads[1].abs().max()).item()


def _steady_phase():
    """Steady state of the step at 512x384 for each flavour of the path, the
    step and its inputs made by ``bench.build_step``: ms/iter over 20
    iterations ended by one sync (after 3 warm-up), then
    ``tools/profile_step_torch.py``'s profile of 5 iterations for the
    device's busy share (summed kernel time over the wall of 5 iterations
    run without the profiler), the NS kernels' share of it and the five
    costliest kernels."""
    import profile_step_torch
    import torch

    from style_transfer_tpu_torch.bench import build_step

    device = torch.device(DEVICE)
    for optimizer, w2_grad, precision, eager in (
            ("adam", "trace", "f32", False), ("adam", "lyap", "f32", False),
            ("lbfgs", "lyap", "f32", False), ("lbfgs-zoom", "trace", "f32", False),
            ("lbfgs-zoom", "trace", "f32", True),
            ("adam", "trace", "bf16", False), ("adam", "lyap", "bf16", False)):
        # One step at a time, so each row's peak memory is its own.
        run = params = consts = state = None
        run, params, consts, state = build_step(
            384, 512, device=device, optimizer=optimizer, w2_grad=w2_grad,
            compute_dtype=precision, eager=eager)
        state, _ = run(params, consts, state, 3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _linesearch_counts() as counts:
            t0 = time.perf_counter()
            state, losses = run(params, consts, state, 20)
            torch.cuda.synchronize()
            ms_iter = (time.perf_counter() - t0) / 20 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**20
        evals = (f", {1 + sum(counts) / 20:.2f} evaluations/iter"
                 if optimizer == "lbfgs-zoom" else "")
        if not torch.isfinite(losses).all():
            raise AssertionError(
                f"steady state ({optimizer}, {w2_grad}, {precision}): non-finite loss")
        state, prof = profile_step_torch.profile_runner(run, params, consts, state, 5, device)
        profiled = (f"busy share {prof['busy']:.2f} ({prof['busy_profiled']:.2f} of the "
                    f"profiled run's wall), kernel time "
                    f"{prof['kernel_ms_per_iter']:.2f} ms/iter of which NS kernels "
                    f"{prof['ns_ms_per_iter']:.2f} ms/iter" if prof else
                    "not measured (the profiler saw no device kernels)")
        runner = "eager" if eager else "graph"
        print(f"steady state ({optimizer}, {w2_grad}, {precision}, {runner}) at 512x384: "
              f"{ms_iter:.2f} ms/iter{evals}, peak memory {peak:.1f} MiB; "
              f"profiled: {profiled}")
        for k in prof["top"][:5] if prof else ():
            print(f"    {k['ms_per_iter']:.3f} ms/iter  {k['name'][:110]}")


def _launch_counts():
    """The NS kernels' launch counts (the line-search step's: ``_ls_launches``)."""
    from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K

    return {name: getattr(K, name).launches for name in KERNELS}


def _ls_launches():
    from style_transfer_tpu_torch.ops.cuda import zoom_ls as ZL

    return ZL.ls_step_.launches


def _reset_launch_counts():
    """Sets every kernel's launch count to 0."""
    from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K
    from style_transfer_tpu_torch.ops.cuda import zoom_ls as ZL

    for name in KERNELS:
        getattr(K, name).launches = 0
    ZL.ls_step_.launches = 0


def _run_cli(tmp, content_path, style_path, label, flags):
    """One CLI run (the pyramid 128 -> 512, 20 iterations a scale, unless
    ``flags`` override it) with the counts set to 0 just before it; prints
    ms/iter per scale and returns (iterates, output path, launches).
    ``style_path`` is one style image or a list of them."""
    from style_transfer_tpu_torch import cli
    from style_transfer_tpu_torch.models.weights import random_params, save_params

    weights = tmp / "vgg19_random0.npz"
    if not weights.is_file():
        save_params(random_params(0), weights)
    out, trace = tmp / f"out_{label}.png", tmp / f"trace_{label}.json"
    styles = style_path if isinstance(style_path, list) else [style_path]
    argv = [str(content_path), *map(str, styles), "--devices", DEVICE,
            "--end-scale", "512", "--min-scale", "128", "-i", "20", "-ii", "20",
            "-o", str(out), "--trace", str(trace), "--vgg-weights", str(weights),
            *flags]
    _reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(argv)
    wall = time.perf_counter() - t0
    launches = _launch_counts()

    its = json.loads(trace.read_text())["iterates"]
    print(f"CLI run [{label}: {' '.join(flags) or 'defaults'}]: {len(its)} "
          f"iterations over scales {list(_by_scale(its))} in {wall:.2f} s")
    for (w, h), s in _by_scale(its).items():
        ms_iter = (s[-1]["time"] - s[0]["time"]) / max(len(s) - 1, 1) * 1e3
        peak = max(i["gpu_ram"] for i in s) / 2**20
        print(f"  {w}x{h}: {ms_iter:.2f} ms/iter, peak memory {peak:.1f} MiB, "
              f"loss {s[0]['loss']:.6g} -> {s[-1]['loss']:.6g}")
    return its, out, launches


def _by_scale(its):
    by_scale = {}
    for it in its:
        by_scale.setdefault((it["w"], it["h"]), []).append(it)
    return by_scale


def _cli_phase(tmp, content_path, style_path, label, flags, expect, sizes=PYRAMID):
    """One CLI pyramid run; checks the run and that the launch counts equal
    ``expect``."""
    its, out, launches = _run_cli(tmp, content_path, style_path, label, flags)
    _check_pyramid(its, out, sizes)
    print(f"  kernel launches over the run: {launches} (expected {expect}: B1 once an "
          "iteration for the four groups, B2 and B3 once a group and iteration)")
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    return launches


def _check_pyramid(its, out, sizes=PYRAMID, iters=20):
    """The pyramid's scales, ``iters`` finite losses each, falling over the
    first scale, and a non-constant output of the last scale's size
    (``out`` None: not read here)."""
    import numpy as np
    from PIL import Image

    by_scale = _by_scale(its)
    if list(by_scale) != list(sizes):
        raise AssertionError(f"unexpected pyramid {list(by_scale)}")
    if not all(len(s) == iters for s in by_scale.values()):
        raise AssertionError(f"each scale should run {iters} iterations")
    losses = np.array([i["loss"] for i in its])
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss")
    first = by_scale[sizes[0]]
    if not first[-1]["loss"] < first[0]["loss"]:
        raise AssertionError("the first scale's loss did not decrease")
    if out is None:
        return
    with Image.open(out) as img:
        if img.size != tuple(sizes[-1]):
            raise AssertionError(f"output is {img.size}, expected {sizes[-1]}")
        arr = np.asarray(img.convert("RGB"))
        if arr.std() == 0:
            raise AssertionError("output image is constant")


def _zoom_phase(tmp, content_path, style_path):
    """Phase 4's pyramid with ``--optimizer lbfgs-zoom`` (graph replays):
    every loss evaluation (the runner's own and each line-search trial)
    launches B1 once for the four channel groups, so B1 launches 100 + the
    trials times, the line-search step kernel once per trial, and B2/B3
    never; each scale's capture of its three graphs (the engine's
    ``  capture@S`` rows). Returns the launches, the line-search step's
    included."""
    from style_transfer_tpu_torch.engine import phase_totals

    phase_totals(reset=True)
    with _linesearch_counts() as counts:
        its, out, launches = _run_cli(tmp, content_path, style_path, "zoom-trace",
                                      ["--optimizer", "lbfgs-zoom"])
    ls = _ls_launches()
    captures = {k.split("@")[1]: round(v, 3) for k, v in phase_totals().items()
                if k.startswith("  capture@")}
    print(f"  graph capture and instantiate per scale (s): {captures}")
    _check_pyramid(its, out)
    b1 = launches["ns_sqrtm_yz"]
    print(f"  kernel launches over the run: {launches}, line-search step {ls}; B1 "
          f"launches / 100 = {b1 / 100:.3f} evaluations per iteration; line-search "
          f"evaluations {sum(counts)} over {len(counts)} iterations (max {max(counts)} "
          "in one)")
    if b1 < 100 or launches["ns_sqrtm"] or launches["lyap_bwd"]:
        raise AssertionError(f"zoom path launches {launches}")
    if len(counts) != 100 or b1 != len(counts) + sum(counts):
        raise AssertionError(f"B1 launches {b1} != the {len(counts) + sum(counts)} "
                             "loss evaluations")
    if ls != sum(counts):
        raise AssertionError(f"line-search step launches {ls} != the {sum(counts)} trials")
    if DEVICE != "cpu" and len(captures) != len(PYRAMID):
        raise AssertionError(f"zoom path: captures {captures}, one per scale expected")
    return dict(launches, zoom_ls_step=ls)


def _read_png(path):
    import numpy as np
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB")).astype(np.int16)


@contextlib.contextmanager
def _timed_checkpoint_writes():
    """Times each checkpoint write on the writer thread, its device fetch
    included; yields the list the writes are appended to, as (w, h,
    seconds, bytes)."""
    from style_transfer_tpu_torch.utils import checkpoint as ckmod

    writes, fetched = [], [0.0]
    fetch, save = ckmod._fetch_cuda, ckmod.save_checkpoint

    def timed_fetch(state, ready):
        t0 = time.perf_counter()
        out = fetch(state, ready)
        fetched[0] = time.perf_counter() - t0
        return out

    def timed_save(path, **kw):
        t0 = time.perf_counter()
        save(path, **kw)
        writes.append((kw["meta"]["w"], kw["meta"]["h"],
                       fetched[0] + time.perf_counter() - t0, Path(path).stat().st_size))
        fetched[0] = 0.0

    ckmod._fetch_cuda, ckmod.save_checkpoint = timed_fetch, timed_save
    try:
        yield writes
    finally:
        ckmod._fetch_cuda, ckmod.save_checkpoint = fetch, save


def _rel_diff(its, ref_its):
    """(bit-identical, max relative difference) of two runs' losses."""
    import numpy as np

    got = np.array([it["loss"] for it in its])
    ref = np.array([it["loss"] for it in ref_its])
    return bool((got == ref).all()), float((np.abs(got - ref) / np.abs(ref)).max())


def _resume_leg(tmp, content_path, style_path, label, flags, expect, writes):
    """An uninterrupted pyramid; the same with checkpoints every 10
    iterations, interrupted by a KeyboardInterrupt from the callback at
    iteration 10 of the third scale (which the CLI catches as it catches
    Ctrl-C); then ``--resume`` to the end with the counts set to 0 just
    before it. The caller runs this under cuDNN's deterministic algorithms."""
    from style_transfer_tpu_torch import cli

    ref_its, ref_out, _ = _run_cli(tmp, content_path, style_path,
                                   f"{label}-deterministic", flags)
    ck = tmp / f"ck_{label}.npz"
    run = flags + ["--checkpoint", str(ck), "--checkpoint-every", "10",
                   "--callback-chunk", "10"]
    call = cli.Callback.__call__

    def interrupting(self, it):
        if (it.w, it.h) == PYRAMID[2] and it.i == 10:
            raise KeyboardInterrupt
        call(self, it)

    cli.Callback.__call__ = interrupting
    try:
        _run_cli(tmp, content_path, style_path, f"{label}-interrupted", run)
    finally:
        cli.Callback.__call__ = call
    del writes[:]
    its, out, launches = _run_cli(tmp, content_path, style_path, f"{label}-resumed",
                                  run + ["--resume"])
    resumed = [(it["w"], it["h"], it["i"]) for it in its]
    expected = [(it["w"], it["h"], it["i"]) for it in ref_its[50:]]
    if resumed != expected:
        raise AssertionError(f"{label}: resumed iterations {resumed[:3]}... "
                             f"expected {expected[:3]}...")
    same, rel = _rel_diff(its, ref_its[50:])
    diff = int(abs(_read_png(out) - _read_png(ref_out)).max())
    print(f"resume [{label}]: {len(its)} iterations from scale 3 iteration 11; "
          f"losses bit-identical to the uninterrupted run: {same}, max rel diff "
          f"{rel:.3g} (limit {RESUME_RTOL}); output max diff {diff}/255 (limit 1); "
          f"launches {launches} (expected {expect})")
    if not rel <= RESUME_RTOL:
        raise AssertionError(f"{label}: resumed losses differ from the uninterrupted run")
    if diff > 1:
        raise AssertionError(f"{label}: resumed output differs by {diff}/255")
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected {expect}")
    for w, h, secs, size in writes:
        print(f"  checkpoint write at {w}x{h} on the writer thread: {secs * 1e3:.1f} ms, "
              f"{size / 2**20:.2f} MiB")


def _resume_phase(tmp, content_path, style_path):
    import torch

    with _timed_checkpoint_writes() as writes:
        # Two runs of phase 4's pyramid under cuDNN's default algorithm
        # choice, for the spread the resume check cannot use.
        for label, flags in (("adam-trace", []),
                             ("lbfgs-lyap", ["--optimizer", "lbfgs", "--w2-grad", "lyap"])):
            again, _, _ = _run_cli(tmp, content_path, style_path, f"{label}-again", flags)
            first = json.loads((tmp / f"trace_{label}.json").read_text())["iterates"]
            same, rel = _rel_diff(again, first)
            print(f"two uninterrupted runs [{label}] under cuDNN's default algorithms: "
                  f"bit-identical {same}, max rel loss diff {rel:.3g}")
        # The resume is held to an uninterrupted run under cuDNN's
        # deterministic algorithms, for this phase only (the main path keeps
        # the default).
        torch.backends.cudnn.deterministic = True
        try:
            for label, flags, expect in (
                    ("adam-trace", [], {"ns_sqrtm_yz": 50, "ns_sqrtm": 0, "lyap_bwd": 0}),
                    ("lbfgs-lyap", ["--optimizer", "lbfgs", "--w2-grad", "lyap"],
                     {"ns_sqrtm_yz": 0, "ns_sqrtm": 200, "lyap_bwd": 200})):
                _resume_leg(tmp, content_path, style_path, label, flags, expect, writes)
        finally:
            torch.backends.cudnn.deterministic = False
        # One print-size scale three ways (and plain again, for the spread):
        # ms/iter from iteration 10 to 30, past the first chunk's warm-up.
        big = ["--min-scale", str(BIG_SCALE), "--end-scale", str(BIG_SCALE), "-ii", "30",
               "--callback-chunk", "10"]
        for label, flags in (("plain", []),
                             ("checkpoint", ["--checkpoint", str(tmp / "ck_big.npz"),
                                             "--checkpoint-every", "10"]),
                             ("save", ["--save-every", "10"]), ("plain again", [])):
            del writes[:]
            its, _, _ = _run_cli(tmp, content_path, style_path,
                                 f"big-{label.replace(' ', '-')}", big + flags)
            if [(it["w"], it["h"]) for it in its] != [BIG_CANVAS] * 30:
                raise AssertionError(f"{BIG_CANVAS} [{label}]: unexpected iterations")
            ms = (its[29]["time"] - its[9]["time"]) / 20 * 1e3
            print(f"{BIG_CANVAS[0]}x{BIG_CANVAS[1]} [{label}]: {ms:.2f} ms/iter over "
                  "iterations 11-30")
            for w, h, secs, size in writes:
                print(f"  checkpoint write at {w}x{h} on the writer thread: "
                      f"{secs * 1e3:.1f} ms, {size / 2**20:.2f} MiB")


@contextlib.contextmanager
def _watched_web():
    """Phase 8's client: every ``WebInterface`` the CLI makes inside the
    block gets a standard-library client, connected as the server starts,
    that reads the page, the events and, after WIDone, the image. Yields
    (what it saw, the interfaces made)."""
    import io

    from PIL import Image

    from style_transfer_tpu_torch import srgb_profile
    from style_transfer_tpu_torch.web import client, server

    seen = {"events": [], "errors": []}
    made = []

    class Watched(server.WebInterface):
        def __init__(self, host, port_):
            super().__init__(host, port_)
            made.append(self)
            status, body, headers = client.get(host, port_, "/")
            seen["page"] = (status, headers.get("Content-Type"), len(body))
            stream = client.EventStream(host, port_, timeout=120)

            def read():
                try:
                    with stream:
                        for event in stream:
                            seen["events"].append(event)
                            if event["_type"] == "WIDone":
                                status, body, _ = client.get(host, port_, "/image")
                                with Image.open(io.BytesIO(body)) as jpeg:
                                    seen["image"] = (
                                        status, jpeg.format, jpeg.size,
                                        jpeg.info.get("icc_profile") == srgb_profile)
                except Exception as err:
                    seen["errors"].append(repr(err))

            self.reader = threading.Thread(target=read, daemon=True)
            self.reader.start()

    live = server.WebInterface
    server.WebInterface = Watched
    try:
        yield seen, made
    finally:
        server.WebInterface = live


def _free_port():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _check_web(seen, made, sizes, final):
    """The client of the one server read the page, STIterates of sizes in
    ``sizes`` only, WIDone last, then a JPEG of the ``final`` canvas with
    the ICC profile; returns the STIterate events."""
    (wi,) = made
    wi.reader.join(30)
    if wi.reader.is_alive() or wi.process.is_alive():
        raise AssertionError("web: the client or the server process is still running")
    events = seen["events"]
    iterates = [e for e in events if e["_type"] == "STIterate"]
    page = seen.get("page")
    if page is None or page[0] != 200 or not page[1].startswith("text/html"):
        raise AssertionError(f"web: GET / gave {page}")
    if not iterates or events[-1]["_type"] != "WIDone":
        raise AssertionError("web: no STIterate, or WIDone not last")
    if not {(e["w"], e["h"]) for e in iterates} <= set(sizes):
        raise AssertionError("web: an STIterate of a size not on the pyramid")
    if seen.get("image") != (200, "JPEG", tuple(final), True):
        raise AssertionError(f"web: GET /image gave {seen.get('image')}")
    return iterates


def _web_phase(tmp, content_path, style_path):
    """Phase 4's pyramid with ``--web``: a client connected as the server
    starts reads the page, the events and, after WIDone, the image."""
    with _watched_web() as (seen, made):
        its, _, launches = _run_cli(tmp, content_path, style_path, "web",
                                    ["--web", "--host", "127.0.0.1", "--port",
                                     str(_free_port())])
    events = seen["events"]
    print(f"web preview: page {seen.get('page')}, "
          f"{sum(e['_type'] == 'STIterate' for e in events)} STIterate events "
          f"(of {len(its)} iterations; a full queue drops frames), last event "
          f"{events[-1]['_type'] if events else None}, image {seen.get('image')}, "
          f"client errors {seen['errors']}, launches {launches}")
    _check_web(seen, made, PYRAMID, PYRAMID[-1])
    if launches["ns_sqrtm_yz"] != 100:
        raise AssertionError(f"web: launches {launches}")
    ref = _by_scale(json.loads((tmp / "trace_adam-trace.json").read_text())["iterates"])
    for (w, h), s in _by_scale(its).items():
        r = ref[(w, h)]
        print(f"  {w}x{h}: {(s[-1]['time'] - s[0]['time']) / 19 * 1e3:.2f} ms/iter "
              f"with --web, {(r[-1]['time'] - r[0]['time']) / 19 * 1e3:.2f} without "
              "(phase 4)")


def _bf16_phase(tmp, content_path, style_path):
    import numpy as np
    import torch
    from PIL import Image

    from style_transfer_tpu_torch.engine import _pil_to_nchw
    from style_transfer_tpu_torch.models import vgg as V
    from style_transfer_tpu_torch.models.weights import params_from_jax, random_params

    params = params_from_jax(random_params(0), DEVICE)
    with Image.open(content_path) as c:
        image = _pil_to_nchw(c.convert("RGB"), (512, 384), DEVICE)
    taps = (1, 6, 11, 20, 22, 29)
    with torch.no_grad():
        f32 = V.extract_features(params, image, taps)
        bf16 = V.extract_features(V.cast_params(params, torch.bfloat16), image, taps,
                                  compute_dtype=torch.bfloat16)
    errs = {l: ((bf16[l].float() - f32[l]).abs().max() / f32[l].abs().max()).item()
            for l in taps}
    # Free the taps and weights before the CLI run, whose peak memory
    # per scale would otherwise count them.
    del f32, bf16, params, image
    torch.cuda.empty_cache()
    print("bf16 trunk against FP32 at 512x384, max err of max per tap: "
          + ", ".join(f"{l}: {e:.2e}" for l, e in errs.items())
          + f" (limit {BF16_TAP_TOL})")
    if not max(errs.values()) <= BF16_TAP_TOL:
        raise AssertionError("bf16 taps differ from FP32 past the limit")
    _cli_phase(tmp, content_path, style_path, "adam-trace-bf16", ["--precision", "bf16"],
               {"ns_sqrtm_yz": 100, "ns_sqrtm": 0, "lyap_bwd": 0})
    a = _read_png(tmp / "out_adam-trace-bf16.png").astype(np.float64)
    b = _read_png(tmp / "out_adam-trace.png").astype(np.float64)
    mse = np.mean((a - b) ** 2) / 255.0 ** 2
    print(f"bf16 pyramid output against the FP32 one (phase 4): PSNR "
          f"{10 * np.log10(1.0 / max(mse, 1e-12)):.2f} dB, max diff "
          f"{np.abs(a - b).max():.0f}/255")


def _random_lpips_bundle(path, net, seed=0):
    """A random-weight LPIPS bundle in the stt-lpips v1 format (built as the
    JAX package's tests build theirs): He-like convs, a nonnegative head."""
    import numpy as np

    from style_transfer_tpu_torch.utils.lpips import LPIPS_NETS

    rng = np.random.RandomState(seed)
    arrays, cin, j = {}, 3, 0
    for i, (cout, k, _s, _p, _pool, tap) in enumerate(LPIPS_NETS[net]):
        arrays[f"conv{i}_kernel"] = (
            rng.randn(k, k, cin, cout) * (1.5 / np.sqrt(k * k * cin))).astype(np.float32)
        arrays[f"conv{i}_bias"] = (rng.randn(cout) * 0.05).astype(np.float32)
        if tap:
            arrays[f"lin{j}"] = rng.rand(cout).astype(np.float32)
            j += 1
        cin = cout
    arrays["meta"] = np.frombuffer(
        json.dumps({"format": "stt-lpips", "version": 1, "net": net}).encode(), np.uint8)
    np.savez(path, **arrays)
    return path


def _fidelity_phase(tmp):
    """The fidelity modules on the card: the committed fingerprint fixture
    (made by the JAX package's CPU trunk) through the card's FP32 trunk;
    LPIPS with random bundles on the card against the CPU; PSNR, SSIM and
    the perceptual distance of phase 9's bf16 output against phase 4's
    FP32 output."""
    import numpy as np

    from style_transfer_tpu_torch.models import fingerprint as FP
    from style_transfer_tpu_torch.models.weights import params_from_jax, random_params
    from style_transfer_tpu_torch.utils import lpips as LP
    from style_transfer_tpu_torch.utils import metrics as M

    params = random_params(0)
    fixture = FP.load_fingerprint(REPO / "tests" / "fixtures" /
                                  "vgg19_random_he0_fingerprint.json")
    t0 = time.perf_counter()
    problems = FP.check_fingerprint(fixture, params, device=DEVICE)
    secs = time.perf_counter() - t0
    got = FP.activation_stats(params, fixture["taps"], device=DEVICE)
    stat_err = max(abs(got[t][k] - w[k]) / abs(w[k])
                   for t, w in fixture["activations"].items() for k in ("mean", "std", "l2"))
    sample_err = max(abs(g - w) for t, w in fixture["activations"].items()
                     for g, w in zip(got[t]["samples"], w["samples"]))
    print(f"fingerprint of random_params(0) on the card against the committed fixture: "
          f"{len(problems)} problems, max rel stat err {stat_err:.2e} (limit 1e-3), max "
          f"sample err {sample_err:.2e} (limit 5e-3 rel + 1e-4), {secs:.2f} s")
    if problems:
        raise AssertionError(f"fingerprint: {problems}")

    ours = _read_png(tmp / "out_adam-trace-bf16.png") / 255.0
    ref = _read_png(tmp / "out_adam-trace.png") / 255.0
    for net in ("alex", "vgg16"):
        bundle = LP.load_bundle(_random_lpips_bundle(tmp / f"lpips_{net}.npz", net))
        t0 = time.perf_counter()
        card = LP.lpips(ours, ref, bundle, device=DEVICE)
        card_s = time.perf_counter() - t0
        cpu = LP.lpips(ours, ref, bundle, device="cpu")
        rel = abs(card - cpu) / abs(cpu)
        print(f"lpips-{net} (random bundle) of the bf16 against the FP32 pyramid output: "
              f"card {card:.8g} ({card_s:.2f} s), cpu {cpu:.8g}, rel diff {rel:.2e} "
              f"(limit {LPIPS_RTOL})")
        if not rel <= LPIPS_RTOL:
            raise AssertionError(f"lpips-{net}: card and cpu disagree")
    # An explicit path that does not exist resolves no bundle, whatever the
    # machine's default locations hold: the VGG-distance proxy.
    t0 = time.perf_counter()
    dist, kind = M.perceptual_distance(ours, ref, params=params_from_jax(params, DEVICE),
                                       lpips_weights=tmp / "no_bundle.npz", device=DEVICE)
    dist_s = time.perf_counter() - t0
    print(f"bf16 pyramid output against the FP32 one (phase 4), utils/metrics.py: PSNR "
          f"{M.psnr(ours, ref):.4f} dB, SSIM {M.ssim(ours, ref):.6f}, {kind} {dist:.6g} "
          f"(on the card, {dist_s:.2f} s)")
    if kind != "vgg_distance_proxy" or not np.isfinite(dist) or dist <= 0:
        raise AssertionError(f"perceptual distance {dist} ({kind})")


def _sharded_cli(tmp, content_path, style_path, label, flags, world):
    """A CLI run with ``--devices`` naming the card ``world`` times; returns
    (iterates, output path, the trace's per-rank report)."""
    its, out, launches = _run_cli(tmp, content_path, style_path, label,
                                  flags + ["--devices"] + [DEVICE] * world)
    if any(launches.values()):
        raise AssertionError(f"{label}: the launching process ran kernels {launches}")
    ranks = json.loads((tmp / f"trace_{label}.json").read_text())["ranks"]
    for r in ranks:
        print(f"  rank {r['rank']} ({r['device']}, {r['grid'][0]}x{r['grid'][1]}, "
              f"{r['backend']}): launches {r['kernel_launches']}, peak memory "
              f"{r['peak_memory'] / 2**20:.1f} MiB, halo {r['halo_s'] * 1e3 / len(its):.2f} "
              f"ms/iter ({r['halo_calls']} calls), all-reduce "
              f"{r['reduce_s'] * 1e3 / len(its):.2f} ms/iter ({r['reduce_calls']} calls)")
    if [r["rank"] for r in ranks] != list(range(world)):
        raise AssertionError(f"{label}: ranks {[r['rank'] for r in ranks]}")
    return its, out, ranks


def _check_close(label, its, ref_its):
    import numpy as np

    if [(i["w"], i["h"], i["i"]) for i in its] != [(i["w"], i["h"], i["i"]) for i in ref_its]:
        raise AssertionError(f"{label}: iterations differ from the one-device run's")
    _, rel = _rel_diff(its, ref_its)
    by = {}
    for it, ref in zip(its, ref_its):
        by.setdefault((it["w"], it["h"]), []).append(abs(it["loss"] - ref["loss"]) / abs(ref["loss"]))
    print(f"  {label}: max rel loss diff {rel:.3g} (limit "
          f"{SHARDED_RTOL}); per scale " + ", ".join(
              f"{w}x{h}: {max(v):.2e}" for (w, h), v in by.items()))
    if not np.isfinite(rel) or rel > SHARDED_RTOL:
        raise AssertionError(f"{label}: sharded losses differ from one device's")


def _sharded_phase(tmp, content_path, style_path, main_path):
    """Phase 12 (see the module docstring); ``main_path`` is phase 4's
    launches, which each rank of the same pyramid must equal."""
    import numpy as np

    from style_transfer_tpu_torch.parallel.mesh import factor_devices, pick_backend

    for world in (2, 4):
        print(f"sharded runs: world {world}, grid {'x'.join(map(str, factor_devices(world)))}, "
              f"backend {pick_backend([DEVICE] * world)} (ranks share {DEVICE}: function "
              "only, not scaling)")
    trace = lambda label: json.loads((tmp / f"trace_{label}.json").read_text())["iterates"]

    its, out, ranks = _sharded_cli(tmp, content_path, style_path, "sharded-adam-trace", [], 2)
    _check_pyramid(its, out)
    _check_close("2 ranks against phase 4", its, trace("adam-trace"))
    for r in ranks:
        if r["kernel_launches"] != main_path:
            raise AssertionError(f"rank {r['rank']} launches {r['kernel_launches']}, "
                                 f"phase 4 {main_path}")
    a = _read_png(out).astype(np.float64)
    b = _read_png(tmp / "out_adam-trace.png").astype(np.float64)
    mse = np.mean((a - b) ** 2) / 255.0 ** 2
    print(f"  2-rank pyramid output against phase 4's: PSNR "
          f"{10 * np.log10(1.0 / max(mse, 1e-12)):.2f} dB, max diff {np.abs(a - b).max():.0f}/255")

    big = ["--min-scale", str(BIG_SCALE), "--end-scale", str(BIG_SCALE), "-ii", "30",
           "--callback-chunk", "10", "--align", "1"]
    its, _, ranks = _sharded_cli(tmp, content_path, style_path, "sharded-big", big, 2)
    if [(it["w"], it["h"]) for it in its] != [BIG_CANVAS] * 30:
        raise AssertionError("sharded 1448x1086: unexpected iterations")
    plain = trace("big-plain")
    ms, plain_ms = ((t[29]["time"] - t[9]["time"]) / 20 * 1e3 for t in (its, plain))
    print(f"  {BIG_CANVAS[0]}x{BIG_CANVAS[1]} on 2 ranks sharing the card: {ms:.2f} ms/iter "
          f"over iterations 11-30; one device (phase 7, plain): {plain_ms:.2f} ms/iter")
    _check_close("1448x1086 on 2 ranks against phase 7's plain run", its, plain)

    one = ["--min-scale", "512", "--end-scale", "512", "-ii", "20"]
    ref, _, _ = _run_cli(tmp, content_path, style_path, "one-512", one)
    its, _, _ = _sharded_cli(tmp, content_path, style_path, "sharded-512-2x2", one, 4)
    _check_close("4 ranks (2x2) at 512x384", its, ref)

    # 10 iterations a scale: past about 12, the reference L-BFGS from the
    # gray init is not determined to float32 precision (on the CPU at 64x48,
    # one thread against four parts its iteration 13 by 27%; ROADMAP C).
    lyap = ["--optimizer", "lbfgs", "--w2-grad", "lyap", "--init", "gray",
            "--end-scale", "256", "-i", "10", "-ii", "10"]
    ref, _, expect = _run_cli(tmp, content_path, style_path, "one-lbfgs-lyap", lyap)
    its, _, ranks = _sharded_cli(tmp, content_path, style_path, "sharded-lbfgs-lyap", lyap, 2)
    _check_close("(lbfgs, lyap) from the gray init on 2 ranks", its, ref)
    print(f"  one-device launches {expect}")
    if (DEVICE != "cpu" and expect["ns_sqrtm"] != 120) or any(
            r["kernel_launches"] != expect for r in ranks):
        raise AssertionError(f"(lbfgs, lyap) rank launches differ from one device's {expect}")
    _sharded_stop_leg(tmp, content_path, style_path)


def _sharded_stop_leg(tmp, content_path, style_path):
    """Phase 12's stop leg: the CLI as a subprocess in its own session on 2
    ranks sharing the card, phase 4's pyramid with checkpoints every 10
    iterations (chunks of 10), and SIGINT to its process group once the
    third scale's first checkpoint exists, as a terminal's Ctrl-C does. It
    must exit 0 within 60 s with the output and the trace (with ``ranks``),
    stopped after a chunk; ``--resume`` on 2 ranks runs the rest, whose
    losses equal phase 12's first leg (same pyramid, 2 ranks) and whose
    ranks launch B1 4 times per resumed iteration."""
    import os
    import signal

    from style_transfer_tpu_torch.models.weights import random_params, save_params
    from style_transfer_tpu_torch.utils.checkpoint import load_checkpoint

    weights = tmp / "vgg19_random0.npz"
    if not weights.is_file():
        save_params(random_params(0), weights)
    ck, out, trace = tmp / "ck_stop.npz", tmp / "out_stop.png", tmp / "trace_stop.json"
    run = ["--min-scale", "128", "--end-scale", "512", "-i", "20", "-ii", "20",
           "--checkpoint", str(ck), "--checkpoint-every", "10", "--callback-chunk", "10"]
    argv = [sys.executable, "-m", "style_transfer_tpu_torch.cli", str(content_path),
            str(style_path), "--vgg-weights", str(weights), "--devices", DEVICE, DEVICE,
            "-o", str(out), "--trace", str(trace), *run]
    log = tmp / "stop_cli.log"
    with open(log, "w") as fp:
        proc = subprocess.Popen(argv, cwd=tmp, env=dict(os.environ, PYTHONPATH=str(REPO)),
                                start_new_session=True, stdout=fp, stderr=subprocess.STDOUT)
    try:
        t0, scale_index = time.monotonic(), -1
        while proc.poll() is None and time.monotonic() - t0 < 300:
            if ck.is_file():
                scale_index = load_checkpoint(ck)["scale_index"]
                if scale_index >= 2:
                    break
            time.sleep(0.05)
        if scale_index < 2:
            raise AssertionError(f"stop leg: no checkpoint of the third scale (exit "
                                 f"{proc.poll()}): {log.read_text()[-2000:]}")
        os.killpg(proc.pid, signal.SIGINT)
        t_sig = time.monotonic()
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            raise AssertionError("stop leg: the run did not end within 60 s of SIGINT")
        secs = time.monotonic() - t_sig
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if rc != 0:
        raise AssertionError(f"stop leg: exit {rc}: {log.read_text()[-2000:]}")
    t = json.loads(trace.read_text())
    its, ranks = t["iterates"], t.get("ranks")
    last = its[-1]
    print(f"  SIGINT to the 2-rank pyramid at scale 3's first checkpoint: exit {rc} "
          f"{secs:.2f} s after the signal, {len(its)} iterations, last "
          f"{last['w']}x{last['h']} iteration {last['i']}, ranks "
          f"{[r['rank'] for r in ranks or []]}, output {out.is_file()}")
    if [r["rank"] for r in ranks or []] != [0, 1] or not out.is_file():
        raise AssertionError("stop leg: no output or no ranks report")
    if len(its) >= 100 or last["i"] % 10:
        raise AssertionError("stop leg: the run did not stop after a chunk before its end")
    resumed, _, rank_list = _sharded_cli(tmp, content_path, style_path, "stop-resumed",
                                         run + ["--resume"], 2)
    ref = json.loads((tmp / "trace_sharded-adam-trace.json").read_text())["iterates"]
    ref = ref[len(ref) - len(resumed):]
    _check_close("the resumed 2-rank pyramid against phase 12's first leg", resumed, ref)
    expect = {"ns_sqrtm_yz": len(resumed), "ns_sqrtm": 0, "lyap_bwd": 0}
    if DEVICE != "cpu" and any(r["kernel_launches"] != expect for r in rank_list):
        raise AssertionError(f"stop leg: resumed rank launches differ from {expect}")
    print(f"  resumed from {resumed[0]['w']}x{resumed[0]['h']} iteration "
          f"{resumed[0]['i']}: {len(resumed)} iterations, B1 launches per rank "
          f"{[r['kernel_launches']['ns_sqrtm_yz'] for r in rank_list]} (expected "
          f"{expect['ns_sqrtm_yz']})")


def _ms_last5(scale_its):
    """ms/iter over a scale's last 5 iterations: its last chunk of 5, timed
    from the previous chunk's sync (``--callback-chunk 5``)."""
    return (scale_its[-1]["time"] - scale_its[-6]["time"]) / 5 * 1e3


def _check_tiff16(path, size):
    """A 16-bit RGB TIFF of ``size`` (w, h) with the sRGB profile: the file
    must be, byte for byte, what the port's ``io_color`` encodes for the
    pixels it holds. Returns the share of samples that an 8-bit image
    could not hold (not a multiple of 257)."""
    import numpy as np

    from style_transfer_tpu_torch import io_color, srgb_profile

    data = Path(path).read_bytes()
    w, h = size
    if data[:4] != b"II*\x00" or len(data) < 8 + w * h * 6:
        raise AssertionError(f"{path}: not a {w}x{h} 16-bit little-endian TIFF")
    pixels = np.frombuffer(data, "<u2", count=w * h * 3, offset=8).reshape(h, w, 3)
    if io_color.encode_tiff_rgb16(pixels.copy(), icc_profile=srgb_profile) != data:
        raise AssertionError(f"{path}: not the port's 16-bit sRGB TIFF of {w}x{h}")
    if pixels.std() == 0:
        raise AssertionError(f"{path}: constant image")
    return float((pixels % 257 != 0).mean())


def _print_phase(tmp, content_path, style_path):
    """Phase 13 (see the module docstring)."""
    sizes = PRINT_PYRAMID
    w, h = sizes[-1]
    chunk = ["--callback-chunk", "5"]
    tif = tmp / "out_print.tif"
    with _watched_web() as (seen, made):
        its, _, launches = _run_cli(
            tmp, content_path, style_path, "print-pyramid",
            ["--end-scale", str(PRINT_SCALE), "-i", "10", "-ii", "10", *chunk, "-o",
             str(tif), "--web", "--host", "127.0.0.1", "--port", str(_free_port())])
    _check_pyramid(its, None, sizes, iters=10)
    deep = _check_tiff16(tif, (w, h))
    iterates = _check_web(seen, made, sizes, (w, h))
    at_print = sum((e["w"], e["h"]) == (w, h) for e in iterates)
    by = _by_scale(its)
    prev, top = by[sizes[-2]], by[(w, h)]
    # Inside a chunk the iterates' times are interpolated from its start:
    # the 2896 scale's first chunk started at 2 t_1 - t_2.
    entry = 2 * top[0]["time"] - top[1]["time"] - prev[-1]["time"]
    print(f"print pyramid to {w}x{h}: {len(its)} iterations over {len(sizes)} scales; "
          f"TIFF {w}x{h}, 16 bits with the sRGB profile, {deep:.1%} of samples "
          f"beyond 8 bits; web: {at_print} STIterate events of {w}x{h}, image "
          f"{seen.get('image')}, client errors {seen['errors']}; launches {launches}")
    for size in sizes[-2:]:
        print(f"  {size[0]}x{size[1]} (--web, FP32): {_ms_last5(by[size]):.2f} ms/iter "
              "over its last 5 iterations")
    print(f"  {w}x{h} scale entry (from the last iterate of {prev[0]['w']}x"
          f"{prev[0]['h']} to the first chunk's start): {entry:.3f} s")
    if not at_print:
        raise AssertionError(f"print pyramid: the client saw no event of {w}x{h}")
    if DEVICE != "cpu" and launches != {"ns_sqrtm_yz": 100, "ns_sqrtm": 0, "lyap_bwd": 0}:
        raise AssertionError(f"print pyramid: launches {launches}")

    one = ["--min-scale", str(PRINT_SCALE), "--end-scale", str(PRINT_SCALE), "-ii", "10",
           "--align", "1", *chunk]
    legs = {}
    for label, flags in (("print-f32", []), ("print-bf16", ["--precision", "bf16"])):
        legs[label], _, launches = _run_cli(tmp, content_path, style_path, label,
                                            one + flags)
        _check_pyramid(legs[label], None, [(w, h)], iters=10)
        if DEVICE != "cpu" and launches["ns_sqrtm_yz"] != 10:
            raise AssertionError(f"{label}: launches {launches}")
    sharded, _, ranks = _sharded_cli(tmp, content_path, style_path, "sharded-print", one, 2)
    _check_close(f"{w}x{h} on 2 ranks against one device", sharded, legs["print-f32"])
    for r in ranks:
        if DEVICE != "cpu" and r["kernel_launches"] != {"ns_sqrtm_yz": 10, "ns_sqrtm": 0,
                                                        "lyap_bwd": 0}:
            raise AssertionError(f"sharded print: rank launches {r['kernel_launches']}")
    def peak(scale_its):
        return max(i["gpu_ram"] for i in scale_its) / 2**20

    f32, bf16 = legs["print-f32"], legs["print-bf16"]
    rank_peaks = ", ".join(f"{r['peak_memory'] / 2**20:.1f}" for r in ranks)
    print(f"  {w}x{h} alone, over its last 5 iterations: FP32 {_ms_last5(f32):.2f} "
          f"ms/iter (peak {peak(f32):.1f} MiB), bf16 {_ms_last5(bf16):.2f} ms/iter (peak "
          f"{peak(bf16):.1f} MiB), 2 ranks sharing the card {_ms_last5(sharded):.2f} "
          f"ms/iter (rank peaks {rank_peaks} MiB); in the pyramid, FP32 with --web, "
          f"{_ms_last5(top):.2f} ms/iter, peak {peak(top):.1f} MiB")
    return legs


def _more_styles(tmp):
    """Two more blocky style images, made as ``_images`` makes its style,
    from other seeds and at other sizes (384x320, 256x448)."""
    import numpy as np
    from PIL import Image

    paths = []
    for seed, (bh, bw) in ((1, (40, 48)), (2, (56, 32))):
        style = np.random.RandomState(seed).randint(0, 255, (bh, bw, 3)).astype(np.float64)
        paths.append(tmp / f"style{seed}.png")
        Image.fromarray(np.kron(style, np.ones((8, 8, 1))).astype(np.uint8)).save(paths[-1])
    return paths


def _configs_phase(tmp, content_path, style_path):
    """Phase 14 (see the module docstring)."""
    import numpy as np
    from PIL import Image

    from style_transfer_tpu_torch import StyleTransfer
    from style_transfer_tpu_torch.models.weights import random_params
    from style_transfer_tpu_torch.utils.scales import align_size

    styles = [style_path, *_more_styles(tmp)]
    blend = dict(style_weights=[2, -1, 1], content_weight=0.15, tv_weight=20)
    params = random_params(0)
    for label, engine_kw, stylize_kw, n_styles in (
            ("average", {"pooling": "average"}, {}, 1),
            ("l2, scaled", {"pooling": "l2", "content_loss": "scaled"}, {}, 1),
            ("gram, style_stats", {"style_loss": "gram"}, {"init": "style_stats"}, 1),
            ("3 styles [2, -1, 1]", {}, blend, 3)):
        losses = []
        for device in ("cuda:0", "cpu"):
            st = StyleTransfer(device=device, weights=params, callback_chunk=10, **engine_kw)
            its = []
            images = [Image.open(p).convert("RGB") for p in styles[:n_styles]]
            with Image.open(content_path) as c:
                st.stylize(c.convert("RGB"), images, min_scale=128, end_scale=128,
                           iterations=10, initial_iterations=10, callback=its.append,
                           **stylize_kw)
            losses.append(np.array([i.loss for i in its]))
        card, cpu = losses
        rel = np.abs(card - cpu) / np.abs(cpu)
        print(f"card vs cpu [{label}] at 128 px, 10 iterations: max rel loss diff "
              f"{rel.max():.2e} (limit {CPU_RTOL}); first/last loss card "
              f"{card[0]:.7g}/{card[-1]:.7g}, cpu {cpu[0]:.7g}/{cpu[-1]:.7g}")
        if len(card) != 10 or not (rel <= CPU_RTOL).all():
            raise AssertionError(f"card and cpu losses disagree [{label}]")

    w2 = {"ns_sqrtm_yz": 100, "ns_sqrtm": 0, "lyap_bwd": 0}
    aligned = [align_size(size, 8) for size in PYRAMID]
    for label, flags, expect, sizes in (
            ("average", ["--pooling", "average"], w2, PYRAMID),
            ("l2-scaled", ["--pooling", "l2", "--content-loss", "scaled"], w2, PYRAMID),
            ("gram-stats", ["--style-loss", "gram", "--init", "style_stats",
                            "--style-scale-fac", "0.7", "--align", "8"],
             {"ns_sqrtm_yz": 0, "ns_sqrtm": 0, "lyap_bwd": 0}, aligned),
            ("style-size", ["--style-size", "256"], w2, PYRAMID),
            ("three-styles", ["--style-weights", "2", "-1", "1", "--content-weight",
                              "0.15", "--tv-weight", "20"], w2, PYRAMID)):
        _cli_phase(tmp, content_path, styles if label == "three-styles" else style_path,
                   f"config-{label}", flags, expect, sizes)


def _tools_phase():
    """Phase 15 (see the module docstring)."""
    import bench_pyramid_torch
    import profile_step_torch

    from style_transfer_tpu_torch import bench

    _reset_launch_counts()
    rec = bench_pyramid_torch.run(PYRAMID[-1][0], device=DEVICE, label="chip_smoke")
    launches = _launch_counts()
    print(f"bench_pyramid_torch {PYRAMID[-1][0]} (FP32): {json.dumps(rec)}")
    iters = [s["iters"] for s in rec["scales"].values()]
    timed = sum(rec["phases"].values()) + rec["untimed"]
    print(f"  phases + untimed {timed:.2f} s against the wall {rec['value']:.2f} s; "
          f"launches {launches}")
    if list(rec["scales"]) != [f"{w}x{h}" for w, h in PYRAMID] or iters != [
            1000] + [500] * (len(PYRAMID) - 1):
        raise AssertionError(f"pyramid bench: scales and iterations {rec['scales']}")
    if abs(timed - rec["value"]) > 0.05:
        raise AssertionError("pyramid bench: phases + untimed differ from the wall")
    if not 0 <= rec["overhead_wall"] < rec["value"]:
        raise AssertionError(f"pyramid bench: overhead_wall {rec['overhead_wall']}")
    if DEVICE != "cpu" and launches != {"ns_sqrtm_yz": sum(iters), "ns_sqrtm": 0,
                                        "lyap_bwd": 0}:
        raise AssertionError(f"pyramid bench: launches {launches}")

    for precision, w2_grad in (("f32", "trace"), ("bf16", "trace"), ("f32", "lyap")):
        bench.main(["--device", DEVICE, "--precision", precision, "--w2-grad", w2_grad])

    prof = profile_step_torch.profile(384, 512, device=DEVICE)
    if prof is None:
        raise AssertionError("profile_step_torch: the profiler saw no device kernel")
    total, summed = prof["kernel_ms_per_iter"], sum(prof["buckets"].values())
    print(json.dumps({"profile": "384x512 f32", "kernel_ms_per_iter": total,
                      "busy": prof["busy"], "buckets": prof["buckets"],
                      "sources": prof["sources"][:15]}))
    if abs(summed - total) > 0.01 * total:
        raise AssertionError(f"profile: buckets sum to {summed} of {total} ms/iter")


GRAPH_SIZES = [(96, 128), (384, 512), BIG_CANVAS[::-1]]  # (h, w)
GRAPH_ITERS = 20
# Under cuDNN's default algorithms two eager runs of the reference L-BFGS
# part as its trajectory magnifies the algorithms' rounding. From a noisy
# init (bench.build_step's uniform draw) its first step is tiny, so the
# first curvature pair's y = g1 - g0 and h_diag = ys / yy carry that
# rounding (ROADMAP C): two eager runs can part by more than CPU_RTOL
# within 10 iterations (tools/lbfgs_determinacy_torch.py). Its leg
# therefore starts from the gray init, as phases 3 and 12 and the engine
# tests do, where the trajectory is determined for about 12 iterations;
# the bar covers the first 10 (the horizon of phases 3 and 12) and the
# deterministic leg holds all 20 bit for bit. The zoom L-BFGS from the gray
# init is determined less far: under the default algorithms two eager runs
# of it agree within 1e-4 for its first ZOOM_DETERMINED iterations and
# then, at 128x96, jump to up to 1e-3 within an iteration or two
# (tools/lbfgs_determinacy_torch.py optimizer=lbfgs-zoom, on an H100), so a
# graph-against-eager reading past that horizon is a draw of cuDNN's
# rounding, magnified, and not of the graph. Its legs are held at CPU_RTOL
# over those iterations; the deterministic leg holds all 20, with every
# line search, bit for bit.
LBFGS_DETERMINED = 10
ZOOM_DETERMINED = 7


@contextlib.contextmanager
def _plain_ls_step():
    """The zoom line search steps its state with the plain version of the
    step (``ls_step_plain_``, one ATen launch per operation) in place of
    the kernel, for a comparison of the two inside the trial graph."""
    from style_transfer_tpu_torch import zoom_lbfgs as Z
    from style_transfer_tpu_torch.ops.cuda import zoom_ls as ZL

    Z.ls_step_ = ZL.ls_step_plain_
    try:
        yield
    finally:
        Z.ls_step_ = ZL.ls_step_


def _run_timed(run, params, consts, state):
    """GRAPH_ITERS iterations as a chunk of 5 (a graph runner's warm-up
    iteration and capture in it) and a timed chunk of the rest. Returns
    (final state, losses as float64, ms/iter of the timed chunk, peak MiB,
    kernel launches over the timed chunk (the line-search step's as
    ``zoom_ls_step``), the line-search evaluations of every iteration
    (lbfgs-zoom; else None))."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _linesearch_counts() as steps:
        state, first = run(params, consts, state, 5)
        first = first.cpu()
        _reset_launch_counts()
        t0 = time.perf_counter()
        state, rest = run(params, consts, state, GRAPH_ITERS - 5)
        rest = rest.cpu()
        ms = (time.perf_counter() - t0) / (GRAPH_ITERS - 5) * 1e3
    launches = dict(_launch_counts(), zoom_ls_step=_ls_launches())
    peak = torch.cuda.max_memory_allocated() / 2**20
    losses = torch.cat([first, rest]).numpy().astype(np.float64)
    return state, losses, ms, peak, launches, steps or None


def _check_zoom_launches(label, launches, steps):
    """Over the timed chunk (iterations 6-20): the NS kernels of the path (B1
    once per loss evaluation, or B2 and B3 once per group and evaluation)
    launched, the others never, and the line-search step once per trial.
    Returns the evaluations per iteration."""
    trials = sum(steps[5:])
    evals = GRAPH_ITERS - 5 + trials
    ns = sorted(launches[k] for k in KERNELS)
    if ns not in ([0, 0, evals], [0, 4 * evals, 4 * evals]) or (
            launches["zoom_ls_step"] != trials):
        raise AssertionError(f"{label}: launches {launches} for {evals} loss evaluations "
                             f"and {trials} trials")
    return evals / (GRAPH_ITERS - 5)


def _graph_phase():
    """Phase 16 (see the module docstring)."""
    import numpy as np
    import profile_step_torch
    import torch
    from lbfgs_determinacy_torch import gray_start

    from style_transfer_tpu_torch import step as S
    from style_transfer_tpu_torch.bench import build_step

    device = torch.device(DEVICE)
    legs = [(opt, grad, prec, GRAPH_SIZES) for opt, grad, prec in (
        ("adam", "trace", "f32"), ("adam", "lyap", "f32"), ("lbfgs", "lyap", "f32"),
        ("lbfgs-zoom", "trace", "f32"), ("adam", "trace", "bf16"))]
    legs.append(("lbfgs-zoom", "lyap", "f32", [(384, 512)]))
    for optimizer, w2_grad, precision, sizes in legs:
        for h, w in sizes:
            label = f"({optimizer}, {w2_grad}, {precision}) at {w}x{h}"
            graph = params = consts = state0 = None
            graph, params, consts, state0 = build_step(
                h, w, device=device, optimizer=optimizer, w2_grad=w2_grad,
                compute_dtype=precision)
            lbfgs = optimizer != "adam"
            if lbfgs:
                state0 = gray_start(state0, optimizer)
            eager = S.OPTIMIZERS[optimizer].runner(graph.cfg, eager=True)
            # cuDNN's default algorithms: agreement within CPU_RTOL, timings.
            g_state, g_loss, g_ms, g_peak, g_launch, g_steps = _run_timed(
                graph, params, consts, state0)
            e_state, e_loss, e_ms, e_peak, e_launch, e_steps = _run_timed(
                eager, params, consts, state0)
            e2_loss = _run_timed(eager, params, consts, state0)[1]
            capture = graph.run.capture_seconds
            capture = "none (eager)" if capture is None else f"{capture:.3f} s"
            rel_all = np.abs(g_loss - e_loss) / np.abs(e_loss)
            held = {"adam": GRAPH_ITERS, "lbfgs": LBFGS_DETERMINED,
                    "lbfgs-zoom": ZOOM_DETERMINED}[optimizer]
            rel = float(rel_all[:held].max())
            spread_all = np.abs(e2_loss - e_loss) / np.abs(e_loss)
            spread = float(spread_all.max())
            plain = ""
            if optimizer == "lbfgs-zoom" and w2_grad == "trace":
                with _plain_ls_step():
                    _, p_loss, p_ms, _, _, _ = _run_timed(make(graph.cfg), params, consts,
                                                          state0)
                if not np.isfinite(p_loss).all():
                    raise AssertionError(f"{label}: non-finite loss with the plain step")
                plain = (f"; with the plain line-search step in the trial graph "
                         f"{p_ms:.2f} ms/iter (the kernel's {g_ms:.2f})")
            img = (g_state.image - e_state.image).abs().max().item()
            _, prof = profile_step_torch.profile_runner(graph, params, consts, g_state, 5,
                                                        device)
            busy = (f"{prof['busy']:.2f} ({prof['busy_profiled']:.2f} of the profiled "
                    "run's wall)" if prof else "not measured")
            g_state = e_state = None
            # cuDNN's deterministic algorithms: bit for bit, graphs captured
            # under them against the eager runner under them.
            torch.backends.cudnn.deterministic = True
            try:
                det = make(graph.cfg)
                d_state, d_loss, _, _, d_launch, d_steps = _run_timed(
                    det, params, consts, state0)
                x_state, x_loss, _, _, x_launch, x_steps = _run_timed(
                    eager, params, consts, state0)
            finally:
                torch.backends.cudnn.deterministic = False
            same = (bool((d_loss == x_loss).all()) and torch.equal(d_state.image, x_state.image)
                    and d_steps == x_steps)
            zoom = ""
            if optimizer == "lbfgs-zoom":
                evals = [_check_zoom_launches(f"{label} {run}", launch, steps)
                         for run, launch, steps in (("graph", g_launch, g_steps),
                                                    ("eager", e_launch, e_steps),
                                                    ("deterministic graph", d_launch, d_steps),
                                                    ("deterministic eager", x_launch, x_steps))]
                zoom = (f"; line-search evaluations per iteration graph {g_steps}, eager "
                        f"{e_steps}; loss evaluations per iteration over the timed chunk "
                        f"graph {evals[0]:.2f}, eager {evals[1]:.2f}")
            print(f"graph against eager {label}: ms/iter graph {g_ms:.2f}, eager {e_ms:.2f} "
                  f"(x{e_ms / g_ms:.2f}); busy share of the graph runner {busy}; capture "
                  f"and instantiate {capture}; peak MiB graph {g_peak:.1f}, eager "
                  f"{e_peak:.1f}; launches over the timed {GRAPH_ITERS - 5} iterations "
                  f"graph {g_launch}, eager {e_launch}; default algorithms: max rel loss diff {rel:.2e} over "
                  f"iterations 1-{held} (limit {CPU_RTOL}), {rel_all.max():.2e} over all "
                  f"{GRAPH_ITERS}, two eager runs {spread:.2e}, image max diff {img:.2e}; "
                  f"deterministic: bit-identical losses, image and line searches {same}"
                  f"{zoom}{plain}")
            if lbfgs:
                print("  rel loss diff per iteration, graph against eager: "
                      + " ".join(f"{r:.1e}" for r in rel_all))
                print("  rel loss diff per iteration, eager against eager: "
                      + " ".join(f"{r:.1e}" for r in spread_all))
            if rel > CPU_RTOL:
                raise AssertionError(f"{label}: graph and eager losses disagree")
            if not same:
                raise AssertionError(f"{label}: not bit-identical under deterministic cuDNN")
            if d_launch != x_launch or (g_steps == e_steps and g_launch != e_launch):
                raise AssertionError(f"{label}: launches differ")
            if not np.isfinite(g_loss).all():
                raise AssertionError(f"{label}: non-finite loss")
            graph = eager = det = d_state = x_state = None


# Phase 17: (a) bench.build_step's (adam, trace) step with and without remat
# at these (h, w), the first also bit for bit under deterministic cuDNN.
REMAT_SIZES = [(384, 512), (1086, 1448)]
# (c): a canvas that the FP32 step without remat cannot hold and with remat
# can, with a margin each way: 8192x6144 from the 640x480 content (50.3
# Mpx; relu1_1 holds about 3.2e9 elements, past 2^31). First the trunk's
# full-resolution ops past 2^31 elements are held against the same ops on
# halves (tools/large_conv_probe_torch.py, at 8192x6144). 3 iterations:
# the fewest from which ms/iter over iterations 3 and up is defined.
REMAT_BIG = 8192
REMAT_BIG_ITERS = 3
OOM_MESSAGES = ("torch.OutOfMemoryError", "CUDA out of memory")


def _peak_mib(its):
    return max(i["gpu_ram"] for i in its) / 2**20


def _trace_remat(tmp, label):
    """The ``remat`` record of a CLI run's trace: one entry per scale."""
    return json.loads((tmp / f"trace_{label}.json").read_text())["remat"]


def _remat_same_numbers():
    """Phase 17 (a): the graphed step with remat against without, under
    cuDNN's default algorithms (within CPU_RTOL, ms/iter of each) and at
    REMAT_SIZES[0] under its deterministic algorithms (losses and image bit
    for bit)."""
    import numpy as np
    import torch

    from style_transfer_tpu_torch.bench import build_step

    device = torch.device(DEVICE)

    def run(h, w, remat):
        runner, params, consts, state0 = build_step(h, w, device=device, remat=remat)
        state, losses, ms, peak, launches, _ = _run_timed(runner, params, consts, state0)
        if DEVICE != "cpu" and launches["ns_sqrtm_yz"] != GRAPH_ITERS - 5:
            raise AssertionError(f"remat={remat} at {w}x{h}: launches {launches}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"remat={remat} at {w}x{h}: non-finite loss")
        return state.image, losses, ms, peak

    for i, (h, w) in enumerate(REMAT_SIZES):
        _, off, off_ms, off_peak = run(h, w, False)
        _, on, on_ms, on_peak = run(h, w, True)
        rel = float((np.abs(on - off) / np.abs(off)).max())
        same = ""
        if i == 0:
            torch.backends.cudnn.deterministic = True
            try:
                d_off, l_off = run(h, w, False)[:2]
                d_on, l_on = run(h, w, True)[:2]
            finally:
                torch.backends.cudnn.deterministic = False
            bits = bool((l_on == l_off).all()) and torch.equal(d_on, d_off)
            same = f"; deterministic cuDNN: losses and image bit-identical {bits}"
            if not bits:
                raise AssertionError(f"remat at {w}x{h}: not bit-identical under "
                                     "deterministic cuDNN")
        print(f"remat against none at {w}x{h} (graph replays, {GRAPH_ITERS} iterations): "
              f"ms/iter {on_ms:.2f} against {off_ms:.2f} (x{on_ms / off_ms:.3f}), peak MiB "
              f"{on_peak:.1f} against {off_peak:.1f}; default algorithms: max rel loss "
              f"diff {rel:.2e} (limit {CPU_RTOL}){same}")
        if rel > CPU_RTOL:
            raise AssertionError(f"remat at {w}x{h}: losses disagree")


def _remat_print_legs(tmp, content_path, style_path, print_legs):
    """Phase 17 (b): phase 13's one-scale 2896x2172 legs with ``--remat on``
    against phase 13's own, which ``--remat auto`` ran without remat."""
    import numpy as np

    w, h = PRINT_PYRAMID[-1]
    one = ["--min-scale", str(PRINT_SCALE), "--end-scale", str(PRINT_SCALE), "-ii", "10",
           "--align", "1", "--callback-chunk", "5"]
    for label, flags in (("print-f32", []), ("print-bf16", ["--precision", "bf16"])):
        ref = print_legs[label]
        if [r["remat"] for r in _trace_remat(tmp, label)] != [False]:
            raise AssertionError(f"{label}: --remat auto rematerialised at {w}x{h}")
        its, _, launches = _run_cli(tmp, content_path, style_path, f"{label}-remat",
                                    one + flags + ["--remat", "on"])
        _check_pyramid(its, None, [(w, h)], iters=10)
        if [r["remat"] for r in _trace_remat(tmp, f"{label}-remat")] != [True]:
            raise AssertionError(f"{label}: --remat on did not rematerialise")
        if DEVICE != "cpu" and launches["ns_sqrtm_yz"] != 10:
            raise AssertionError(f"{label} --remat on: launches {launches}")
        losses = np.array([i["loss"] for i in its])
        ref_losses = np.array([i["loss"] for i in ref])
        rel = float((np.abs(losses - ref_losses) / np.abs(ref_losses)).max())
        on, off = _peak_mib(its), _peak_mib(ref)
        print(f"  {w}x{h} {label[6:].upper()} --remat on: {_ms_last5(its):.2f} ms/iter "
              f"against {_ms_last5(ref):.2f} without (x{_ms_last5(its) / _ms_last5(ref):.3f}); "
              f"peak {on:.1f} MiB against {off:.1f} ({on * 2**20 / (w * h):.0f} against "
              f"{off * 2**20 / (w * h):.0f} bytes per pixel); max rel loss diff {rel:.2e} "
              f"(limit {CPU_RTOL}); B1 launches {launches['ns_sqrtm_yz']}")
        if rel > CPU_RTOL:
            raise AssertionError(f"{label} --remat on: losses disagree with phase 13's")
        if DEVICE != "cpu" and not on < off:
            raise AssertionError(f"{label} --remat on: peak {on:.1f} MiB not below {off:.1f}")


def _cli_process(tmp, content_path, style_path, label, flags):
    """The CLI on DEVICE as a subprocess of its own (a fresh process, its
    memory the run's own), phase 4's images and weights, output
    and trace named by ``label``. Returns (the finished process, seconds)."""
    import os

    argv = [sys.executable, "-m", "style_transfer_tpu_torch.cli", str(content_path),
            str(style_path), "--vgg-weights", str(tmp / "vgg19_random0.npz"), "--devices",
            DEVICE, "-o", str(tmp / f"out_{label}.png"), "--trace",
            str(tmp / f"trace_{label}.json"), *flags]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=tmp, env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=900)
    return proc, time.perf_counter() - t0


def _remat_big_canvas(tmp, content_path, style_path):
    """Phase 17 (c): the large-tensor probe must pass; then at REMAT_BIG's
    canvas the CLI (subprocesses) with ``--remat off`` must end in CUDA's
    out-of-memory error, and with ``--remat auto`` choose remat and run
    REMAT_BIG_ITERS iterations to finite losses, B1 launched 4 times each
    (the trace's ``kernel_launches``)."""
    import gc

    import numpy as np
    import torch

    from large_conv_probe_torch import LARGE_CONV_WARNING

    gc.collect()
    torch.cuda.empty_cache()
    probe = subprocess.run(
        [sys.executable, str(REPO / "tools" / "large_conv_probe_torch.py"), "6144", "8192"],
        capture_output=True, text=True, timeout=300)
    lines = probe.stdout.strip().splitlines()
    print(f"  large-tensor probe at 8192x6144 (1 x 64 x 6144 x 8192, FP32): exit "
          f"{probe.returncode}, {lines[-1] if lines else probe.stderr[-1500:]}")
    if probe.returncode != 0:
        raise AssertionError("the card does not run the trunk's ops past 2^31 elements")
    flags = ["--min-scale", str(REMAT_BIG), "--end-scale", str(REMAT_BIG), "-ii",
             str(REMAT_BIG_ITERS), "--align", "1", "--callback-chunk", "1"]
    off, secs = _cli_process(tmp, content_path, style_path, "remat-off-big",
                             flags + ["--remat", "off"])
    oom = off.returncode != 0 and any(m in off.stderr for m in OOM_MESSAGES)
    print(f"  --remat off at --end-scale {REMAT_BIG}: exit {off.returncode} in {secs:.1f} s, "
          f"out of memory {oom}")
    if not oom:
        raise AssertionError(f"--remat off at {REMAT_BIG}: not CUDA's out-of-memory error: "
                             f"{off.stderr[-2000:]}")
    auto, secs = _cli_process(tmp, content_path, style_path, "remat-auto-big",
                              flags + ["--remat", "auto"])
    if auto.returncode != 0:
        raise AssertionError(f"--remat auto at {REMAT_BIG}: exit {auto.returncode}: "
                             f"{auto.stderr[-3000:]}")
    trace = json.loads((tmp / "trace_remat-auto-big.json").read_text())
    (rec,), its, launches = trace["remat"], trace["iterates"], trace["kernel_launches"]
    cw, ch = rec["w"], rec["h"]
    losses = np.array([i["loss"] for i in its])
    ms = (its[-1]["time"] - its[1]["time"]) / (len(its) - 2) * 1e3
    predicted = rec["predicted_peak_mib"]
    predicted = "none (the CPU's rule)" if predicted is None else f"{predicted:.0f} MiB"
    print(f"  --remat auto at {cw}x{ch} ({cw * ch / 1e6:.1f} Mpx; relu1_1 holds "
          f"{64 * cw * ch} elements, over 2^31 {64 * cw * ch > 2**31}), {secs:.1f} s: "
          f"remat {rec['remat']}, predicted peak without {predicted}, peak "
          f"{_peak_mib(its):.1f} MiB ({_peak_mib(its) * 2**20 / (cw * ch):.0f} bytes per "
          f"pixel), {ms:.2f} ms/iter over iterations 3-{len(its)}, losses "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}; launches {launches}; cuDNN refused a "
          f"large convolution {LARGE_CONV_WARNING in auto.stderr}")
    if not rec["remat"]:
        raise AssertionError(f"--remat auto did not rematerialise at {cw}x{ch}")
    if len(its) != REMAT_BIG_ITERS or not np.isfinite(losses).all():
        raise AssertionError(f"--remat auto at {cw}x{ch}: iterates {losses}")
    if DEVICE != "cpu" and launches["ns_sqrtm_yz"] != REMAT_BIG_ITERS:
        raise AssertionError(f"--remat auto at {cw}x{ch}: launches {launches}")


def _remat_phase(tmp, content_path, style_path, print_legs):
    """Phase 17 (see the module docstring)."""
    t0 = time.perf_counter()
    _remat_same_numbers()
    _remat_print_legs(tmp, content_path, style_path, print_legs)
    _remat_big_canvas(tmp, content_path, style_path)
    print(f"phase 17 (remat on the card) took {time.perf_counter() - t0:.1f} s")


def main():
    if not (REPO / "style_transfer_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: style_transfer_tpu_torch not found beside this "
              "script; run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
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
        phase = "kernels against plain versions"
        stats = _kernel_phase()
        ls_stats = _ls_phase(torch.device("cuda", 0))
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            content_path, style_path = _images(tmp)
            phase = "card against CPU"
            _card_vs_cpu_phase(content_path, style_path)
            phase = "main path through the CLI"
            main_path = _cli_phase(tmp, content_path, style_path, "adam-trace", [],
                                   {"ns_sqrtm_yz": 100, "ns_sqrtm": 0, "lyap_bwd": 0})
            phase = "reference-flavour path through the CLI"
            lyap_path = {"ns_sqrtm_yz": 0, "ns_sqrtm": 400, "lyap_bwd": 400}
            lyap_run = _cli_phase(tmp, content_path, style_path, "adam-lyap",
                                  ["--w2-grad", "lyap"], lyap_path)
            _cli_phase(tmp, content_path, style_path, "lbfgs-lyap",
                       ["--optimizer", "lbfgs", "--w2-grad", "lyap"], lyap_path)
            phase = "steady state of the step"
            _steady_phase()
            phase = "checkpoint/resume through the CLI"
            _resume_phase(tmp, content_path, style_path)
            phase = "the web preview"
            _web_phase(tmp, content_path, style_path)
            phase = "the bf16 trunk"
            _bf16_phase(tmp, content_path, style_path)
            phase = "the lbfgs-zoom path through the CLI"
            zoom_path = _zoom_phase(tmp, content_path, style_path)
            phase = "fidelity on the card"
            _fidelity_phase(tmp)
            phase = "the sharded path"
            _sharded_phase(tmp, content_path, style_path, main_path)
            phase = "config #5 at print size"
            print_legs = _print_phase(tmp, content_path, style_path)
            phase = "configs #3 and #4"
            _configs_phase(tmp, content_path, style_path)
            phase = "the measurement tools on the card"
            _tools_phase()
            phase = "graph against eager"
            _graph_phase()
            phase = "remat on the card"
            _remat_phase(tmp, content_path, style_path, print_legs)
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke.py: FAILED in phase: {phase}", file=sys.stderr)
        return 1
    sys.stdout.flush()
    # Each kernel's launches come from the run of the path it serves: B1
    # from the main path, B2 and B3 from the --w2-grad lyap path, the
    # line-search step from the lbfgs-zoom path.
    launches = {"ns_sqrtm_yz": main_path["ns_sqrtm_yz"],
                "ns_sqrtm": lyap_run["ns_sqrtm"], "lyap_bwd": lyap_run["lyap_bwd"]}
    print(card)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": SRC,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": stats[name]["max_abs_err"],
        "ms": stats[name]["ms"],
        "plain_ms": stats[name]["plain_ms"],
        "bound_ms": stats[name]["bound_ms"],
        "fp32_fma_bound_ms": stats[name]["fp32_fma_bound_ms"],
        "grouped_ms": stats[name].get("grouped_ms"),  # B1: the four groups in one launch
        "bound_by": "operations",
        "library_ms": None,  # no single PyTorch call computes these functions
    } for name, (_, _, replaces) in KERNELS.items()] + [{
        "name": "zoom_ls_step",
        "route": "cuda",
        "source": LS_SRC,
        "replaces": LS_REPLACES,  # not a TPU kernel: optax's search in the JAX chunk
        "launches": zoom_path["zoom_ls_step"],
        "max_abs_err": ls_stats["max_abs_err"],
        "ms": ls_stats["ms"],
        "plain_ms": ls_stats["plain_ms"],
        "bound_ms": ls_stats["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no PyTorch call steps this state machine
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
