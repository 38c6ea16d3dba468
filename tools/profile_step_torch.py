"""Per-kernel device profile of the PyTorch port's step at a given size.

Usage: python3 tools/profile_step_torch.py H W [iters=20] [k=v ...]

The port's counterpart of ``tools/profile_step.py``. Trailing k=v pairs go
to ``style_transfer_tpu_torch.bench.build_step``: ``device=cpu``,
``compute_dtype=bf16``, ``w2_grad=lyap``, ``optimizer=lbfgs``,
``eager=True`` (the eager runner in place of the card's graph replays) or
any ``StepConfig`` field (``tv_weight=5``). The step runs ``iters``
iterations once to warm up, then once more under ``torch.profiler`` (CPU
and CUDA activities, op FLOPs counted), and the device kernels of that
window are reported. On the card Adam and L-BFGS run as replays of one
CUDA graph of the step, whose kernels no ATen op launches: the op that
launches each kernel, and with it the kernel's bucket and FLOPs, then come
from one more step run eagerly and profiled alone (the output says so).

- device kernel ms/iter and the busy share (kernel time over the wall of
  as many iterations run just before without the profiler, whose own host
  time would lower it), and the same over the profiled run's own wall;
- buckets: the NS kernels (``csrc/ns_sqrtm.cu``'s kernels start with
  ``stt_nsk_``), the zoom line search's step (``csrc/zoom_ls.cu``,
  ``stt_zls_``; with ``optimizer=lbfgs-zoom``), cuDNN convolution forward,
  dgrad and wgrad, cuBLAS GEMM/GEMV, layout copies (``nchwToNhwc``),
  elementwise/reduction, other;
- the top kernels, with TFLOP/s where the profiler counts the FLOPs of the
  op that launched them (the outermost counted op's FLOPs spread over the
  convolution and GEMM kernels inside it, by their time; its layout copies
  and elementwise kernels get none), and the op that launched most of
  each, with its first input shapes;
- the top sources: device time by the op that launched each kernel (the
  innermost profiled op; kernels launched outside any op, as the NS
  kernels' ctypes launches in a forward, are "(no op)").

``profile()`` returns that summary as a dict, or None where the profiler
saw no device kernel (on the CPU, or a profiler that recorded nothing): it
then prints "not measured" and never reports host time as device time.
``time_step()`` is the timing-only variant.
"""

import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

NS_PREFIX = "stt_nsk_"
NS_BUCKET = "NS kernels (stt_nsk_)"
LS_PREFIX = "stt_zls_"
LS_BUCKET = "line-search step (stt_zls_)"
NO_OP = "(no op)"
_CONV_MARKS = ("fprop", "dgrad", "wgrad", "conv", "cudnn", "fft", "winograd")
_BLAS_MARKS = ("gemm", "gemv", "cublas", "cutlass")
_ELEMENTWISE_MARKS = ("at::native", "elementwise", "reduce", "pool")
# The buckets whose kernels carry an op's counted FLOPs.
_COMPUTE = ("cuDNN conv forward", "cuDNN conv dgrad", "cuDNN conv wgrad", "cuBLAS GEMM/GEMV")


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build(h, w, cfg):
    import torch

    from style_transfer_tpu_torch.bench import build_step

    return torch.device(cfg.get("device", "cuda:0")), build_step(h, w, **cfg)


def time_step(h, w, iters=20, reps=3, **cfg):
    """Wall ms/iter of the step (no profiler): the best of ``reps`` runs of
    ``iters`` iterations, each ended by a sync, after one warm-up run."""
    device, (runner, params, consts, state) = _build(h, w, cfg)
    state, _ = runner(params, consts, state, iters)
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        state, _ = runner(params, consts, state, iters)
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    print(f"[time_step] {h}x{w} {cfg}: {best:.2f} ms/iter", flush=True)
    return best


def _bucket(kernel, op):
    """The bucket of a device kernel, by its name and the op that launched
    it (a convolution kernel launched by a backward op is a data gradient:
    the step takes no weight gradient)."""
    if NS_PREFIX in kernel:
        return NS_BUCKET
    if LS_PREFIX in kernel:
        return LS_BUCKET
    k = kernel.lower()
    if "nchwtonhwc" in k or "nhwctonchw" in k:
        return "layout copies"
    if any(m in k for m in _CONV_MARKS):
        if "wgrad" in k:
            return "cuDNN conv wgrad"
        if "dgrad" in k or "backward" in (op or "").lower():
            return "cuDNN conv dgrad"
        return "cuDNN conv forward"
    if any(m in k for m in _BLAS_MARKS):
        return "cuBLAS GEMM/GEMV"
    if any(m in k for m in _ELEMENTWISE_MARKS):
        return "elementwise/reduction"
    return "other"


def _subtree_kernels(event):
    """(kernel name, us) of every kernel launched inside ``event``."""
    out = [(k.name, k.duration) for k in event.kernels]
    for child in event.cpu_children:
        out += _subtree_kernels(child)
    return out


def _counted_above(event):
    """Whether an op around ``event`` has its FLOPs counted already (the
    outermost counted op spreads them over the kernels inside it)."""
    parent = event.cpu_parent
    while parent is not None:
        if (parent.flops or 0) > 0:
            return True
        parent = parent.cpu_parent
    return False


def summarize(events, iters, wall_us, attribution=None):
    """The summary dict of a profiled window of ``iters`` iterations (see
    the module docstring), or None when it holds no device kernel. With
    ``attribution`` (the summary of an eager step of the same step), each
    kernel's time is split over the buckets as that step's was, and its
    launching op, its FLOP rate and the sources are that step's."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda]
    if not kernels:
        return None
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    total = sum(by_name.values())

    # (kernel, op, the op's input shapes) -> us from each op's own kernels;
    # what no op claims was launched outside any op.
    by_pair = defaultdict(float)
    flops = defaultdict(float)
    for e in events:
        if e.device_type == cuda:
            continue
        shapes = [s for s in getattr(e, "input_shapes", None) or () if s][:3]
        shapes = str(shapes) if shapes else ""
        for k in e.kernels:
            if k.name in by_name:
                by_pair[(k.name, e.name, shapes)] += k.duration
        if (e.flops or 0) > 0 and not _counted_above(e):
            sub = [(n, us) for n, us in _subtree_kernels(e)
                   if n in by_name and _bucket(n, None) in _COMPUTE]
            span = sum(us for _, us in sub)
            for n, us in sub if span > 0 else ():
                flops[n] += e.flops * us / span
    for name, us in by_name.items():
        claimed = sum(v for (n, _, _), v in by_pair.items() if n == name)
        if us - claimed > 1e-3:
            by_pair[(name, NO_OP, "")] += us - claimed

    # Each kernel's share of each bucket, and the op that launched most of it.
    shares, sources, main_source = defaultdict(dict), defaultdict(float), {}
    for (name, op, shapes), us in by_pair.items():
        b = _bucket(name, None if op == NO_OP else op)
        shares[name][b] = shares[name].get(b, 0.0) + us / by_name[name]
        sources[op] += us
        if us > main_source.get(name, (-1.0, ""))[0]:
            main_source[name] = (us, f"{op} {shapes}".strip())
    main_source = {n: src for n, (_, src) in main_source.items()}
    for k in (attribution or {}).get("top", ()):
        if k["name"] in by_name:
            shares[k["name"]] = k["buckets"]
            main_source[k["name"]] = k["source"]
            flops[k["name"]] = (k["tflops"] or 0.0) * by_name[k["name"]] * 1e6
    buckets = defaultdict(float)
    for name, us in by_name.items():
        for b, share in shares[name].items():
            buckets[b] += us * share

    def ms(us):
        return us / iters / 1e3

    return {
        "iters": iters,
        "wall_ms_per_iter": ms(wall_us),
        "kernel_ms_per_iter": ms(total),
        "busy": total / wall_us,
        "ns_ms_per_iter": ms(buckets.get(NS_BUCKET, 0.0)),
        "buckets": {b: ms(us) for b, us in sorted(buckets.items(), key=lambda kv: -kv[1])},
        "top": [{"name": n, "ms_per_iter": ms(us),
                 "tflops": flops[n] / (us * 1e6) if flops.get(n) else None,
                 "source": main_source[n], "buckets": shares[n]}
                for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])],
        "sources": (attribution["sources"] if attribution is not None else
                    [{"op": op, "ms_per_iter": ms(us)}
                     for op, us in sorted(sources.items(), key=lambda kv: -kv[1])]),
    }


def profile_runner(runner, params, consts, state, iters, device, attribution=None):
    """Runs ``iters`` iterations of a ``build_step`` runner, timed and
    ended by a sync, then ``iters`` more under ``torch.profiler``; returns
    (state, ``summarize``'s dict or None, with ``attribution`` as there).
    The busy share's wall is the first run's: the profiler's own host time
    would lower it. ``busy_profiled`` is the kernel time over the profiled
    run's own wall: above 1 only where kernels overlap."""
    import torch

    t0 = time.perf_counter()
    state, _ = runner(params, consts, state, iters)
    _sync(device)
    wall_us = (time.perf_counter() - t0) * 1e6
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, with_flops=True) as prof:
        t0 = time.perf_counter()
        state, _ = runner(params, consts, state, iters)
        _sync(device)
        profiled_us = (time.perf_counter() - t0) * 1e6
    s = summarize(prof.events(), iters, wall_us, attribution)
    if s is not None:
        s["busy_profiled"] = s["kernel_ms_per_iter"] * iters * 1e3 / profiled_us
    return state, s


def eager_attribution(h, w, **cfg):
    """The summary of one eager step at (h, w), profiled alone after one
    warm-up step: each kernel's launching op, bucket and FLOP rate, and the
    sources, for a graph runner's profile. None where no device kernel was
    seen."""
    device, (runner, params, consts, state) = _build(h, w, dict(cfg, eager=True))
    state, _ = runner(params, consts, state, 1)
    _sync(device)
    return profile_runner(runner, params, consts, state, 1, device)[1]


def profile(h, w, iters=20, top=30, **cfg):
    """Profiles the step at (h, w) (see the module docstring); prints the
    buckets, the top kernels and the top sources, and returns the summary,
    or None when no device kernel was seen. ``graph`` in the summary says
    whether the profiled runner replayed a CUDA graph."""
    device, (runner, params, consts, state) = _build(h, w, cfg)
    graph = runner.run.graphed(device)
    attribution = eager_attribution(h, w, **cfg) if graph else None
    state, _ = runner(params, consts, state, iters)
    _sync(device)
    _, s = profile_runner(runner, params, consts, state, iters, device, attribution)
    head = f"{h}x{w} {cfg} {iters} iters ({'graph replays' if graph else 'eager'})"
    if s is None:
        print(f"\n=== {head}: device kernel time not measured "
              "(the profiler saw no device kernel) ===", flush=True)
        return None
    s["graph"] = graph
    print(f"\n=== {head}: {s['kernel_ms_per_iter']:.3f} ms/iter device kernel time, "
          f"busy share {s['busy']:.2f} of {s['wall_ms_per_iter']:.3f} ms/iter wall "
          f"(unprofiled; {s['busy_profiled']:.2f} of the profiled run's wall) ===")
    if graph:
        print("(the kernels' buckets, launching ops, FLOP rates and the sources "
              "below are from one eager step of the same step, profiled alone)")
    for b, v in s["buckets"].items():
        print(f"{b:32s} {v:8.3f} ms/iter ({100 * v / s['kernel_ms_per_iter']:5.1f}%)")
    print(f"\nTop {top} kernels (TF/s = the launching op's FLOPs over its conv/GEMM "
          "kernels' time):")
    for k in s["top"][:top]:
        tf = f"{k['tflops']:6.1f}" if k["tflops"] is not None else "     -"
        print(f"  {k['ms_per_iter']:8.3f} ms/iter {tf} TF/s  {k['name'][:80]}  "
              f"[{k['source'][:110]}]")
    print("\nTop 15 sources (device time by the op that launched it):")
    for src in s["sources"][:15]:
        print(f"  {src['ms_per_iter']:8.3f} ms/iter  {src['op'][:100]}")
    sys.stdout.flush()
    return s


def _value(v):
    if "," in v:
        return tuple(int(x) for x in v.split(",") if x)
    if v in ("True", "False"):
        return v == "True"
    for kind in (int, float):
        try:
            return kind(v)
        except ValueError:
            pass
    return v


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    h = int(argv[0]) if len(argv) > 0 else 512
    w = int(argv[1]) if len(argv) > 1 else 512
    rest = argv[2:]
    iters = int(rest.pop(0)) if rest and "=" not in rest[0] else 20
    cfg = {k: _value(v) for k, v in (kv.split("=", 1) for kv in rest)}
    return profile(h, w, iters, **cfg)


if __name__ == "__main__":
    main()
