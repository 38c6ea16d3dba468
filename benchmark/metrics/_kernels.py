"""The device trace of a traced stretch: kernels by bucket, busy time and
idle gaps.

Kernels are told apart by name alone: inside CUDA-graph replays the
profiler sees no op that launched them. The buckets (after
``tools/profile_step_torch.py``, copied so that the yardstick does not move
with the tools):

* ``NS kernels``: ``csrc/ns_sqrtm.cu``'s, whose names start ``stt_nsk_``;
* ``line-search step``: ``stt_zls_``;
* ``layout copies``: cuDNN's NCHW <-> NHWC transposes;
* ``conv dgrad`` / ``conv wgrad``: cuDNN's data- and weight-gradient
  kernels (``dgrad``, ``wgrad`` in the name);
* ``conv FFT``: the FFT convolution's transforms and products (``fft``,
  ``flip_filter``, and cuBLAS GEMV, which the Adam step launches only from
  cuDNN's FFT convolutions: the loss's products are GEMMs);
* ``conv forward``: cuDNN's other convolution kernels (``fprop``,
  ``implicit_gemm``, ``convolve``, ``winograd``, ``cudnn``);
* ``cuBLAS GEMM``: ``gemm`` and cuBLAS's helpers (the moments and the W2
  products; cuBLAS's own ``xmma_gemm`` kernels, not convolutions);
* ``eigh (cuSOLVER)``: the targets' eigendecompositions;
* ``memcpy/memset``: the runtime's copies and fills;
* ``elementwise/reduction``: ATen's ``at::native`` kernels and the like;
* ``other``.

The trunk is the convolution buckets and the layout copies.
"""

import bisect

__all__ = ["TRUNK", "NS", "bucket", "Trace", "read_profile"]

NS = "NS kernels"
TRUNK = ("conv forward", "conv dgrad", "conv wgrad", "conv FFT", "layout copies")
_FFT = ("fft2d", "flip_filter", "gemv")
_CONV = ("fprop", "implicit_gemm", "convolve", "winograd", "cudnn")
_BLAS = ("gemm", "cublas", "scal_kernel", "splitkreduce")
_EIGH = ("syev", "rotate_batch", "pegasus", "offa_stage", "fnrma", "lascl", "colperm",
         "batch_eye", "batch_symmetrize", "copy_info_kernel")
_ELEMENTWISE = ("at::native", "elementwise", "reduce", "pool", "triton", "vectorized")
SMALL_GAP_NS = 20_000


def bucket(name):
    """The bucket of a device operation by its name."""
    if "stt_nsk_" in name:
        return NS
    if "stt_zls_" in name:
        return "line-search step"
    k = name.lower()
    if k.startswith(("memcpy", "memset")):
        return "memcpy/memset"
    if "nchwtonhwc" in k or "nhwctonchw" in k:
        return "layout copies"
    if "dgrad" in k:
        return "conv dgrad"
    if "wgrad" in k:
        return "conv wgrad"
    if any(m in k for m in _FFT):
        return "conv FFT"
    if any(m in k for m in _CONV):
        return "conv forward"
    if any(m in k for m in _BLAS):
        return "cuBLAS GEMM"
    if any(m in k for m in _EIGH):
        return "eigh (cuSOLVER)"
    if any(m in k for m in _ELEMENTWISE):
        return "elementwise/reduction"
    return "other"


def _union(intervals):
    """Merged (start, end) intervals of sorted ones."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """A traced stretch: ``ops`` [(name, start_ns, dur_ns)] on the device,
    ``host`` [(name, start_ns, end_ns)] on the host, ``window_s`` its
    length by the host's clock."""

    def __init__(self, ops, host, window_s):
        self.ops, self.window_s = sorted(ops, key=lambda o: o[1]), window_s
        self.host = sorted(host, key=lambda h: h[1])
        self._host_starts = [h[1] for h in self.host]
        self.busy = _union([(s, s + d) for _, s, d in self.ops])

    def busy_s(self):
        return sum(e - s for s, e in self.busy) / 1e9

    def seconds(self, buckets):
        """Device seconds of the operations in ``buckets``."""
        return sum(d for n, _, d in self.ops if bucket(n) in buckets) / 1e9

    def by_bucket(self):
        out = {}
        for n, _, d in self.ops:
            out[bucket(n)] = out.get(bucket(n), 0.0) + d / 1e9
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def top_ops(self, n=10):
        out = {}
        for name, _, d in self.ops:
            out[name] = out.get(name, 0.0) + d / 1e9
        return sorted(out.items(), key=lambda kv: -kv[1])[:n]

    def _host_label(self, t):
        """The innermost host event running at ``t``."""
        k = bisect.bisect_right(self._host_starts, t)
        best = None
        for name, s, e in reversed(self.host[max(0, k - 2000):k]):
            if e >= t and (best is None or s > best[1]):
                best = (name, s)
        return best[0] if best else "(host: outside every profiled call)"

    def idle_gaps(self, n=10):
        """[(what the host was doing, idle seconds)] over the gaps between
        device operations; gaps under 20 us are summed as one entry."""
        out, small = {}, 0
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            gap = s1 - e0
            if gap < SMALL_GAP_NS:
                small += gap
                continue
            label = self._host_label(e0 + gap // 2)
            out[label] = out.get(label, 0) + gap
        out["(gaps under 20 us between device operations)"] = small
        return sorted(((k, v / 1e9) for k, v in out.items()), key=lambda kv: -kv[1])[:n]


def read_profile(prof, window_s):
    """A :class:`Trace` from a finished ``torch.profiler.profile``, read
    from its raw events (building the profiler's own event tree would take
    minutes over a whole image's kernels)."""
    import torch

    ops, host = [], []
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == cuda:
            ops.append((e.name(), e.start_ns(), e.duration_ns()))
        elif kind == cpu:
            host.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return Trace(ops, host, window_s)
