"""Newton-Schulz square roots: CUDA kernels, plain versions, autograd.

The kernels (``csrc/ns_sqrtm.cu`` with ``csrc/ns_common.cuh``) replace
the three TPU kernels of ``style_transfer_tpu/ops/pallas/ns_sqrtm.py``, every
product in 3xTF32 on the tensor cores (FP32 accuracy; emulated on the CPU
by :func:`matmul_tf32x3` for the tests):

* :func:`ns_sqrtm_yz_groups` (``_ns_fwd_yz_kernel``): for a list of
  groups, each (G_k, C_k, C_k) float32 matrices, each group's (Y, Z) ~
  (A^{1/2}, A^{-1/2}) after ``num_iters`` coupled NS iterations, every
  group's chain in one launch (:func:`plan_groups` splits the blocks);
  :func:`ns_sqrtm_yz` is its one-group case;
* :func:`ns_sqrtm` (``_ns_fwd_kernel``): the same chain emitting only Y;
* :func:`lyap_bwd` (``_lyap_bwd_kernel``): Q with Z Q + Q Z = G by the
  iterative Lyapunov solver, the backward of the NS square root.

Each wrapper dispatches on the tensor's device alone: a CPU tensor takes the
plain version (``ops/sqrtm.py``); a CUDA tensor launches the kernel or
raises. ``<wrapper>.launches`` counts the kernel launches (B1's:
``ns_sqrtm_yz.launches``, one a grouped launch); a launch recorded into a
CUDA graph counts once per replay of the graph, which the graph's runner
adds (:func:`launch_counts`, :func:`add_launches`). Each grouped launch
records the ``ns-groups`` counter (``utils/trace.py``): the groups and
each one's blocks. :class:`TraceSqrtmNS` gives each group's ``tr(Y)`` with
the backward ½·g·Z outside the kernel; :class:`SqrtmNSLyap` gives the full
square root with the Lyapunov kernel as its backward, as the JAX package
computes them.
"""

import contextlib
import ctypes
import functools

import torch

from ...utils import trace as T
from ..sqrtm import _batch_trace, _lyap_backward, _sqrtm_ns_yz, sqrtm_ns
from . import build

__all__ = [
    "ns_sqrtm_yz", "ns_sqrtm_yz_plain", "ns_sqrtm_yz_groups", "ns_sqrtm_yz_serial",
    "plan_groups", "NSGroupsResidencyError", "TraceSqrtmNS", "trace_sqrtm_ns",
    "trace_sqrtm_ns_groups",
    "ns_sqrtm", "ns_sqrtm_plain", "lyap_bwd", "lyap_bwd_plain",
    "SqrtmNSLyap", "sqrtm_ns_lyap", "tf32_round", "matmul_tf32x3",
    "ns_first_iteration", "ns_sqrtm_yz_tf32x3", "lyap_bwd_tf32x3",
    "launch_counts", "add_launches",
]


def ns_sqrtm_yz_plain(a, num_iters: int = 12):
    """The plain PyTorch version: full-FP32 ``torch.matmul`` chain."""
    return _sqrtm_ns_yz(a, num_iters)


def ns_sqrtm_plain(a, num_iters: int = 12):
    """The plain PyTorch version of :func:`ns_sqrtm`."""
    return sqrtm_ns(a, num_iters)


def lyap_bwd_plain(z, g, num_iters: int = 12):
    """The plain PyTorch version of :func:`lyap_bwd`."""
    return _lyap_backward(z, g, num_iters)


def tf32_round(x):
    """``cvt.rna.tf32.f32`` on float32 values: round to the 10-bit TF32
    mantissa, ties away from zero (add half a TF32 unit to the magnitude
    bits, clear the 13 dropped bits). Finite inputs only."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def matmul_tf32x3(a, b):
    """The kernels' 3xTF32 product, emulated: each operand split into a TF32
    head and the TF32-rounded remainder, a·b ≈ hi·hi + (hi·lo + lo·hi) with
    FP32 sums (each product of two TF32 values is exact in FP32). For the
    tests only; the kernels' own summation order within a k-step differs."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def ns_first_iteration(y0):
    """The kernels' first NS iteration from Z_0 = I without its two products
    by the identity: T_0 = (3I - Y_0) / 2 elementwise, Z_1 = T_0. Returns
    (T_0, Z_1); Y_1 = Y_0 T_0 is the one product left."""
    eye = torch.eye(y0.shape[-1], dtype=y0.dtype, device=y0.device)
    t0 = (3.0 * eye - y0) * 0.5
    return t0, t0


def ns_sqrtm_yz_tf32x3(a, num_iters: int = 12):
    """The chain of :func:`ns_sqrtm_yz` as the kernel runs it: the shortened
    first iteration, then every product in emulated 3xTF32."""
    norm = torch.sqrt(torch.sum(a * a, dim=(-2, -1), keepdim=True))
    y = a / norm
    z = torch.eye(a.shape[-1], dtype=a.dtype).expand_as(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype)
    for it in range(num_iters):
        if it == 0:
            t, z = ns_first_iteration(y)
            y = matmul_tf32x3(y, t)
        else:
            t = (3.0 * eye - matmul_tf32x3(z, y)) * 0.5
            y, z = matmul_tf32x3(y, t), matmul_tf32x3(t, z)
    sn = torch.sqrt(norm)
    return y * sn, z / sn


def lyap_bwd_tf32x3(z, g, num_iters: int = 12):
    """The chain of :func:`lyap_bwd` with every product in emulated 3xTF32,
    the two-term differences subtracted after both products, as the kernel
    does."""
    eye3 = 3.0 * torch.eye(z.shape[-1], dtype=z.dtype)
    norm = torch.sqrt(torch.sum(z * z, dim=(-2, -1), keepdim=True))
    a, q = z / norm, g / norm
    for _ in range(num_iters):
        at = a.transpose(-2, -1)
        e = eye3 - matmul_tf32x3(a, a)
        d = matmul_tf32x3(at, q) - matmul_tf32x3(q, a)
        q = (matmul_tf32x3(q, e) - matmul_tf32x3(at, d)) * 0.5
        a = matmul_tf32x3(a, e) * 0.5
    return q * 0.5


def _check_input(name, a, num_iters):
    if a.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {a.dtype}")
    if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(
            f"{name}: expected (C, C) or (G, C, C), got {tuple(a.shape)}")
    if a.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(a.shape)}")
    if num_iters < 0:
        raise ValueError("num_iters must be non-negative")


def _check_cuda_input(name, a):
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    cap = _capability(a.device.index)
    if cap != (9, 0):
        raise RuntimeError(
            f"{name}: the kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(a.device)} is sm_{cap[0]}{cap[1]}")


@functools.lru_cache(maxsize=None)
def _capability(index):
    return torch.cuda.get_device_capability(index)


# stt::kErrClusterUnschedulable, stt::kErrGroupsNotResident (csrc/ns_common.cuh).
_ERR_CLUSTER_UNSCHEDULABLE = 10000
_ERR_GROUPS_NOT_RESIDENT = 10001
# stt::kClusterMaxC: the largest C of the cluster regime.
_CLUSTER_MAX_C = 256


class NSGroupsResidencyError(RuntimeError):
    """The grouped launch's plan needs more blocks resident at once than
    the device holds: its groups' barriers would wait for ever."""


def _launch(name, symbol, inputs, n_out, n_scratch, num_iters):
    """Calls ``symbol(*inputs, *outputs, *scratch, norm, g, n, num_iters,
    stream)`` on the inputs' device and current stream, with every output a
    fresh (G, C, C) ``torch.empty`` and the scratch matrices and ``norm``
    ((G, stt_ns_norm_slots()) floats) in one more. Returns the outputs in
    the inputs' shape."""
    x = inputs[0]
    batched = [t if t.ndim == 3 else t.unsqueeze(0) for t in inputs]
    g, n, _ = batched[0].shape
    outs = [torch.empty_like(batched[0]) for _ in range(n_out)]
    lib = build.load()
    nn = g * n * n
    scratch = torch.empty((n_scratch * nn + g * _norm_slots(lib),), dtype=torch.float32,
                          device=x.device)
    base = scratch.data_ptr()
    fn = getattr(lib, symbol)
    # Launches go to the inputs' device: make it current for the call.
    switch = x.device.index != torch.cuda.current_device()
    with torch.cuda.device(x.device) if switch else contextlib.nullcontext():
        err = fn(*(t.data_ptr() for t in batched), *(t.data_ptr() for t in outs),
                 *(base + 4 * i * nn for i in range(n_scratch + 1)), g, n,
                 num_iters, torch.cuda.current_stream(x.device).cuda_stream)
    if err == _ERR_CLUSTER_UNSCHEDULABLE:
        raise RuntimeError(
            f"{name}: the thread-block cluster for C={n} cannot be scheduled "
            f"on {torch.cuda.get_device_name(x.device)}")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {err}")
    return [t.view(x.shape) for t in outs]


@functools.lru_cache(maxsize=None)
def _norm_slots(lib):
    return lib.stt_ns_norm_slots()


def _group_work(g, c, beside_gemm=False):
    """A (G, C, C) group in the grouped launch (``csrc/ns_sqrtm.cu``,
    ``stt_nsk_ns_groups``: blocks of one warpgroup, each computing a tile
    at a time, 64x64 for C > 256 as the GEMM regime, 32x32 else): (the
    tiles of an iteration's Y and Z products, the blocks the group wants,
    the time of a tile in units of k-depth x tile area). A group wants a
    block for every tile of both products, so that each step runs in one
    wave; beside a C > 256 group (``beside_gemm``), a C <= 256 group wants
    a block a tile and computes both products of its tile in turn, as a
    cluster block does: its steps are short beside the other's, and each
    block it adds shares an SM with the other's tiles."""
    tile = 64 if c > _CLUSTER_MAX_C else 32
    tiles = g * (-(-c // tile)) ** 2
    halve = beside_gemm and c <= _CLUSTER_MAX_C
    return 2 * tiles, tiles if halve else 2 * tiles, c * tile * tile


def plan_groups(shapes, capacity):
    """Blocks of the grouped launch for each group, from the shapes alone.

    ``shapes``: (G, C) of each group; ``capacity``: the blocks the device
    holds resident at once. Each group gets the blocks it wants
    (:func:`_group_work`) if all fit, and a single group as many as it can
    use. Otherwise each group starts at one block and each further block
    goes to the group whose iteration would take longest (its rounds of
    tiles times a tile's time), until the card is full or every want is
    met. Raises :class:`NSGroupsResidencyError` with more groups than
    blocks."""
    gemm = any(c > _CLUSTER_MAX_C for _, c in shapes)
    work = [_group_work(g, c, gemm) for g, c in shapes]
    wants = [want for _, want, _ in work]
    if sum(wants) <= capacity:
        return wants
    if len(shapes) > capacity:
        raise NSGroupsResidencyError(
            f"ns_sqrtm_yz_groups: {len(shapes)} groups on {capacity} resident blocks")
    blocks = [1] * len(shapes)

    def time(k):
        tiles, _, unit = work[k]
        return -(-tiles // blocks[k]) * unit

    for _ in range(capacity - len(shapes)):
        open_ = [k for k in range(len(shapes)) if blocks[k] < wants[k]]
        if not open_:
            break
        blocks[max(open_, key=lambda k: (time(k), -k))] += 1
    return blocks


@functools.lru_cache(maxsize=None)
def _groups_capacity(lib, index):
    cap = lib.stt_ns_groups_capacity()
    if cap < 0:
        raise RuntimeError(f"ns_sqrtm_yz_groups: occupancy query failed, cudaError_t {-cap}")
    return cap


def _launch_groups(mats, num_iters):
    """One launch of ``stt_ns_sqrtm_yz_groups_f32`` for every group, on the
    groups' device and current stream. The largest C comes first in the
    grid, so the block scheduler's first pass spreads the GEMM regime's
    blocks one to an SM. Scratch is one allocation: each group's T and
    ping-pong buffers and its norms, then the barrier words."""
    x = mats[0]
    batched = [t if t.ndim == 3 else t.unsqueeze(0) for t in mats]
    lib = build.load()
    order = sorted(range(len(batched)), key=lambda k: -batched[k].shape[-1])
    outs = [(torch.empty_like(t), torch.empty_like(t)) for t in batched]
    offsets, size = [], 0

    def take(floats):  # 256-byte aligned, for the float4 copies
        nonlocal size
        offsets.append(size)
        size += -(-floats // 64) * 64

    slots = _norm_slots(lib)
    for k in order:
        g, n, _ = batched[k].shape
        for _ in range(3):
            take(g * n * n)
        take(g * slots)
    take(len(batched) * lib.stt_ns_barrier_words())
    scratch = torch.empty((size,), dtype=torch.float32, device=x.device)
    base = scratch.data_ptr()
    switch = x.device.index != torch.cuda.current_device()
    with torch.cuda.device(x.device) if switch else contextlib.nullcontext():
        blocks = plan_groups([tuple(batched[k].shape[:2]) for k in order],
                             _groups_capacity(lib, x.device.index))
        desc = []
        for i, k in enumerate(order):
            g, n, _ = batched[k].shape
            bufs = [base + 4 * off for off in offsets[4 * i:4 * i + 4]]
            desc += [batched[k].data_ptr(), outs[k][0].data_ptr(), outs[k][1].data_ptr(),
                     *bufs, g, n, blocks[i]]
        err = lib.stt_ns_sqrtm_yz_groups_f32(
            (ctypes.c_longlong * len(desc))(*desc), len(order), num_iters,
            base + 4 * offsets[-1], torch.cuda.current_stream(x.device).cuda_stream)
    if err == _ERR_GROUPS_NOT_RESIDENT:
        raise NSGroupsResidencyError(
            f"ns_sqrtm_yz_groups: {sum(blocks)} blocks planned, more than "
            f"{torch.cuda.get_device_name(x.device)} holds resident")
    if err != 0:
        raise RuntimeError(f"ns_sqrtm_yz_groups: kernel launch failed, cudaError_t {err}")
    T.counter("ns-groups", {"groups": len(order), "blocks": [
        [batched[k].shape[0], batched[k].shape[-1], b] for k, b in zip(order, blocks)]})
    return [(y.view(m.shape), z.view(m.shape)) for (y, z), m in zip(outs, mats)]


def ns_sqrtm_yz_groups(mats, num_iters: int = 12):
    """(A^{1/2}, A^{-1/2}) of every group of SPD matrices by coupled NS:
    ``[(Y_k, Z_k)]`` for ``mats = [A_k]``.

    Each input must be float32, (C, C) or (G, C, C), and all on one device.
    CPU tensors take the plain version a group at a time; CUDA tensors must
    also be contiguous and on an sm_90 device, and make one launch on the
    current stream for all the groups (at most ``stt_ns_max_groups()``, 8).
    No fallback.
    """
    mats = list(mats)
    if not mats:
        raise ValueError("ns_sqrtm_yz_groups: no groups")
    for a in mats:
        _check_input("ns_sqrtm_yz", a, num_iters)
        if a.device != mats[0].device:
            raise ValueError(f"ns_sqrtm_yz_groups: groups on {mats[0].device} and {a.device}")
    if mats[0].device.type == "cpu":
        return [ns_sqrtm_yz_plain(a, num_iters) for a in mats]
    for a in mats:
        _check_cuda_input("ns_sqrtm_yz", a)
    limit = _max_groups(build.load())
    if len(mats) > limit:
        raise ValueError(f"ns_sqrtm_yz_groups: {len(mats)} groups, at most {limit} a launch")
    out = _launch_groups(mats, num_iters)
    ns_sqrtm_yz.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _max_groups(lib):
    return lib.stt_ns_max_groups()


def ns_sqrtm_yz(a, num_iters: int = 12):
    """(A^{1/2}, A^{-1/2}) of (a batch of) SPD matrices by coupled NS: the
    one-group case of :func:`ns_sqrtm_yz_groups`, with its input rules and
    dispatch."""
    return ns_sqrtm_yz_groups([a], num_iters)[0]


ns_sqrtm_yz.launches = 0


def ns_sqrtm_yz_serial(a, num_iters: int = 12):
    """B1 by the per-group kernels (``stt_ns_sqrtm_yz_f32``): a CUDA
    tensor's chain in the GEMM regime's launches, one a step, or one
    cluster launch. The reference of the grouped launch in the card tests
    and ``tools/ns_kernel_times.py``; the program calls the grouped one. A
    CUDA tensor only; counts no B1 launch."""
    _check_input("ns_sqrtm_yz_serial", a, num_iters)
    _check_cuda_input("ns_sqrtm_yz_serial", a)
    y, z = _launch("ns_sqrtm_yz_serial", "stt_ns_sqrtm_yz_f32", [a], 2, 3, num_iters)
    return y, z


def ns_sqrtm(a, num_iters: int = 12):
    """A^{1/2} of (a batch of) SPD matrices by NS; the same input rules and
    dispatch as :func:`ns_sqrtm_yz`."""
    _check_input("ns_sqrtm", a, num_iters)
    if a.device.type == "cpu":
        return ns_sqrtm_plain(a, num_iters)
    _check_cuda_input("ns_sqrtm", a)
    (y,) = _launch("ns_sqrtm", "stt_ns_sqrtm_f32", [a], 1, 4, num_iters)
    ns_sqrtm.launches += 1
    return y


ns_sqrtm.launches = 0


def lyap_bwd(z, g, num_iters: int = 12):
    """Q with Z Q + Q Z = G per matrix, by ``num_iters`` steps of the NS-style
    Lyapunov iteration. ``z`` and ``g`` must have the same shape; the same
    input rules and dispatch as :func:`ns_sqrtm_yz`, for both."""
    _check_input("lyap_bwd", z, num_iters)
    _check_input("lyap_bwd", g, num_iters)
    if z.shape != g.shape:
        raise ValueError(
            f"lyap_bwd: z {tuple(z.shape)} and g {tuple(g.shape)} differ in shape")
    if z.device != g.device:
        raise ValueError(f"lyap_bwd: z on {z.device}, g on {g.device}")
    if z.device.type == "cpu":
        return lyap_bwd_plain(z, g, num_iters)
    _check_cuda_input("lyap_bwd", z)
    _check_cuda_input("lyap_bwd", g)
    (q,) = _launch("lyap_bwd", "stt_lyap_bwd_f32", [z, g], 1, 5, num_iters)
    lyap_bwd.launches += 1
    return q


lyap_bwd.launches = 0


def launch_counts():
    """The launch counts of B1, B2 and B3 (``ns_sqrtm_yz``, ``ns_sqrtm``,
    ``lyap_bwd``)."""
    return (ns_sqrtm_yz.launches, ns_sqrtm.launches, lyap_bwd.launches)


def add_launches(counts, times: int = 1):
    """Adds ``times`` x ``counts`` (as :func:`launch_counts` orders them)
    to the launch counts: a graph's runner adds what its capture recorded
    once per replay, and takes back the capture's own, which ran nothing."""
    for fn, c in zip((ns_sqrtm_yz, ns_sqrtm, lyap_bwd), counts):
        fn.launches += times * c


class TraceSqrtmNS(torch.autograd.Function):
    """``tr(sqrtm(A_k))`` per matrix of each group, by one
    :func:`ns_sqrtm_yz_groups` call; saves each Z_k ~ A_k^{-1/2} for the
    analytic backward d tr(A^{1/2}) / dA = A^{-1/2} / 2, a group at a
    time outside the kernel."""

    @staticmethod
    def forward(ctx, num_iters, *mats):
        yz = ns_sqrtm_yz_groups(mats, num_iters)
        ctx.save_for_backward(*(z for _, z in yz))
        return tuple(_batch_trace(y) for y, _ in yz)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(0.5 * g[..., None, None] * z
                        for g, z in zip(grads, ctx.saved_tensors)))


def trace_sqrtm_ns_groups(mats, num_iters: int = 12):
    """``[tr(sqrtm(A_k))]`` for ``mats = [A_k]``, one launch on a CUDA
    device."""
    return list(TraceSqrtmNS.apply(num_iters, *mats))


def trace_sqrtm_ns(a, num_iters: int = 12):
    return TraceSqrtmNS.apply(num_iters, a)[0]


class SqrtmNSLyap(torch.autograd.Function):
    """NS square root (:func:`ns_sqrtm`) whose backward is the Lyapunov
    solver (:func:`lyap_bwd`) on the saved result."""

    @staticmethod
    def forward(ctx, a, num_iters, num_iters_backward):
        y = ns_sqrtm(a, num_iters)
        ctx.save_for_backward(y)
        ctx.iters = num_iters if num_iters_backward is None else num_iters_backward
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        # Autograd may hand over a strided or expanded gradient; the wrapper
        # takes only contiguous tensors.
        return lyap_bwd(y, g.contiguous(), ctx.iters), None, None


def sqrtm_ns_lyap(a, num_iters: int = 10, num_iters_backward: int = None):
    """NS square root whose backward solves the Lyapunov equation
    iteratively, saving only the forward result (the port of
    ``sqrtm_ns_lyap_pallas``)."""
    return SqrtmNSLyap.apply(a, num_iters, num_iters_backward)
