"""Spatial sharding over a group of processes, one device each.

Port of ``style_transfer_tpu/parallel/mesh.py``. The JAX package is single
controller: GSPMD partitions one program over a device mesh and inserts the
halo exchanges itself. PyTorch has no such partitioner (and the DTensor
convolution rules do no halo exchange), so here each rank of a
``torch.distributed`` process group holds one slab of the image and the
partitioning is written out by hand:

* the grid is ``factor_devices(world)`` as in JAX: H split over rows, and W
  over cols once there are four or more ranks (2 ranks give 2x1, 4 give 2x2,
  8 give 4x2); rank ``r * cols + c`` holds grid cell (r, c);
* slab boundaries lie on multiples of 16, so that each slab floor-halves
  through the four pools before tap 29 exactly as the whole image does; an
  odd size floors only at the global bottom and right edge, so the last slab
  in each direction takes the remainder (:func:`slab_bounds`);
* :func:`halo_pad` exchanges one row (and, with a W split, one column) with
  the neighbours before every 3x3 conv and before TV, and pads the global
  border as the single-device trunk does; its backward sends each halo's
  gradient back to the rank that owns those pixels;
* :func:`all_reduce_sum` sums the statistics the losses need (moment sums,
  squared errors) over the ranks; every rank then holds the same values and
  computes the same loss, so its backward is the identity;
* :func:`any_rank_stops` is the ranks' agreement to stop a run together: a
  Ctrl-C reaches each rank at another point of its step, so it only sets
  the rank's ``Mesh.interrupt``, and the engine asks at each chunk end
  whether any rank wants to stop.

A :class:`Mesh` placed on a canvas (:meth:`Mesh.on_canvas`) stands for the
sharding of one image size, as a ``NamedSharding`` of an array does in JAX.
A canvas too small to give every rank 16 rows and columns is not sharded:
``on_canvas`` returns None, and every rank then runs that scale on the whole
image (the engine keeps the ranks equal by taking rank 0's result at the
scale's end).

Transport: NCCL when every rank has a CUDA device of its own; gloo on the
CPU and when ranks share one card. gloo's point-to-point calls take host
tensors only, so there the halo strips are staged through host memory;
its collectives take CUDA tensors.
"""

import contextlib
import math
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "SLAB_ALIGN",
    "Mesh",
    "MeshStats",
    "factor_devices",
    "make_mesh",
    "pick_backend",
    "slab_bounds",
    "largest_slab",
    "shard_image",
    "gather_image",
    "broadcast",
    "halo_pad",
    "all_reduce_sum",
    "all_reduce_",
    "any_rank_stops",
]

# 2^(pools before the deepest tap): slab boundaries on multiples of this
# floor-halve with the whole image through every pool of the trunk.
SLAB_ALIGN = 16
# Pools a tapped activation can have gone through (layers 4, 9, 18, 27).
_MAX_POOLS = 4


def factor_devices(n: int):
    """Factor n into (rows, cols) as square as possible, rows >= cols."""
    best = (n, 1)
    for c in range(1, int(math.isqrt(n)) + 1):
        if n % c == 0:
            best = (n // c, c)
    return best


def pick_backend(devices) -> str:
    """'nccl' when every rank has a CUDA device of its own, else 'gloo' (the
    CPU, or ranks that share a card, which NCCL refuses)."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


@dataclass
class MeshStats:
    """Host time spent in the halo exchanges and the all-reduces (of the
    loss and of the optimizers), each call timed from a synchronised stream
    when the transport is synchronous, and the number of calls."""

    halo_s: float = 0.0
    halo_calls: int = 0
    reduce_s: float = 0.0
    reduce_calls: int = 0


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (rows, cols) grid of ranks.

    ``canvas`` is the global (h, w) of the image the mesh is placed on, set
    by :meth:`on_canvas`; the losses need it for their global counts.
    ``interrupt`` is set when this process is asked to stop (the launcher
    turns SIGINT into it); the mesh placed on a canvas shares it."""

    grid: Tuple[int, int]
    rank: int
    device: torch.device
    backend: str = "gloo"
    canvas: Optional[Tuple[int, int]] = None
    stats: MeshStats = field(default_factory=MeshStats, compare=False)
    interrupt: threading.Event = field(default_factory=threading.Event, compare=False)

    @property
    def world(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def coord(self) -> Tuple[int, int]:
        return divmod(self.rank, self.grid[1])

    def rank_at(self, r: int, c: int) -> Optional[int]:
        rows, cols = self.grid
        if 0 <= r < rows and 0 <= c < cols:
            return r * cols + c
        return None

    def fits(self, h: int, w: int) -> bool:
        """Whether an h x w image gives every rank at least 16 rows and
        16 columns."""
        rows, cols = self.grid
        return h // SLAB_ALIGN >= rows and w // SLAB_ALIGN >= cols

    def on_canvas(self, h: int, w: int) -> Optional["Mesh"]:
        """The mesh placed on an h x w image, or None when the image is too
        small to shard (every rank then holds the whole image)."""
        return replace(self, canvas=(h, w)) if self.fits(h, w) else None

    def _staged(self, t) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _sync(self):
        if self.device.type == "cuda" and self.backend == "gloo":
            torch.cuda.current_stream(self.device).synchronize()

    @contextlib.contextmanager
    def _span(self, kind: str):
        """Adds the block's host time to ``stats`` under ``kind`` ('halo'
        or 'reduce'). The staged (host) transport waits for the device
        anyway; timing it from a synchronised stream keeps the preceding
        layer's kernels out of the span."""
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        setattr(self.stats, f"{kind}_s", getattr(self.stats, f"{kind}_s")
                + time.perf_counter() - t0)
        setattr(self.stats, f"{kind}_calls", getattr(self.stats, f"{kind}_calls") + 1)

    def global_hw(self, x) -> Tuple[int, int]:
        """Global (h, w) of the NCHW activation whose local slab is ``x``:
        the canvas floor-halved once per pool that ``x`` went through."""
        (r0, r1), (c0, c1) = slab_bounds(*self.canvas, self)
        h, w = self.canvas
        for k in range(_MAX_POOLS + 1):
            if (x.shape[-2], x.shape[-1]) == ((r1 >> k) - (r0 >> k), (c1 >> k) - (c0 >> k)):
                return h >> k, w >> k
        raise ValueError(f"activation of local shape {tuple(x.shape)} does not "
                         f"belong to canvas {self.canvas} on this rank")


def make_mesh(device, interrupt: Optional[threading.Event] = None) -> Mesh:
    """The mesh of the initialised (default) process group:
    ``factor_devices`` of its size, this process's rank, and ``device``
    (this rank's own); ``interrupt`` is the event that asks this rank to
    stop (a new one by default)."""
    return Mesh(grid=factor_devices(dist.get_world_size()), rank=dist.get_rank(),
                device=torch.device(device), backend=dist.get_backend(),
                interrupt=threading.Event() if interrupt is None else interrupt)


def _splits(n: int, parts: int):
    """Edges of ``parts`` slabs of ``n``: interior edges on multiples of 16,
    the blocks of 16 shared as evenly as possible (earlier slabs take the
    extra ones), the last slab ending at n."""
    base, extra = divmod(n // SLAB_ALIGN, parts)
    edges = [0]
    for i in range(parts):
        edges.append(edges[-1] + SLAB_ALIGN * (base + (i < extra)))
    edges[-1] = n
    return edges


def slab_bounds(h: int, w: int, mesh: Mesh, coord=None):
    """((r0, r1), (c0, c1)): the rows and columns of an h x w image that
    grid cell ``coord`` (default: this rank's) holds."""
    if not mesh.fits(h, w):
        raise ValueError(f"a {h}x{w} image is too small for a {mesh.grid} mesh "
                         f"(each rank needs {SLAB_ALIGN} rows and columns)")
    r, c = mesh.coord if coord is None else coord
    rows, cols = _splits(h, mesh.grid[0]), _splits(w, mesh.grid[1])
    return (rows[r], rows[r + 1]), (cols[c], cols[c + 1])


def largest_slab(h: int, w: int, mesh: Mesh) -> Tuple[int, int]:
    """(rows, cols) of the largest slab that any rank holds of an h x w
    image: the same on every rank."""
    rows, cols = _splits(h, mesh.grid[0]), _splits(w, mesh.grid[1])
    return (max(b - a for a, b in zip(rows, rows[1:])),
            max(b - a for a, b in zip(cols, cols[1:])))


def shard_image(x, mesh: Optional[Mesh]):
    """This rank's slab of a whole image (any tensor whose last two dims are
    H and W), contiguous on the rank's device; ``x`` itself without a mesh."""
    if mesh is None:
        return x
    (r0, r1), (c0, c1) = slab_bounds(x.shape[-2], x.shape[-1], mesh)
    return x[..., r0:r1, c0:c1].contiguous().to(mesh.device)


def _all_gather(x, mesh: Mesh):
    out = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(out, x.contiguous())
    return out


def gather_image(x, mesh: Optional[Mesh]):
    """The whole image from every rank's slab ``x``, on every rank (a
    collective: every rank calls it); ``x`` itself without a mesh."""
    if mesh is None:
        return x
    h, w = mesh.canvas
    coords = [divmod(r, mesh.grid[1]) for r in range(mesh.world)]
    bounds = [slab_bounds(h, w, mesh, rc) for rc in coords]
    # all_gather moves equal shapes: pad each slab to the largest one.
    hm, wm = largest_slab(h, w, mesh)
    padded = x.new_zeros((*x.shape[:-2], hm, wm))
    padded[..., :x.shape[-2], :x.shape[-1]] = x
    parts = _all_gather(padded, mesh)
    full = x.new_empty((*x.shape[:-2], h, w))
    for part, ((r0, r1), (c0, c1)) in zip(parts, bounds):
        full[..., r0:r1, c0:c1] = part[..., :r1 - r0, :c1 - c0]
    return full


def broadcast(x):
    """Rank 0's ``x`` on every rank (a collective), as a new tensor."""
    x = x.detach().clone().contiguous()
    dist.broadcast(x, 0)
    return x


def all_reduce_(x, mesh: Optional[Mesh], op: str = "sum"):
    """In-place all-reduce (``'sum'`` or ``'max'``) outside autograd, for
    the optimizers' global inner products and norms; returns ``x``."""
    if mesh is not None:
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        with mesh._span("reduce"):
            dist.all_reduce(x, op=ops[op])
    return x


def any_rank_stops(mesh: Mesh, here: bool) -> bool:
    """Whether any rank asks to stop, ``here`` or by its ``interrupt``: one
    all-reduce that every rank calls at the same point of the run, so every
    rank gets the same answer and they all stop after the same chunk."""
    flag = torch.tensor([float(here or mesh.interrupt.is_set())], device=mesh.device)
    return bool(all_reduce_(flag, mesh, op="max").item())


def _exchange(mesh: Mesh, to_prev, to_next, prev, nxt):
    """Sends ``to_prev`` to rank ``prev`` and ``to_next`` to ``nxt`` while
    receiving their counterparts; a missing neighbour (None) sends and
    receives nothing, and its slot comes back as zeros."""
    staged = mesh._staged(to_prev)

    def host(t):
        return t.cpu() if staged else t

    def zeros(t):  # contiguous, as the transport needs
        return torch.zeros(t.shape, dtype=t.dtype, device=t.device)

    from_prev, from_next = zeros(to_prev), zeros(to_next)
    recv_prev, recv_next = host(from_prev), host(from_next)
    ops = []
    if prev is not None:
        ops += [dist.P2POp(dist.isend, host(to_prev.contiguous()), prev),
                dist.P2POp(dist.irecv, recv_prev, prev)]
    if nxt is not None:
        ops += [dist.P2POp(dist.isend, host(to_next.contiguous()), nxt),
                dist.P2POp(dist.irecv, recv_next, nxt)]
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    if staged:
        from_prev = recv_prev.to(to_prev.device) if prev is not None else from_prev
        from_next = recv_next.to(to_next.device) if nxt is not None else from_next
    else:
        from_prev, from_next = recv_prev, recv_next
    return from_prev, from_next


class _Swap(torch.autograd.Function):
    """Edge strips swapped with the two neighbours along one grid axis: the
    strip sent to a neighbour becomes that neighbour's halo. The backward is
    the same swap of the halos' gradients, which lands each one on the rank
    whose strip it belongs to."""

    @staticmethod
    def forward(ctx, to_prev, to_next, mesh, prev, nxt):
        ctx.route = mesh, prev, nxt
        return _exchange(mesh, to_prev, to_next, prev, nxt)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        mesh, prev, nxt = ctx.route
        with mesh._span("halo"):
            g_to_prev, g_to_next = _exchange(mesh, g_prev, g_next, prev, nxt)
        return g_to_prev, g_to_next, None, None, None


def halo_pad(x, mesh: Mesh, replicate: bool = False):
    """This rank's NCHW slab padded by one pixel on each side: the
    neighbours' edge rows and columns inside the image, and at the global
    border the single-device trunk's pad (edge replicate for conv1_1 and
    TV, zero for the other convs). Rows are exchanged first, then the
    columns of the row-extended slab, so the corners come with them. The
    pad is built from slices and ``torch.cat`` (see
    ``ops/pooling.replicate_pad2d``). Under a rematerialised trunk
    (``StepConfig.remat``) a segment's recompute calls this again inside
    the backward, between the exchanges of the halos' gradients: every
    rank runs the same segments, so the ranks make the exchanges in the
    same order."""
    r, c = mesh.coord

    def border(edge):
        return edge if replicate else torch.zeros_like(edge)

    def pad_axis(x, dim, prev, nxt):
        first = x.narrow(dim, 0, 1)
        last = x.narrow(dim, x.shape[dim] - 1, 1)
        if prev is None and nxt is None:
            lo, hi = border(first), border(last)
        else:
            with mesh._span("halo"):
                lo, hi = _Swap.apply(first, last, mesh, prev, nxt)
            lo = lo if prev is not None else border(first)
            hi = hi if nxt is not None else border(last)
        return torch.cat([lo, x, hi], dim=dim)

    x = pad_axis(x, 2, mesh.rank_at(r - 1, c), mesh.rank_at(r + 1, c))
    return pad_axis(x, 3, mesh.rank_at(r, c - 1), mesh.rank_at(r, c + 1))


class _AllReduceSum(torch.autograd.Function):
    """Sums over the ranks in one all-reduce. Every rank computes the same
    loss from the summed values, so the gradient of each rank's own
    contribution is the gradient of the sum: the backward is the identity.
    (``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient
    too, which here would multiply every gradient by the world size.)"""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        with mesh._span("reduce"):
            dist.all_reduce(flat)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view_as(t).clone())
            at += t.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


def all_reduce_sum(mesh: Optional[Mesh], *tensors):
    """The tensors summed over the ranks (one all-reduce, differentiable);
    the tensors themselves without a mesh. Returns a tuple."""
    if mesh is None:
        return tensors
    return _AllReduceSum.apply(mesh, *tensors)
