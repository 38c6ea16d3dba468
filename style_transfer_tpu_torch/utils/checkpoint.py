"""Checkpoint / resume.

Port of ``style_transfer_tpu/utils/checkpoint.py``, file format v3 and all:
the full optimization state (image iterate, Adam moments and step count or
the L-BFGS state, the EMA state and its accumulator, the pyramid position
and the host RNG) as one ``.npz``. The layout is the JAX package's, so a
checkpoint written by either package resumes in the other: images and
image-shaped state are NHWC (``image``, ``adam_mu``/``adam_nu``,
``ema_value`` (1, H, W, 3); ``lbfgs_s_hist``/``lbfgs_y_hist`` (m, 1, H, W,
3)), and the engine converts its NCHW tensors at this boundary.

Arrays may be torch tensors on any device: they are fetched to the host
where they are written, so on the ``AsyncCheckpointWriter`` thread the
device-to-host copy runs off the iteration loop. This module imports torch
only to fetch CUDA tensors.
"""

import json
import sys
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "pack_rng_state",
    "unpack_rng_state",
    "AsyncCheckpointWriter",
]

_FORMAT_VERSION = 3  # v3 adds L-BFGS states (lbfgs_* arrays); v1/v2 still load


def _host(x):
    """A host ndarray of ``x``; a torch tensor is fetched from its device
    here."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _is_cuda(x):
    return getattr(x, "is_cuda", False)


def _leaves(state):
    """The values of a submitted state, NamedTuples (AdamState, EMAState,
    LBFGSState) opened one level."""
    for v in state.values():
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            yield from v
        else:
            yield v


def _ready_event(state):
    """(event, device): an event recorded on the submitting thread's current
    stream if ``state`` holds CUDA tensors, else None. The writer's fetch
    waits on it alone, not on the work queued after the submit."""
    tensor = next((x for x in _leaves(state) if _is_cuda(x)), None)
    if tensor is None:
        return None
    torch = sys.modules["torch"]
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensor.device))
    return event, tensor.device


def _fetch_cuda(state, ready):
    """``state`` with its CUDA tensors copied into pinned host tensors on a
    side stream that waits on ``ready``. The copy engine then runs beside
    the compute on the default stream, where a plain ``.cpu()`` would queue
    behind that compute and hold the stream for the copy."""
    torch = sys.modules["torch"]
    event, device = ready
    stream = torch.cuda.Stream(device=device)
    stream.wait_event(event)

    def fetch(x):
        if not _is_cuda(x):
            return x
        with torch.cuda.stream(stream):
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
        x.record_stream(stream)
        return host

    out = {}
    for k, v in state.items():
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out[k] = type(v)(*(fetch(f) for f in v))
        else:
            out[k] = fetch(v)
    stream.synchronize()
    return out


def pack_rng_state(rng):
    """np.random.RandomState -> JSON-safe header dict + uint32 key array."""
    kind, keys, pos, has_gauss, cached = rng.get_state()
    return (
        {"kind": kind, "pos": int(pos), "has_gauss": int(has_gauss),
         "cached_gaussian": float(cached)},
        np.asarray(keys, np.uint32),
    )


def unpack_rng_state(rng, header, keys):
    rng.set_state((
        header["kind"], np.asarray(keys, np.uint32), int(header["pos"]),
        int(header["has_gauss"]), float(header["cached_gaussian"]),
    ))


def save_checkpoint(path, *, image, ema, scale_index, done_iters,
                    adam=None, lbfgs=None, meta=None, optimizer="adam",
                    rng=None):
    """Atomically write the optimization state to ``path`` (.npz).

    Exactly one of ``adam`` (an AdamState) or ``lbfgs`` (an LBFGSState, any
    NamedTuple of arrays; its fields are stored as ``lbfgs_<field>``) must
    be given. Arrays are written as given: the caller passes them NHWC.
    """
    if (adam is None) == (lbfgs is None):
        raise ValueError("exactly one of adam= / lbfgs= is required")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    header = {
        "version": _FORMAT_VERSION,
        "scale_index": int(scale_index),
        "done_iters": int(done_iters),
        "optimizer": optimizer,
        "meta": meta or {},
    }
    arrays = {
        "image": _host(image),
        "ema_value": _host(ema.value),
        "ema_accum": _host(ema.accum),
    }
    if adam is not None:
        arrays.update(
            adam_mu=_host(adam.mu),
            adam_nu=_host(adam.nu),
            adam_count=np.asarray(_host(adam.count), np.int32),
        )
    else:
        header["lbfgs_fields"] = list(lbfgs._fields)
        for name in lbfgs._fields:
            arrays[f"lbfgs_{name}"] = _host(getattr(lbfgs, name))
    if rng is not None:
        rng_header, rng_keys = pack_rng_state(rng)
        header["rng"] = rng_header
        arrays["rng_keys"] = rng_keys
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.replace(path)


class AsyncCheckpointWriter:
    """Background-thread checkpoint writer with a single-slot queue.

    The device-to-host fetch and the serialize-and-write of a print-size
    checkpoint (hundreds of MB of .npz) run on a worker thread, off the
    iteration loop. Only the *newest* submitted state is kept: if a write
    is still in flight when the next one arrives, the pending slot is
    replaced (a checkpoint is a recovery point, not a log). Submitted
    tensors must not be modified in place afterwards; the engine submits
    copies, since its runners write the state in place.

    ``flush()`` blocks until the slot is empty and no write is in flight;
    call it before process exit (and on interrupt) so the last submitted
    state is durable.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._pending = None  # (args, kwargs) | None
        self._busy = False
        self._closed = False
        self.error = None  # last write failure, surfaced on flush
        self._thread = threading.Thread(
            target=self._run, name="stt-checkpoint", daemon=True
        )
        self._thread.start()

    def _run(self):
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._pending is None and self._closed:
                    return
                args, kwargs, ready = self._pending
                self._pending = None
                self._busy = True
            try:
                if ready is not None:
                    kwargs = _fetch_cuda(kwargs, ready)
                save_checkpoint(*args, **kwargs)
            except Exception as err:  # surfaced on flush; keep the loop alive
                self.error = err
            finally:
                del args, kwargs, ready  # release the snapshot's tensors now
            with self._cond:
                self._busy = False
                self._cond.notify_all()

    def submit(self, path, **state):
        """Queue ``state`` (save_checkpoint's keywords) for ``path``. Call it
        on the thread that produced the state's tensors."""
        ready = _ready_event(state)
        with self._cond:
            self._pending = ((path,), state, ready)
            self._cond.notify_all()

    def flush(self):
        """Wait for the queue to drain; raise if the last write failed."""
        with self._cond:
            while self._pending is not None or self._busy:
                self._cond.wait()
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def close(self):
        try:
            self.flush()
        finally:
            with self._cond:
                self._closed = True
                self._cond.notify_all()
            self._thread.join(timeout=5)


def load_checkpoint(path):
    """Returns a dict with image/adam_*/ema_*/lbfgs_* arrays and header fields."""
    with np.load(path) as f:
        out = {k: f[k] for k in f.files}
    header = json.loads(bytes(out.pop("header")).decode())
    if header.get("version") not in (1, 2, _FORMAT_VERSION):
        raise ValueError(f"unsupported checkpoint version: {header.get('version')}")
    header.setdefault("optimizer", "adam")
    out.update(header)
    return out
