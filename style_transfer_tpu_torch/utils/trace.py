"""Iteration telemetry, and the program's spans and counters.

Port of ``style_transfer_tpu/utils/trace.py`` (reference progress contract,
``style_transfer.py:298-307`` and ``cli.py:107-140``): one ``STIterate`` per
optimization iteration and a ``trace.json`` with the run args plus all
iterates.

``gpu_ram`` is ``torch.cuda.max_memory_allocated`` of the device, whose peak
the engine resets at the start of each scale: the figure is the peak of the
scale the iterate belongs to (0 on the CPU).

The span recorder (:class:`SpanRecorder`; the process's own is
:data:`RECORDER`, reached through :func:`span`, :func:`host_wait`,
:func:`counter`, :func:`phase_totals` and :func:`events`) is always on. It
keeps, in a bounded ring of :class:`Event`:

* spans: a phase of the engine or the step runner, with its parent's index,
  stamped in ns on ``time.time_ns()``'s base (one anchor to the monotonic
  clock, taken at import), the base of ``torch.profiler``'s raw events
  (``start_ns()``), so that a span and the device's operations share one
  clock. A span also adds its seconds to the phase totals, and with a
  ``device`` ends in a synchronize of it, so that its device work is inside
  it. While a profiler runs, a span also opens a profiler range of its name
  (an op's range, which the host's events show);
* ``host_wait``s: each point where the host blocks on the device (a span's
  closing synchronize, a chunk's read of its losses, the synchronize before
  a capture, a read of the image, the zoom line search's read of ``go``
  after each of its trials but a search's last permitted one), with the
  time it blocked;
* ``sections``: the step runner's section times of one graph replay, in
  ms, stamped with the replay's launch (the zoom runner's: ``trial``, one
  replay of its trial graph);
* ``counter``s: a named value the program records where it decides
  something, stamped when it does: ``trunk-layout``, the memory format a
  call of the VGG trunk ran (``channels_last`` or ``nchw``), once a call
  (an eager call, a warm-up or a capture; a replay runs no Python);
  ``zoom-trials``, the line-search trials one call of the zoom runner ran
  (eager or replayed), at the call's end; ``ns-groups``, at each grouped
  launch of the NS kernel B1 (``ops/cuda/ns_sqrtm.py``, on a card: one a
  loss evaluation, eager or captured), ``{"groups": k, "blocks": [[G, C,
  blocks], ...]}``, the launch's groups and each one's planned blocks.

``STT_DEBUG_TIMING`` prints each span's time as it ends, and each counter.
"""

import collections
import contextlib
import itertools
import json
import os
import threading
import time
import weakref
from dataclasses import asdict, dataclass

import torch

__all__ = ["STIterate", "TraceRecorder", "peak_device_ram", "reset_peak_device_ram",
           "DEBUG_TIMING", "Event", "SpanRecorder", "RECORDER", "now_ns", "span",
           "host_wait", "counter", "phase_totals", "events", "self_ns"]

DEBUG_TIMING = bool(os.environ.get("STT_DEBUG_TIMING"))

SPAN, HOST_WAIT, SECTIONS, COUNTER = "span", "host_wait", "sections", "counter"

_EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def now_ns() -> int:
    """Now in ns on ``time.time_ns()``'s base, by the monotonic clock."""
    return time.perf_counter_ns() + _EPOCH_OFFSET_NS


@dataclass
class STIterate:
    w: int
    h: int
    i: int
    i_max: int
    loss: float
    time: float
    gpu_ram: int


def reset_peak_device_ram(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_device_ram(device) -> int:
    """Peak bytes allocated on ``device`` since the last reset (0 off CUDA)."""
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


class TraceRecorder:
    """Accumulates iterates; serializes to the reference's trace.json schema."""

    def __init__(self, args=None):
        self.args = args
        self.iterates = []

    def append(self, iterate: STIterate):
        self.iterates.append(asdict(iterate))

    def get_trace(self):
        args = self.args
        if args is not None and not isinstance(args, dict):
            args = dict(args.__dict__)
        return {"args": args, "iterates": self.iterates}

    def write(self, path="trace.json"):
        with open(path, "w") as fp:
            json.dump(self.get_trace(), fp, indent=4)


class Event:
    """One record of the ring: ``kind`` (``span``, ``host_wait``,
    ``sections`` or ``counter``), ``index`` (one more than the record
    before), ``name``, ``parent`` (the index of the span open around it on
    its thread, or None), ``start_ns`` and ``end_ns`` (None while a span is
    open; a sample's and a counter's are its stamp), and ``value`` (a
    sample's {section: ms}, a counter's value)."""

    __slots__ = ("kind", "index", "name", "parent", "start_ns", "end_ns", "value")

    def __init__(self, kind, index, name, parent, start_ns, end_ns=None, value=None):
        self.kind, self.index, self.name, self.parent = kind, index, name, parent
        self.start_ns, self.end_ns, self.value = start_ns, end_ns, value


class SpanRecorder:
    """Spans, host waits, section samples and counters in a ring of
    ``capacity`` records (the oldest go first), and the seconds of each
    span name. A default 512x384 image records about 280 (its spans, 102
    host waits, 20 ``trunk-layout`` and 10 ``ns-groups`` counters), so the
    ring holds the last 230 or so."""

    def __init__(self, capacity: int = 1 << 16):
        self._ring = collections.deque(maxlen=capacity)
        self._index = itertools.count()
        self._open = threading.local()
        self._totals = {}
        self._sampler = None

    def _stack(self):
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def _record(self, kind, name, start_ns, end_ns=None, value=None):
        stack = self._stack()
        ev = Event(kind, next(self._index), name, stack[-1] if stack else None, start_ns,
                   end_ns, value)
        self._ring.append(ev)
        return ev

    @contextlib.contextmanager
    def span(self, name: str, device=None):
        """A span named ``name`` around the block; with a ``device`` the
        block ends in a synchronize of it (on a CUDA device; the host wait
        is recorded on every device). Its seconds go to the phase totals
        whether the block raises or not."""
        ev = self._record(SPAN, name, now_ns())
        stack = self._stack()
        stack.append(ev.index)
        profiled = torch._C._autograd._profiler_enabled()
        if profiled:
            # An op's range, not ``record_function``'s user annotation: the
            # profiler mirrors an annotation on the device as an event over
            # the kernels launched inside it, which would read as device work.
            rf = torch._C._profiler._RecordFunctionFast(name)
            rf.__enter__()
        ok = False
        try:
            yield ev
            ok = True
        finally:
            try:
                if ok and device is not None:
                    with self.host_wait("sync"):
                        if device.type == "cuda":
                            torch.cuda.synchronize(device)
            finally:
                if profiled:
                    rf.__exit__(None, None, None)
                stack.pop()
                ev.end_ns = now_ns()
                self._add(name, ev.end_ns - ev.start_ns)

    def _add(self, name, ns):
        self._totals[name] = self._totals.get(name, 0.0) + ns / 1e9
        if DEBUG_TIMING:
            print(f"[timing] {name}: {ns / 1e9:.2f}s @{time.time():.2f}", flush=True)

    @contextlib.contextmanager
    def host_wait(self, name: str):
        """A host wait named ``name``: the block blocks the host on the
        device."""
        ev = self._record(HOST_WAIT, name, now_ns())
        try:
            yield ev
        finally:
            ev.end_ns = now_ns()

    def sample(self, name: str, stamp_ns: int, value: dict):
        """Records ``value`` (section: ms) stamped ``stamp_ns``."""
        self._record(SECTIONS, name, stamp_ns, stamp_ns, value)

    def counter(self, name: str, value):
        """Records counter ``name`` at ``value``, stamped now."""
        stamp = now_ns()
        self._record(COUNTER, name, stamp, stamp, value)
        if DEBUG_TIMING:
            print(f"[counter] {name}: {value}", flush=True)

    def set_sampler(self, method):
        """``method`` (a bound method, held weakly) is called before the
        ring is read, to record what it holds back."""
        self._sampler = weakref.WeakMethod(method)

    def events(self) -> list:
        """The ring's records, oldest first, after the sampler's."""
        sampler = self._sampler() if self._sampler is not None else None
        if sampler is not None:
            sampler()
        return list(self._ring)

    def totals(self, reset: bool = False) -> dict:
        """Snapshot {span name: cumulative seconds}; optionally reset."""
        out = dict(self._totals)
        if reset:
            self._totals.clear()
        return out


def self_ns(records) -> dict:
    """{span index: its duration less the time its child spans cover}, over
    closed spans among ``records``."""
    spans = [e for e in records if e.kind == SPAN and e.end_ns is not None]
    out = {e.index: e.end_ns - e.start_ns for e in spans}
    for e in spans:
        if e.parent in out:
            out[e.parent] -= e.end_ns - e.start_ns
    return out


RECORDER = SpanRecorder()


def span(name: str, device=None):
    return RECORDER.span(name, device)


def host_wait(name: str):
    return RECORDER.host_wait(name)


def counter(name: str, value):
    RECORDER.counter(name, value)


def phase_totals(reset: bool = False) -> dict:
    return RECORDER.totals(reset)


def events() -> list:
    return RECORDER.events()
