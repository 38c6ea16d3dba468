"""The program's own record against a traced stretch: the spans, host
waits and section samples of its recorder
(``style_transfer_tpu_torch/utils/trace.py``, ``RECORDER``), for the
metrics that read them. A program without the recorder gives these metrics
nothing to read: they return None.

The recorder stamps on ``time.time_ns()``'s base, which the profiler's host
events share (``_kernels.read_profile``; its runtime calls agree with the
recorder's host waits to tens of us on the card). Its device operations do
not always: on the H100 their stamps drifted from the host's by tens of ms
a second and stepped back within one stretch (PERF.md §6). So device times
are put on the host's clock first, by anchors where the host waited for
the device: each chunk's read of its losses and the read of the final
image (host wait end against the end of the nearest ``Memcpy DtoH``), and
each synchronize that waited at least ``MIN_WAIT_NS`` (against the nearest
end of a busy interval), matched in order against the offset so far;
between anchors the offset is interpolated.

* Pyramid cells (``engine_idle_s``, ``runner_idle_s``,
  ``host_waits_per_image``): the spans inside the stretch's host events.
  Each idle gap of at least ``_kernels.SMALL_GAP_NS`` between the device's
  busy intervals goes to the innermost span that holds its midpoint, by the
  span's family (its name up to ``@`` or ``:``, spaces stripped). First the
  clocks are held to what the program guarantees: a cuSOLVER eigh kernel
  lies inside a ``targets@S`` span and an ``stt_nsk_`` kernel inside a
  chunk; one more than ``CLOCK_SLACK_NS`` outside means the clocks
  disagree, and the reader raises.
* Step cells (``forward_ms`` and the like): the median over the section
  samples stamped inside the stretch's host events, one a chunk (the
  runner's last replay of it).
"""

import bisect
import statistics

import numpy as np

from benchmark.metrics._kernels import NS, SMALL_GAP_NS, bucket

__all__ = ["ENGINE", "RUNNER", "family", "recorded", "host_range", "Clock", "innermost",
           "idle_ns_by_family", "check_clocks", "idle_s", "host_waits_per_image",
           "section_ms"]

ENGINE = ("prologue", "targets", "scale-entry", "scale-exit", "callbacks", "ckpt-snapshot",
          "final-image")
RUNNER = ("chunk1", "chunk", "warm-up", "capture")
CHUNKS = ("chunk1", "chunk")
EIGH = "eigh (cuSOLVER)"
# How far, once aligned, a kernel's midpoint may lie outside the span that
# launched it before the clocks count as disagreeing.
CLOCK_SLACK_NS = 5_000_000
# A synchronize that waited this long had the device busy until just
# before it returned.
MIN_WAIT_NS = 50_000
# How far an anchor may lie from where the offset so far puts it: a read's
# copy is the only one in its chunk, a synchronize's end has others near.
READ_WINDOW_NS = 40_000_000
SYNC_WINDOW_NS = 2_000_000
READS = ("losses", "image")


def family(name):
    return name.strip().split("@")[0].split(":")[0]


def recorded():
    """The program's records, oldest first, or None where it has no
    recorder."""
    try:
        from style_transfer_tpu_torch.utils import trace
        recorder = trace.RECORDER
    except (ImportError, AttributeError):
        return None
    return recorder.events()


def host_range(trace):
    """The stretch on the host's clock: its host events' first start and
    last end, or (without host events) its operations'."""
    if trace.host:
        return trace.host[0][1], max(e for _, _, e in trace.host)
    return trace.ops[0][1], max(s + d for _, s, d in trace.ops)


def _nearest(pool, want, window):
    k = bisect.bisect_left(pool, want)
    near = [pool[j] for j in (k - 1, k) if 0 <= j < len(pool)]
    best = min(near, key=lambda t: abs(t - want), default=None)
    return best if best is not None and abs(best - want) <= window else None


class Clock:
    """Device times to the host's clock, by the anchors of the program's
    host waits (see above): ``anchors`` [(device ns, host minus device
    ns)]."""

    def __init__(self, trace, waits):
        copies = sorted(s + d for n, s, d in trace.ops if n.startswith("Memcpy DtoH"))
        ends = [e for _, e in trace.busy]
        offset, self.anchors = 0, []
        for w in sorted(waits, key=lambda w: w.end_ns):
            if w.name in READS:
                got = _nearest(copies, w.end_ns - offset, READ_WINDOW_NS)
            elif w.end_ns - w.start_ns >= MIN_WAIT_NS:
                got = _nearest(ends, w.end_ns - offset, SYNC_WINDOW_NS)
            else:
                continue
            if got is None or (self.anchors and got <= self.anchors[-1][0]):
                continue
            offset = w.end_ns - got
            self.anchors.append((got, offset))
        self._base = trace.ops[0][1]
        self._at = np.array([a - self._base for a, _ in self.anchors] or [0], np.float64)
        self._off = np.array([o for _, o in self.anchors] or [0], np.float64)

    def to_host(self, times):
        """Host ns of device ``times`` (the offset interpolated between
        anchors, held beyond them)."""
        t = np.asarray(times, np.int64)
        return t + np.rint(np.interp(t - self._base, self._at, self._off)).astype(np.int64)


def innermost(spans, points):
    """For each of the sorted ``points``, the innermost of ``spans`` that
    holds it, or None. Spans nest, as one thread records them."""
    spans = sorted(spans, key=lambda e: (e.start_ns, -e.end_ns))
    out, stack, k = [], [], 0
    for t in points:
        while k < len(spans) and spans[k].start_ns <= t:
            while stack and stack[-1].end_ns < spans[k].start_ns:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1].end_ns < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def idle_ns_by_family(trace, spans, clock):
    """{span family, or None outside every span: idle ns} over the gaps of
    at least ``SMALL_GAP_NS`` between the stretch's busy intervals, each
    placed on the host's clock by its midpoint."""
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(trace.busy, trace.busy[1:])
            if s1 - e0 >= SMALL_GAP_NS]
    mids = clock.to_host([(a + b) // 2 for a, b in gaps]).tolist()
    out = {}
    for (a, b), owner in zip(gaps, innermost(spans, mids)):
        key = None if owner is None else family(owner.name)
        out[key] = out.get(key, 0) + b - a
    return out


def check_clocks(trace, spans, clock):
    """Raises where a cuSOLVER eigh kernel lies outside every ``targets@S``
    span or an ``stt_nsk_`` kernel outside every chunk, by its midpoint on
    the host's clock, by more than ``CLOCK_SLACK_NS``."""
    def holders(keep):
        ivs = sorted((e.start_ns - CLOCK_SLACK_NS, e.end_ns + CLOCK_SLACK_NS)
                     for e in spans if keep(e.name))
        return [a for a, _ in ivs], ivs

    rules = {EIGH: ("targets@S", holders(lambda n: n.startswith("targets@"))),
             NS: ("chunk", holders(lambda n: family(n) in CHUNKS))}
    kinds, checked = {}, []
    for name, s, d in trace.ops:
        kind = kinds.get(name)
        if kind is None:
            kind = kinds[name] = bucket(name)
        if kind in rules:
            checked.append((kind, name, s + d // 2))
    mids = clock.to_host([m for _, _, m in checked]).tolist()
    for (kind, name, _), mid in zip(checked, mids):
        where, (starts, ivs) = rules[kind]
        k = bisect.bisect_right(starts, mid) - 1
        if k < 0 or ivs[k][1] < mid:
            raise RuntimeError(f"a {kind} kernel ({name[:60]}) at {mid} ns lies outside every "
                               f"{where} span: the program's clock and the device trace's "
                               f"disagree ({len(clock.anchors)} anchors)")


def _pyramid(ctx):
    """(the spans inside the stretch, every record, the clock), checked
    once a context; None where there is nothing to read."""
    trace = ctx["trace"]
    if ctx["kind"] != "pyramid" or trace is None or not trace.ops:
        return None
    if "_program_spans" not in ctx:
        records = recorded()
        if records is None:
            ctx["_program_spans"] = None
        else:
            lo, hi = host_range(trace)
            spans = [e for e in records if e.kind == "span" and e.end_ns is not None
                     and e.end_ns >= lo and e.start_ns <= hi]
            if not spans:
                raise RuntimeError("no span of the program lies inside the traced stretch: the "
                                   "program's clock and the profiler's disagree")
            waits = [e for e in records if e.kind == "host_wait" and lo <= e.start_ns <= hi]
            clock = Clock(trace, waits)
            check_clocks(trace, spans, clock)
            ctx["_program_spans"] = (spans, records, clock)
    return ctx["_program_spans"]


def idle_s(ctx, families):
    """Idle s an image in gaps of at least ``SMALL_GAP_NS`` whose innermost
    span is of one of ``families``."""
    got = _pyramid(ctx)
    if got is None:
        return None
    spans, _, clock = got
    idle = idle_ns_by_family(ctx["trace"], spans, clock)
    return sum(v for k, v in idle.items() if k in families) / 1e9 / ctx["traffic"]["trace_images"]


def host_waits_per_image(ctx):
    """The host waits between the first start and the last end of the
    stretch's outermost spans, an image."""
    got = _pyramid(ctx)
    if got is None:
        return None
    spans, records, _ = got
    held = {e.index for e in spans}
    top = [e for e in spans if e.parent not in held]
    lo, hi = min(e.start_ns for e in top), max(e.end_ns for e in top)
    waits = sum(1 for e in records if e.kind == "host_wait" and lo <= e.start_ns <= hi)
    return waits / ctx["traffic"]["trace_images"]


def section_ms(ctx, name):
    """The median of section ``name`` over the samples stamped inside the
    stretch's host events, in ms."""
    trace = ctx["trace"]
    if ctx["kind"] != "step" or trace is None or not trace.ops:
        return None
    records = recorded()
    if records is None:
        return None
    lo, hi = host_range(trace)
    values = [e.value[name] for e in records if e.kind == "sections" and lo <= e.start_ns <= hi]
    if not values:
        raise RuntimeError("the program recorded no section sample inside the traced stretch")
    return statistics.median(values)
