"""The zoom runner's own record against a step cell's traced stretch, for
``evals_per_iter``, ``trial_ms``, ``ls_idle_ms`` and
``trunk_roofline.zoom``: its ``go`` host waits (one for each read of the
line search's ``go`` before a trial after the first), its ``zoom-trials``
counters (the trials of one runner call, stamped at its end) and
its ``trial`` samples (the device ms of one trial-graph replay, once a
chunk while the profiler runs), from the recorder
(``style_transfer_tpu_torch/utils/trace.py``).

The device trace is put on the host's clock by ``_spans.Clock``, anchored
at the ``go`` waits as at a chunk's read of its losses: each is the read
of a device value, whose ``Memcpy DtoH`` ends as the wait does. The
stretch is then the host's span from its first device operation to its
last, and a counter or a sample stamped inside it (the last chunk's counter
up to ``_spans.CLOCK_SLACK_NS`` past it) belongs to the stretch. A program without the recorder, or whose
runner records none of these, gives the metrics nothing to read: they
return None.
"""

import statistics
from types import SimpleNamespace

from benchmark.metrics import _spans
from benchmark.metrics._kernels import SMALL_GAP_NS

__all__ = ["stretch", "evals_per_iter", "trial_ms", "ls_idle_ns"]

GO, TRIALS, TRIAL = "go", "zoom-trials", "trial"


def stretch(ctx):
    """{"waits", "counters", "samples", "clock", "lo", "hi"} of a step cell's
    traced stretch (the waits inside it; the counters and samples of the
    whole record), read once a context; None where there is nothing to
    read."""
    trace = ctx["trace"]
    if ctx["kind"] != "step" or trace is None or not trace.ops:
        return None
    if "_zoom" not in ctx:
        records = _spans.recorded()
        got = None
        if records is not None:
            lo, hi = _spans.host_range(trace)
            waits = [e for e in records if e.kind == "host_wait" and e.name == GO
                     and lo <= e.start_ns <= hi]
            counters = [e for e in records if e.kind == "counter" and e.name == TRIALS]
            samples = [e for e in records if e.kind == "sections" and TRIAL in e.value]
            if waits or counters or samples:
                reads = [SimpleNamespace(name=_spans.READS[0], start_ns=w.start_ns,
                                         end_ns=w.end_ns) for w in waits]
                clock = _spans.Clock(trace, reads)
                first = trace.ops[0][1]
                last = max(s + d for _, s, d in trace.ops)
                lo, hi = (int(t) for t in clock.to_host([first, last]))
                got = {"waits": waits, "counters": counters, "samples": samples,
                       "clock": clock, "lo": lo, "hi": hi}
        ctx["_zoom"] = got
    return ctx["_zoom"]


def _inside(got, records):
    return [e for e in records
            if got["lo"] <= e.start_ns <= got["hi"] + _spans.CLOCK_SLACK_NS]


def evals_per_iter(ctx):
    """Loss evaluations an iteration over the stretch: 1 (the head) plus the
    trials, from the ``zoom-trials`` counters stamped inside it (one a
    runner call, one or more a chunk), over its ``traced_iterations``."""
    got = stretch(ctx)
    if got is None or not got["counters"]:
        return None
    mine = _inside(got, got["counters"])
    if not mine:
        raise RuntimeError("the program recorded no zoom-trials counter inside the traced "
                           "stretch")
    return 1.0 + sum(e.value for e in mine) / ctx["traced_iterations"]


def trial_ms(ctx):
    """The median over the ``trial`` samples stamped inside the stretch."""
    got = stretch(ctx)
    if got is None or not got["samples"]:
        return None
    mine = _inside(got, got["samples"])
    if not mine:
        raise RuntimeError("the program recorded no trial sample inside the traced stretch")
    return statistics.median(e.value[TRIAL] for e in mine)


def ls_idle_ns(ctx):
    """Device idle ns over the stretch in gaps of at least
    ``_kernels.SMALL_GAP_NS`` that open at a ``go`` read: the gap's start
    (the end of the read's copy), on the host's clock, lies inside a ``go``
    wait or within ``_kernels.SMALL_GAP_NS`` past its end. The device then
    idles until the host, having read ``go``, launches the next trial or the
    tail."""
    got = stretch(ctx)
    if got is None or not got["waits"]:
        return None
    trace = ctx["trace"]
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(trace.busy, trace.busy[1:])
            if s1 - e0 >= SMALL_GAP_NS]
    reads = [SimpleNamespace(start_ns=w.start_ns, end_ns=w.end_ns + SMALL_GAP_NS)
             for w in got["waits"]]
    starts = got["clock"].to_host([a for a, _ in gaps]).tolist()
    order = sorted(range(len(gaps)), key=starts.__getitem__)
    owners = _spans.innermost(reads, [starts[k] for k in order])
    return sum(gaps[k][1] - gaps[k][0] for k, owner in zip(order, owners) if owner is not None)
