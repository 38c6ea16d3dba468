"""The readers of the program's own record (``metrics/_spans.py``) on a
made-up device trace and made-up spans: each idle gap goes to the innermost
span at its midpoint, gaps under 20 us to none, a kernel outside the span
that must hold it raises, the section metrics take the median of the
samples inside the stretch, and a program without the recorder gives
nothing."""

from types import SimpleNamespace

import pytest

from benchmark.harness import _reader
from benchmark.metrics import _spans
from benchmark.metrics._kernels import Trace

US = 1_000
NS_KERNEL = "void stt::(anonymous namespace)::stt_nsk_ns_cluster<64>(float const*)"
EIGH_KERNEL = "void syevj_parallel_order_set_kernel<float>(int, int*)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4>"


def _span(index, name, start, end, parent=None):
    return SimpleNamespace(kind="span", index=index, name=name, parent=parent,
                           start_ns=start * US, end_ns=end * US, value=None)


def _wait(index, name, at, parent):
    return SimpleNamespace(kind="host_wait", index=index, name=name, parent=parent,
                           start_ns=at * US, end_ns=at * US + 5 * US, value=None)


# One image: prologue 0-100 us, targets 100-500 (its finalize 300-500),
# the first chunk 500-1000 (its capture 600-700), final-image 1000-1100.
SPANS = [_span(0, "prologue", 0, 100), _span(1, "targets@64", 100, 500),
         _span(2, "  targets:finalize", 300, 500, parent=1),
         _span(3, "chunk1@64x2", 500, 1000), _span(4, "  capture@64", 600, 700, parent=3),
         _span(5, "final-image", 1000, 1100)]
WAITS = [_wait(6, "sync", 90, 0), _wait(7, "sync", 490, 1), _wait(8, "capture-sync", 590, 3),
         _wait(9, "losses", 990, 3), _wait(10, "image", 1050, 5),
         _wait(11, "losses", 5000, None)]  # a later image's


def _ops():
    # Busy: 10-20, 60-280, 290-295 (a 10 us gap before it), 400-640,
    # 680-1080, 1300-1310. Gaps: 20-60 (prologue), 280-290 (under 20 us),
    # 295-400 (midpoint 347.5: finalize), 640-680 (midpoint 660: capture),
    # 1080-1300 (midpoint 1190: no span).
    return [(ELEMENTWISE, 10 * US, 10 * US), (ELEMENTWISE, 60 * US, 220 * US),
            (ELEMENTWISE, 290 * US, 5 * US), (EIGH_KERNEL, 400 * US, 50 * US),
            (ELEMENTWISE, 450 * US, 190 * US), (NS_KERNEL, 680 * US, 300 * US),
            (ELEMENTWISE, 980 * US, 100 * US), (ELEMENTWISE, 1300 * US, 10 * US)]


def _ctx(ops=None, images=1, kind="pyramid"):
    return {"kind": kind, "trace": Trace(ops or _ops(), [], 0.0015),
            "traffic": {"trace_images": images}}


@pytest.fixture
def program(monkeypatch):
    """The program's record, as the readers see it."""
    records = list(SPANS + WAITS)
    monkeypatch.setattr(_spans, "recorded", lambda: records)
    return records


def _idle(trace, spans):
    return _spans.idle_ns_by_family(trace, spans, _spans.Clock(trace, []))


def test_each_gap_goes_to_the_innermost_span_at_its_midpoint(program):
    idle = _idle(_ctx()["trace"], SPANS)
    assert idle == {"prologue": 40 * US, "targets": 105 * US, "capture": 40 * US,
                    None: 220 * US}


def test_gaps_under_20_us_are_left_out(program):
    idle = _idle(_ctx()["trace"], SPANS)
    assert sum(idle.values()) == (40 + 105 + 40 + 220) * US  # not the 10 us gap


def test_innermost_span_by_midpoint_alone():
    spans = [_span(0, "a", 0, 100), _span(1, "b", 10, 50, parent=0),
             _span(2, "c", 20, 30, parent=1), _span(3, "d", 60, 70, parent=0)]
    points = [5 * US, 25 * US, 40 * US, 55 * US, 65 * US, 100 * US, 101 * US]
    got = [None if s is None else s.name for s in _spans.innermost(spans, points)]
    assert got == ["a", "c", "b", "a", "d", "a", None]


def test_engine_and_runner_idle_per_image(program):
    assert _reader("engine_idle_s")(_ctx()) == pytest.approx((40 + 105) * 1e-6)
    assert _reader("runner_idle_s")(_ctx()) == pytest.approx(40e-6)
    assert _reader("runner_idle_s")(_ctx(images=2)) == pytest.approx(20e-6)


def test_host_waits_inside_the_image(program):
    assert _reader("host_waits_per_image")(_ctx()) == 5
    assert _reader("host_waits_per_image")(_ctx(images=5)) == 1


@pytest.mark.parametrize("kernel,at,where", [
    (EIGH_KERNEL, 700, "targets@S"),  # in the first chunk
    (NS_KERNEL, 200, "chunk"),  # in the targets
    (NS_KERNEL, 3000, "chunk"),  # in no span near the stretch
])
def test_a_kernel_outside_its_span_raises(program, monkeypatch, kernel, at, where):
    monkeypatch.setattr(_spans, "CLOCK_SLACK_NS", 10 * US)  # this timeline's scale
    ops = _ops() + [(kernel, at * US, 5 * US)]
    with pytest.raises(RuntimeError, match=where):
        _reader("engine_idle_s")(_ctx(ops))


def test_the_clock_slack_is_five_milliseconds(program):
    late = 1000 * US + _spans.CLOCK_SLACK_NS - 10 * US  # just past the chunk's end
    _reader("engine_idle_s")(_ctx(_ops() + [(NS_KERNEL, late, 2 * US)]))
    with pytest.raises(RuntimeError):
        _reader("engine_idle_s")(_ctx(_ops() + [(NS_KERNEL, late + 20 * US, 2 * US)]))


def test_no_span_over_the_stretch_raises(monkeypatch):
    monkeypatch.setattr(_spans, "recorded", lambda: [_span(0, "prologue", 9000, 9100)])
    with pytest.raises(RuntimeError, match="inside the traced stretch"):
        _reader("runner_idle_s")(_ctx())


MS = 1_000_000


def _drifting(jump_at=150 * MS, jump=-20 * MS):
    """Three chunks of 100 ms on the host, each ended by its read, with a
    callback span between; the device's stamps fall behind the host's by
    1% and step back by ``jump`` at ``jump_at``. Returns (spans, waits,
    device ops)."""
    def dev(t):
        return t - (t // 100 + (jump if t >= jump_at else 0))

    spans, waits, ops, i = [], [], [], 0
    for c in range(3):
        a, b = c * 101 * MS, c * 101 * MS + 100 * MS
        spans += [SimpleNamespace(kind="span", index=i, name="chunk@64x50", parent=None,
                                  start_ns=a, end_ns=b, value=None),
                  SimpleNamespace(kind="span", index=i + 1, name="callbacks@64", parent=None,
                                  start_ns=b + 10 * US, end_ns=b + MS - 10 * US, value=None)]
        waits.append(SimpleNamespace(kind="host_wait", index=i + 2, name="losses",
                                     parent=i, start_ns=b - 300 * US, end_ns=b, value=None))
        i += 3
        for k in range(95):  # a replay a ms, its NS kernel, then the read's copy
            t = a + MS + k * MS
            ops.append((NS_KERNEL, dev(t), 900 * US))
        ops.append(("Memcpy DtoH (Device -> Pageable)", dev(b - 60 * US), 10 * US))
    return spans, waits, ops


def test_device_times_are_put_on_the_host_clock_by_the_reads():
    spans, waits, ops = _drifting()
    trace = Trace(ops, [], 0.3)
    clock = _spans.Clock(trace, waits)
    assert len(clock.anchors) == 3
    _spans.check_clocks(trace, spans, clock)
    idle = _spans.idle_ns_by_family(trace, spans, clock)
    # Between the chunks the device idles from the read's copy to the next
    # replay: about 1.06 ms a crossing, in the callbacks.
    assert idle["callbacks"] == pytest.approx(2 * 1.05 * MS, rel=0.05)
    with pytest.raises(RuntimeError, match="disagree"):  # unaligned, the step shows
        _spans.check_clocks(trace, spans, _spans.Clock(trace, []))


def test_a_read_too_far_from_its_copy_is_no_anchor():
    """A step of 60 ms, past ``READ_WINDOW_NS``: the reads after it are
    not matched."""
    spans, waits, ops = _drifting(jump=-60 * MS)
    clock = _spans.Clock(Trace(ops, [], 0.3), waits)
    assert len(clock.anchors) == 1


def _sample(index, at, forward):
    return SimpleNamespace(kind="sections", index=index, name="sections", parent=None,
                           start_ns=at * US, end_ns=at * US,
                           value={"forward": forward, "loss": 1.0, "backward": 2 * forward,
                                  "update": 0.5})


def test_sections_take_the_median_inside_the_stretch(monkeypatch):
    step_ops = [(ELEMENTWISE, 100 * US, 900 * US)]  # the stretch: 100-1000 us
    records = [_sample(0, 50, 99.0),  # the untraced window's last replay
               _sample(1, 200, 3.0), _sample(2, 500, 5.0), _sample(3, 900, 4.0),
               _sample(4, 1200, 99.0)]  # the host-recorded stretch's
    monkeypatch.setattr(_spans, "recorded", lambda: records)
    ctx = _ctx(step_ops, kind="step")
    assert _reader("forward_ms")(ctx) == 4.0
    assert _reader("backward_ms")(ctx) == 8.0
    assert _reader("loss_ms")(ctx) == 1.0 and _reader("update_ms")(ctx) == 0.5
    assert _reader("forward_ms")(dict(ctx, kind="pyramid")) is None
    monkeypatch.setattr(_spans, "recorded", lambda: records[:1] + records[4:])
    with pytest.raises(RuntimeError, match="no section sample"):
        _reader("forward_ms")(ctx)


@pytest.mark.parametrize("name", ["engine_idle_s", "runner_idle_s", "host_waits_per_image",
                                  "forward_ms", "loss_ms", "backward_ms", "update_ms"])
def test_a_program_without_the_recorder_gives_nothing(monkeypatch, name):
    from style_transfer_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "RECORDER")
    assert _spans.recorded() is None
    kind = "step" if name.endswith("_ms") else "pyramid"
    assert _reader(name)(_ctx(kind=kind)) is None


def test_the_program_recorder_is_read():
    from style_transfer_tpu_torch.utils import trace

    with trace.span("bench-probe"):
        pass
    assert any(e.kind == "span" and e.name == "bench-probe" for e in _spans.recorded())
