"""PyTorch port: the span recorder (``utils/trace.py``) and what the engine
and the step runner record in it.

The recorder's nesting, parent indices, self time and bounded ring; its
clock against ``time.time_ns()`` and against ``torch.profiler``'s raw
events (a span opens a profiler range while a profiler runs); the
host waits of a tiny ``stylize``; the step's section marks in an eager
iteration, and the runner's one sample per replay; the zoom runner's reads
of ``go``, its ``zoom-trials`` counter and its trial's marks, none of which
an Adam run records. The sections inside a captured graph, and the trial's,
run on the card only (``-m cuda``).
"""

import functools
import time

import numpy as np
import pytest
import torch

from style_transfer_tpu_torch import StyleTransfer, bench
from style_transfer_tpu_torch.models import weights
from style_transfer_tpu_torch.utils import trace as T

torch.set_num_threads(2)

# The VGG-19 weights of seed 0, drawn once for the module: the tests and
# ``bench.build_step`` take them nine times, at 0.65 s a draw.
random_params = functools.lru_cache(maxsize=None)(weights.random_params)


@pytest.fixture(scope="module", autouse=True)
def _weights_drawn_once():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "random_params", random_params)
        yield


def _spans(records):
    return [e for e in records if e.kind == T.SPAN]


def test_spans_nest_with_parent_index_and_self_time():
    rec = T.SpanRecorder()
    with rec.span("outer"):
        with rec.span("a"):
            time.sleep(0.002)
        with rec.span("b"):
            with rec.span("c"):
                time.sleep(0.001)
    outer, a, b, c = sorted(_spans(rec.events()), key=lambda e: e.index)
    assert [e.name for e in (outer, a, b, c)] == ["outer", "a", "b", "c"]
    assert (outer.parent, a.parent, b.parent, c.parent) == (None, outer.index, outer.index,
                                                            b.index)
    for child, parent in ((a, outer), (b, outer), (c, b)):
        assert parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns
    dur = {e.index: e.end_ns - e.start_ns for e in (outer, a, b, c)}
    own = T.self_ns(rec.events())
    assert own[outer.index] == dur[outer.index] - dur[a.index] - dur[b.index]
    assert own[b.index] == dur[b.index] - dur[c.index]
    assert own[c.index] == dur[c.index] and own[a.index] == dur[a.index]
    totals = rec.totals(reset=True)
    assert set(totals) == {"outer", "a", "b", "c"}
    assert totals["a"] == pytest.approx(dur[a.index] / 1e9)
    assert rec.totals() == {}


def test_ring_is_bounded_and_keeps_the_newest():
    rec = T.SpanRecorder(capacity=8)
    for k in range(20):
        with rec.span(f"s{k}", device=torch.device("cpu")):  # a span and its sync wait
            pass
    records = rec.events()
    assert len(records) == 8
    assert [e.index for e in records] == list(range(32, 40))
    assert rec.totals()["s0"] >= 0.0  # the totals outlive the ring


def test_span_starts_on_the_time_ns_base():
    rec = T.SpanRecorder()
    before = time.time_ns()
    with rec.span("now") as ev:
        pass
    after = time.time_ns()
    assert abs(ev.start_ns - before) < 1_000_000
    assert abs(ev.end_ns - after) < 1_000_000


def test_span_opens_a_profiler_range_under_the_profiler():
    """An op's range, not a user annotation (which the profiler would
    mirror on the device as an event over the range's kernels)."""
    rec = T.SpanRecorder()
    with rec.span("idle"):  # no profiler: no range
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("phase-a"):
            with rec.span("  phase-a:inner"):
                torch.ones(64).sum()
        with rec.span("phase-b"):
            torch.ones(64).sum()
    host = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert "idle" not in host
    for ev in _spans(rec.events())[1:]:
        assert ev.start_ns <= host[ev.name].start_ns() < ev.start_ns + 2_000_000, ev.name
        assert not host[ev.name].is_user_annotation()


def test_sampler_is_read_with_the_ring():
    rec = T.SpanRecorder()

    class Runner:
        def sample(self):
            rec.sample("sections", 5, {"forward": 1.0})

    runner = Runner()
    rec.set_sampler(runner.sample)
    (ev,) = rec.events()
    assert (ev.kind, ev.start_ns, ev.value) == (T.SECTIONS, 5, {"forward": 1.0})
    del runner  # held weakly
    assert len(rec.events()) == 1


# Spans that end in a synchronize of the device (a host wait on every
# device); the chunks end in their read of the losses instead.
_UNSYNCED = ("chunk1", "chunk", "callbacks", "final-image")


def test_stylize_records_a_host_wait_per_chunk_read_and_phase_sync(content_pil, style_pil):
    st = StyleTransfer(device="cpu", weights=random_params(0), callback_chunk=2)
    first = T.events()[-1].index if T.events() else -1
    seen = []
    st.stylize(content_pil, [style_pil], min_scale=48, end_scale=48, iterations=4,
               initial_iterations=4, callback=seen.append)
    records = [e for e in T.events() if e.index > first]
    spans = {e.index: e for e in _spans(records)}
    waits = [e for e in records if e.kind == T.HOST_WAIT]
    assert len(seen) == 4
    syncs = {i: 0 for i in spans}
    for w in waits:
        owner = spans[w.parent]
        assert owner.start_ns <= w.start_ns <= w.end_ns <= owner.end_ns
        if w.name == "sync":
            syncs[w.parent] += 1
        elif w.name == "losses":
            assert owner.name.split("@")[0] in ("chunk1", "chunk")
        else:
            assert (w.name, owner.name) == ("image", "final-image")
    fam = {i: s.name.strip().split("@")[0].split(":")[0] for i, s in spans.items()}
    assert syncs == {i: int(fam[i] not in _UNSYNCED) for i in spans}
    chunks = [s for s in spans.values() if fam[s.index] in ("chunk1", "chunk")]
    assert len(chunks) == 2
    assert sum(w.name == "losses" for w in waits) == len(chunks)
    assert sum(w.name == "image" for w in waits) == 1
    assert [fam[i] for i in sorted(spans) if spans[i].parent is None] == [
        "prologue", "scale-entry", "targets", "scale-entry", "chunk1", "callbacks", "chunk",
        "callbacks", "scale-exit", "final-image"]


def _zoom_records(first):
    """The zoom runner's records after index ``first``: its ``go`` waits,
    its ``zoom-trials`` counters and its ``trial`` samples."""
    records = [e for e in T.events() if e.index > first]
    return ([e for e in records if e.kind == T.HOST_WAIT and e.name == "go"],
            [e for e in records if e.kind == T.COUNTER and e.name == "zoom-trials"],
            [e for e in records if e.kind == T.SECTIONS and "trial" in e.value])


def test_section_marks_fire_in_order_once_per_eager_iteration():
    runner, params, consts, state = bench.build_step(32, 32, device="cpu")
    run = runner.run
    first = T.events()[-1].index if T.events() else -1
    state, _ = runner(params, consts, state, 3)
    assert run.sections.fired == [0, 1, 2, 3, 4] * 3
    assert run.section_ms() is None  # no replay
    runner(params, consts, state, 1)
    assert run.sections.fired == [0, 1, 2, 3, 4]
    assert _zoom_records(first) == ([], [], [])  # Adam reads no go, counts no trial


def test_zoom_runner_records_its_reads_trials_and_trial_marks():
    """Eagerly: a ``go`` wait for each read (after every trial but a
    search's 20th), one ``zoom-trials`` counter a call with the call's
    trials, and the trial's two marks around each trial, recording no event
    (no capture) and so no sample."""
    runner, params, consts, state = bench.build_step(32, 32, device="cpu",
                                                     optimizer="lbfgs-zoom")
    run = runner.run
    first = T.events()[-1].index if T.events() else -1
    state, _ = runner(params, consts, state, 2)
    trials = run.linesearch_steps.tolist()
    waits, counters, samples = _zoom_records(first)
    assert trials[0] > 1
    assert len(waits) == sum(min(n, 19) for n in trials)
    assert [(e.value, e.parent) for e in counters] == [(sum(trials), None)]
    assert all(w.start_ns <= w.end_ns <= counters[0].start_ns for w in waits)
    assert run.sections.fired == [0, 1] * sum(trials)
    assert run.section_ms() is None and samples == []
    runner(params, consts, state, 1)
    assert len(_zoom_records(first)[1]) == 2


def test_runner_samples_each_replay_once():
    runner = bench.build_step(32, 32, device="cpu")[0].run
    runner.sections.ms = lambda: {"forward": 2.0, "loss": 0.5, "backward": 3.0,
                                  "update": 0.25}
    runner._stamp = stamp = T.now_ns()
    for _ in range(2):
        runner._sample()
    mine = [e for e in T.events() if e.kind == T.SECTIONS and e.start_ns == stamp]
    assert len(mine) == 1 and mine[0].value["backward"] == 3.0


@pytest.mark.cuda
def test_zoom_trial_is_timed_inside_its_replayed_graph():
    """On the card: the trial graph holds the trial's two events, each
    replay of it records them, and one trial's ms, sampled under the
    profiler at the runner's next call, is a part of an iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the card)")
    runner, params, consts, state = bench.build_step(64, 64, device="cuda:0",
                                                     optimizer="lbfgs-zoom")
    run = runner.run
    state, _ = runner(params, consts, state, 3)  # warm-up, capture and replay, replay
    ms = run.section_ms()
    assert set(ms) == {"trial"} and ms["trial"] > 0
    first = T.events()[-1].index
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        t0 = T.now_ns()
        state, _ = runner(params, consts, state, 2)
        state, _ = runner(params, consts, state, 1)
    waits, counters, samples = _zoom_records(first)
    assert len([e for e in samples if e.start_ns > t0]) == 2  # each call's last replay
    assert len(counters) == 2 and waits
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, _ = runner(params, consts, state, 5)
    end.record()
    end.synchronize()
    per_eval = start.elapsed_time(end) / (5 + int(run.linesearch_steps.sum()))
    assert 0.3 * per_eval < run.section_ms()["trial"] <= 1.5 * per_eval


@pytest.mark.cuda
def test_sections_time_the_replayed_graph():
    """On the card: the capture puts the five events in the graph, every
    replay records them, and the sections of a replay, sampled under the
    profiler at the runner's next call, cover the replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the card)")
    runner, params, consts, state = bench.build_step(64, 64, device="cuda:0")
    run = runner.run
    state, _ = runner(params, consts, state, 3)  # warm-up, capture and replay, replay
    ms = run.section_ms()
    assert set(ms) == set(run.sections.NAMES) and all(v > 0 for v in ms.values())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        t0 = T.now_ns()
        state, _ = runner(params, consts, state, 2)
        state, _ = runner(params, consts, state, 1)
    mine = [e for e in T.events() if e.kind == T.SECTIONS and e.start_ns > t0]
    assert len(mine) == 2
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        state, _ = runner(params, consts, state, 1)
    end.record()
    end.synchronize()
    per_iter = start.elapsed_time(end) / 10
    total = sum(run.section_ms().values())
    assert 0.5 * per_iter < total <= 1.05 * per_iter
    np.testing.assert_array_less(0, list(mine[-1].value.values()))


def test_counter_is_stamped_inside_its_span():
    rec = T.SpanRecorder()
    with rec.span("outer"):
        rec.counter("trunk-layout", "nchw")
    outer, ev = sorted(rec.events(), key=lambda e: e.index)
    assert (ev.kind, ev.name, ev.value, ev.parent) == (T.COUNTER, "trunk-layout", "nchw",
                                                       outer.index)
    assert outer.start_ns <= ev.start_ns == ev.end_ns <= outer.end_ns
    assert rec.totals() == {"outer": pytest.approx((outer.end_ns - outer.start_ns) / 1e9)}


@pytest.mark.parametrize("dtype,sharded,layout", [
    (torch.bfloat16, False, "channels_last"), (None, False, "nchw"),
    (torch.bfloat16, True, "nchw")], ids=["bf16", "f32", "bf16-mesh"])
def test_trunk_layout_counter(dtype, sharded, layout):
    """Each call of the trunk records the format it ran: channels_last for
    bf16 on one device, NCHW for FP32 and under a mesh (here a 1x1 one);
    the eager step calls the trunk once an iteration."""
    from style_transfer_tpu_torch.models.vgg import cast_params, extract_features
    from style_transfer_tpu_torch.models.weights import params_from_jax
    from style_transfer_tpu_torch.parallel.mesh import Mesh

    params = params_from_jax(random_params(0))
    if dtype is not None:
        params = cast_params(params, dtype)
    mesh = Mesh(grid=(1, 1), rank=0, device=torch.device("cpu")).on_canvas(32, 32)
    first = T.events()[-1].index if T.events() else -1
    with torch.no_grad():
        feats = extract_features(params, torch.rand(1, 3, 32, 32), (1, 6), compute_dtype=dtype,
                                 mesh=mesh if sharded else None)
    counts = [e for e in T.events() if e.kind == T.COUNTER and e.index > first]
    assert [(e.name, e.value) for e in counts] == [("trunk-layout", layout)]
    assert feats[6].is_contiguous() is (layout == "nchw")
    if not sharded:
        runner, params, consts, state = bench.build_step(
            32, 32, device="cpu", compute_dtype="f32" if dtype is None else "bf16")
        first = T.events()[-1].index
        runner(params, consts, state, 3)
        counts = [e.value for e in T.events() if e.kind == T.COUNTER and e.index > first]
        assert counts == [layout] * 3
