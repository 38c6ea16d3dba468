"""The zoom L-BFGS cell and the FP32 pyramid cell: the readers of the zoom runner's record
(``metrics/_zoom.py``) on a made-up device trace, what the float64 reference
optimizer may load, the cells' entries and limits, and ``correct`` failing
for a broken zoom step at a tiny size on the CPU. The reference against
``optax.lbfgs`` is in ``tests/test_torch_zoom_reference.py``, beside the JAX
package."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, plugin
from benchmark.metrics import _spans
from benchmark.metrics._kernels import Trace
from benchmark.tests.conftest import tiny

ROOT = Path(__file__).resolve().parents[2]
US, MS = 1_000, 1_000_000
CONV = "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw"
COPY = "Memcpy DtoH (Device -> Pageable)"
ZOOM = "f32-lbfgszoom-step512"


# ------------------------------------------------------------ the readers

def _timeline(chunks=2, chunk=2, trials=(3, 1), offset=100 * US, drift=0.01, calls=1):
    """A made-up traced stretch of the zoom step: ``chunks`` chunks of
    ``chunk`` iterations in ``calls`` runner calls each (a ``zoom-trials``
    counter at the end of each), iteration k running
    ``trials[k % len(trials)]`` trials. Per iteration on the host's clock: the head (1 ms of kernels),
    each trial (1 ms) followed by the read of ``go`` (its copy 10 us; the
    device then idles 50 us while the host launches the next trial, or 40
    us after the search's last before the tail, 100 us); a chunk ends in
    the read of its losses and 300 us of idle. The device's stamps run
    ``offset`` behind the host's and lose ``drift`` of each host second.
    Returns (ops, records, iterations, trials, idle ns after the go reads
    on the host's clock)."""
    def dev(t):
        return int(t - offset - drift * t)

    ops, records, t, idx, total, idle = [], [], 10 * MS, 0, 0, 0
    for c in range(chunks):
        run = 0
        for i in range(chunk):
            n = trials[(c * chunk + i) % len(trials)]
            ops.append((CONV, dev(t), dev(t + MS) - dev(t)))
            t += MS
            for k in range(n):
                ops.append((CONV, dev(t), dev(t + MS) - dev(t)))
                t += MS
                ops.append((COPY, dev(t), 10 * US))
                t += 10 * US
                records.append(SimpleNamespace(kind="host_wait", index=idx, name="go",
                                               parent=None, start_ns=t - 900 * US, end_ns=t,
                                               value=None))
                idx += 1
                gap = 50 * US if k < n - 1 else 40 * US
                t += gap
                idle += gap
            ops.append((CONV, dev(t), dev(t + 100 * US) - dev(t)))
            t += 100 * US
            run += n
            total += n
            if (i + 1) % (chunk // calls) == 0:  # the end of a runner call
                records.append(SimpleNamespace(kind="counter", index=idx, name="zoom-trials",
                                               parent=None, start_ns=t, end_ns=t, value=run))
                run, idx = 0, idx + 1
        records.append(SimpleNamespace(kind="sections", index=idx + 1, name="sections",
                                       parent=None, start_ns=t - 200 * US, end_ns=t - 200 * US,
                                       value={"trial": 0.9 + c}))
        idx += 2
        ops.append((COPY, dev(t + 20 * US), 10 * US))
        t += 330 * US
    return ops, records, chunks * chunk, total, idle


def _ctx(ops, chunk=2, iterations=4):
    return {"kind": "step", "trace": Trace(ops, [], 0.1), "traffic": {"chunk": chunk},
            "traced_iterations": iterations, "trunk_least_s": 1e-4}


@pytest.fixture
def program(monkeypatch):
    """The readers see ``records`` as the program's record."""
    def use(records):
        monkeypatch.setattr(_spans, "recorded", lambda: records)
    return use


@pytest.mark.parametrize("calls", [1, 2])
def test_evaluations_an_iteration_from_the_counters(program, calls):
    """One counter a runner call, one or two calls a chunk (the step cell's
    runner splits a chunk where it puts the state back)."""
    ops, records, iters, trials, _ = _timeline(calls=calls)
    program(records)
    got = harness._reader("evals_per_iter")(_ctx(ops, iterations=iters))
    assert got == pytest.approx(1 + trials / iters)  # (3 + 1 + 3 + 1) / 4 trials


def test_a_counter_outside_the_stretch_is_left_out(program):
    ops, records, iters, trials, _ = _timeline()
    early = SimpleNamespace(kind="counter", index=-1, name="zoom-trials", parent=None,
                            start_ns=MS, end_ns=MS, value=40)  # the untraced window's
    program([early] + records)
    assert harness._reader("evals_per_iter")(_ctx(ops)) == pytest.approx(1 + trials / iters)
    program([early])
    with pytest.raises(RuntimeError, match="zoom-trials"):
        harness._reader("evals_per_iter")(_ctx(ops))


def test_trial_ms_is_the_median_inside_the_stretch(program):
    ops, records, *_ = _timeline(chunks=3)
    late = SimpleNamespace(kind="sections", index=99, name="sections", parent=None,
                           start_ns=10**12, end_ns=10**12, value={"trial": 50.0})
    program(records + [late])
    assert harness._reader("trial_ms")(_ctx(ops)) == pytest.approx(1.9)


def test_idle_after_the_go_reads_an_iteration(program):
    """The gaps that open at a read of ``go`` (50 us before a trial, 40
    before the tail), once the device's stamps are put on the host's clock;
    not the gaps after the chunks' reads of their losses."""
    ops, records, iters, _, idle = _timeline()
    program(records)
    ctx = _ctx(ops, iterations=iters)
    # The device's clock runs 1% slow: its gaps are 1% shorter.
    assert harness._reader("ls_idle_ms")(ctx) == pytest.approx(0.99 * idle / 1e6 / iters,
                                                               rel=5e-3)
    assert idle == 2 * (2 * 50 + 2 * 40) * US
    assert len(ctx["_zoom"]["clock"].anchors) == len([r for r in records if r.kind == "host_wait"])


def test_trunk_roofline_counts_every_evaluation(program):
    ops, records, iters, trials, _ = _timeline()
    program(records)
    ctx = _ctx(ops, iterations=iters)
    conv_s = sum(d for n, _, d in ops if n == CONV) / 1e9
    want = 100.0 * 1e-4 * (iters + trials) / conv_s
    assert harness._reader("trunk_roofline.zoom")(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", ["evals_per_iter", "trial_ms", "ls_idle_ms",
                                  "trunk_roofline.zoom"])
def test_a_program_without_the_zoom_record_gives_nothing(program, monkeypatch, name):
    ops, records, *_ = _timeline()
    others = [SimpleNamespace(kind="host_wait", index=0, name="sync", parent=None,
                              start_ns=ops[5][1], end_ns=ops[5][1] + MS, value=None)]
    program(others)  # a recorder with none of the zoom runner's records
    assert harness._reader(name)(_ctx(ops)) is None
    from style_transfer_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "RECORDER")  # no recorder at all
    assert harness._reader(name)(_ctx(ops)) is None
    assert harness._reader(name)(dict(_ctx(ops), kind="pyramid")) is None


# ------------------------------------------------------------ the reference

def test_a_run_of_the_zoom_cell_loads_neither_jax_nor_the_jax_package():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark import harness
from benchmark.tests.conftest import tiny
result = harness.run_cell(tiny({ZOOM!r}), 2**31 + 9, 0.1, 1, "cpu")
print(json.dumps({{"tops": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "forbidden": harness.forbidden_modules()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == [] and "style_transfer_tpu_torch" in got["tops"]
    assert not set(got["tops"]) & {"jax", "jaxlib", "flax", "optax"}


def test_the_zoom_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.reference import first_steps
from benchmark import inputs
cfg = json.load(open({str(ROOT)!r} + "/benchmark/configs/vgg19-w2-lbfgszoom-f32.json"))
t = {{"content": [48, 32], "style": [32, 32], "scale": 48}}
first_steps(cfg, t, inputs.make_inputs(cfg, t, 5, "cpu"), steps=2)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "optax", "style_transfer_tpu",
                       "style_transfer_tpu_torch"}


# ------------------------------------------------------------ the cells

def _cells():
    return {name: harness.load_cell(name) for name in ("f32-pyramid512", ZOOM)}


def test_the_new_cells_have_their_entries_and_limits():
    """Both cells and the zoom configuration are listed at the ends of their
    lists, and their entries find every file by name."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert [c["name"] for c in spec["workloads"][-2:]] == ["f32-pyramid512", ZOOM]
    conf = spec["configs"][-1]
    assert conf["name"] == "vgg19-w2-lbfgszoom-f32" and conf["reduced"] == []
    cells = _cells()
    for name, kind, numbers in ((ZOOM, "step",
                                 {"loss", "grad1", "grad1_diff", "change", "change_diff"}),
                                ("f32-pyramid512", "pyramid", {"loss", "image"})):
        cell = cells[name]
        assert cell.kind == kind and cell.chips == 1
        assert set(cell.limits) <= numbers and {"loss"} < set(cell.limits)
        assert all(0 < v < 1 for v in cell.limits.values())
    zoom = cells[ZOOM]
    assert [m["name"] for m in zoom.end_to_end] == ["ms_per_iter", "peak_mib", "setup_s"]
    assert {m["name"] for m in zoom.per_layer} == {
        "step_mfu", "device_idle.step", "evals_per_iter", "trial_ms", "ls_idle_ms",
        "trunk_roofline.zoom"}
    for m in zoom.per_layer:
        plugin.load("metrics", m["name"])
    for text in (conf["source"], conf["why"], spec["workloads"][-1]["why"]):
        assert 0 < len(text) <= 200 and "\n" not in text
    pyr = cells["f32-pyramid512"]
    assert {m["name"] for m in pyr.per_layer} == {
        "pyramid_mfu", "ns_roofline.pyramid", "engine_overhead_s", "device_idle.pyramid",
        "engine_idle_s", "runner_idle_s", "host_waits_per_image"}
    assert pyr.cfg["optimizer"] == "adam" and pyr.cfg["precision"] == "f32"


def test_the_zoom_runner_repeats_its_stretch_in_place():
    """The step cell's runner keeps the state the set-up's ``START``
    iterations leave and, after every ``SPAN`` iterations from there, writes
    it back into the buffers the runner handed back: every call gets the
    state the last one handed back (a runner given another state starts
    anew, warm-up and capture included), and each later iteration is one of
    iterations ``START + 1`` to ``START + SPAN``."""
    import style_transfer_tpu_torch.step as step

    mod = plugin.load("runners", "lbfgs-zoom")
    calls = []

    def inner(params, consts, state, n):
        assert not calls or state is calls[-1][1]
        out = [state.image.add_(1).clone() for _ in range(n)]  # the iteration's number
        calls.append((n, state))
        return state, torch.stack(out)

    run = mod.Repeating(step, inner)
    state = step.LoopState(image=torch.zeros(()), opt=torch.zeros(2), ema=torch.zeros(()))
    got = []
    for n in (1, 2, 50, 50, 7):
        state, losses = run(None, None, state, n)
        got += losses.tolist()
    stretch = list(range(mod.START + 1, mod.START + mod.SPAN + 1))
    assert got == list(range(1, mod.START + 1)) + stretch * 4 + stretch[:7]
    assert [n for n, _ in calls] == [1, 2] + [mod.SPAN] * 4 + [7]


def _fault_unchanged(monkeypatch):
    """The zoom step hands back its state unchanged: the tail writes
    nothing."""
    import style_transfer_tpu_torch.step as step

    monkeypatch.setattr(step._ZoomPhases, "tail", lambda self, static: None)


def _fault_altered(monkeypatch):
    """The zoom step's new image shifted by 0.01 in its first channel."""
    import style_transfer_tpu_torch.zoom_lbfgs as Z

    result = Z.ZoomLBFGSUpdate.result

    def altered(self):
        image, state = result(self)
        shift = torch.zeros_like(image)
        shift[:, 0] = 0.01
        return image + shift, state

    monkeypatch.setattr(Z.ZoomLBFGSUpdate, "result", altered)


def _fault_half_step(monkeypatch):
    """The line search's accepted step halved."""
    import style_transfer_tpu_torch.zoom_lbfgs as Z

    def halved(self):
        ls = self.search.result()
        return (self._params + 0.5 * ls.stepsize * self._direction,
                self._state._replace(linesearch_steps=ls.num_steps))

    monkeypatch.setattr(Z.ZoomLBFGSUpdate, "result", halved)


FAULTS = {"unchanged": _fault_unchanged, "altered": _fault_altered,
          "half_step": _fault_half_step}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_zoom_step_is_not_correct(monkeypatch, fault):
    cell = tiny(ZOOM)
    FAULTS[fault](monkeypatch)
    result = harness.run_cell(cell, 2**31 + 77, 0.1, 0, "cpu")
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("name", ["f32-lbfgszoom-step512", "f32-pyramid512"])
def test_an_unbroken_run_of_a_new_cell_reports_every_number(tiny_cell, name):
    cell = tiny_cell(name)
    result = harness.run_cell(cell, 2**31 + 77, 0.1, 0, "cpu")
    assert set(result["compared"]) == set(cell.limits)
    assert all(0 <= c["value"] < 0.1 for c in result["compared"].values()), result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
