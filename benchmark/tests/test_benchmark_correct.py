"""``correct`` at a tiny size on the CPU: a run with the timed path broken
underneath comes out not correct, once for each fault a cell can have, and
so does the control, the reference in the program's place one precision
lower. (A cell here runs on one chip: no exchange between chips to leave
out.) The limits are the cells' own, set on the card at the cells' sizes."""

import pytest
import torch

from benchmark import harness
from benchmark.reference.lowp import LOWER

CELLS = ["f32-print2896", "bf16-pyramid512", "bf16-print2896", "f32-step512"]
SEED = 2**31 + 77


def _run(cell):
    return harness.run_cell(cell, SEED, 0.1, 0, "cpu")


def _unchanged(monkeypatch):
    """The step hands back its state unchanged: no update, the moments as
    they were."""
    import style_transfer_tpu_torch.step as step

    def apply(cfg, opt, g):
        return torch.zeros_like(g), opt

    monkeypatch.setattr(step, "_adam_apply", apply)


def _half_batch(monkeypatch):
    """The moments taken over the top half of each tap only."""
    import style_transfer_tpu_torch.ops.losses as L

    moments = L.w2_moments

    def half(feats, mesh=None):
        return moments(feats[:, :, : max(1, feats.shape[2] // 2)], mesh)

    monkeypatch.setattr(L, "w2_moments", half)


def _altered(monkeypatch):
    """The step's new image altered where the step makes it: its first
    channel shifted by 0.01."""
    import style_transfer_tpu_torch.step as step

    adam = step._adam_apply

    def apply(cfg, opt, g):
        update, new = adam(cfg, opt, g)
        shift = torch.zeros_like(update)
        shift[:, 0] = 0.01
        return update - shift, new

    monkeypatch.setattr(step, "_adam_apply", apply)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(tiny_cell, monkeypatch, name, fault):
    cell = tiny_cell(name)
    FAULTS[fault](monkeypatch)
    result = _run(cell)
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("control", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tiny_cell, name, control):
    """The reference in the program's place with a stated precision one step
    lower fails at least one number: the trunk (TF32 below FP32, fp8 below
    bf16), and the statistics' products (TF32)."""
    from benchmark.check import judge
    from benchmark.inputs import make_inputs

    cell = tiny_cell(name)
    inputs = make_inputs(cell.cfg, cell.traffic, SEED, "cpu")
    ref = harness.reference_first_steps(cell, inputs)
    lower = harness.reference_first_steps(cell, inputs,
                                          mode=LOWER[cell.cfg["precision"]][control])
    compared, ok = judge(harness.numbers(cell, lower, ref), cell.limits)
    assert not ok, compared


@pytest.mark.parametrize("name", CELLS)
def test_an_unbroken_run_reports_every_number(tiny_cell, name):
    """The result line's shape, and each number finite. (Whether an unbroken
    run is correct is decided at the cell's size, on the card: the limits
    are set there, and the 64x48 canvas here reads other numbers.)"""
    cell = tiny_cell(name)
    result = _run(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(result["compared"]) == set(cell.limits)
    assert all(0 <= c["value"] < 0.1 for c in result["compared"].values()), result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_limits_lie_between_the_program_and_what_must_fail():
    """``calibrate.propose_limits``: the upper reading is the least of the
    control's (where 3 times the lower or more) and each fault's (10 times;
    the unchanged state's 3 times); a number nothing separates gets none."""
    from benchmark.calibrate import propose_limits

    out = {"program": [{"a": 1e-4, "b": 1e-3, "c": 0.1}, {"a": 2e-4, "b": 2e-3, "c": 0.2}],
           "tf32": [{"a": 5e-3, "b": 4e-3, "c": 0.3}],  # b: under 3x, c: under 3x
           "altered": [{"a": 1e-2, "b": 0.5, "c": 0.5}],  # c: under 10x
           "unchanged": [{"a": 1.0, "b": 1.0, "c": 0.5}]}  # c: under 3x
    got = propose_limits(out)
    assert got["a"]["from"] == "tf32" and got["a"]["upper"] == 5e-3
    assert got["b"]["from"] == "altered" and got["b"]["upper"] == 0.5
    assert got["c"]["limit"] is None
    for k in ("a", "b"):
        assert got[k]["lower"] < got[k]["limit"] < got[k]["upper"]
        assert got[k]["limit"] / got[k]["lower"] > got[k]["upper"] / got[k]["limit"]


def test_the_program_is_handed_what_the_configuration_chooses(tiny_cell):
    """A setting the program fixes has to be what the file states; one the
    configuration chooses (the optimizer, the loss terms) goes to the
    program, its runner found by name."""
    cell = tiny_cell("f32-step512")
    cell.cfg["sqrtm_iters"] = 10
    with pytest.raises(ValueError, match="sqrtm_iters"):
        _run(cell)
    cell = tiny_cell("f32-step512")
    del cell.cfg["beta1"], cell.cfg["adam_eps"]  # not stated: nothing to hold
    cell.cfg["optimizer"] = "no-such-optimizer"
    with pytest.raises(KeyError, match="runners/no-such-optimizer.py"):
        _run(cell)
