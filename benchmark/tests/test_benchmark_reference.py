"""The plain reference against itself, and its pieces against plain
arithmetic."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import plugin
from benchmark.inputs import make_inputs, trunk_layers
from benchmark.reference import first_steps, lowp, model

ROOT = Path(__file__).resolve().parents[2]


def _cfg(name="vgg19-w2-adam-f32"):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


TRAFFIC = {"content": [64, 48], "style": [48, 48], "scale": 64}


@pytest.fixture(scope="module")
def inputs():
    return make_inputs(_cfg(), TRAFFIC, 2**31 + 3, "cpu")


@pytest.mark.parametrize("chunks", [(3,), (1, 1, 1)])
def test_first_steps_same_across_chunkings(inputs, chunks):
    cfg = _cfg()
    base = first_steps(cfg, TRAFFIC, inputs, steps=3, chunks=(1, 2))
    other = first_steps(cfg, TRAFFIC, inputs, steps=3, chunks=chunks)
    assert other["losses"] == base["losses"]
    assert torch.equal(other["change"], base["change"])
    if chunks[0] == 1:
        assert torch.equal(other["grad1"], base["grad1"])


def test_pyramid_same_across_runs(inputs):
    cfg = _cfg()
    t = dict(TRAFFIC, min_scale=32, end_scale=64)
    a, b = model.pyramid(cfg, t, inputs, 2), model.pyramid(cfg, t, inputs, 2)
    assert a["losses"] == b["losses"] and len(a["losses"]) == 2 * 3
    np.testing.assert_array_equal(a["image"], b["image"])
    assert a["image"].shape == (48, 64, 3)


def test_trunk_layout_is_vgg19_to_conv5_1():
    layers = trunk_layers(_cfg())
    convs = [l[1] for l in layers if l[0] == "conv"]
    assert convs == [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28]
    assert [l[1] for l in layers if l[0] == "pool"] == [4, 9, 18, 27]
    assert layers[-1] == ("relu", 29)


def test_trace_sqrt_ns_converges_to_eigh_and_its_gradient_is_half_z():
    g = torch.Generator().manual_seed(0)
    m = torch.randn(16, 16, generator=g, dtype=torch.float64)
    a = m @ m.T + 16 * torch.eye(16, dtype=torch.float64)
    exact = torch.linalg.eigvalsh(a).sqrt().sum()
    a.requires_grad_(True)
    tr = plugin.load("reference/style", "w2").TraceSqrtNS.apply(a, 30)
    (grad,) = torch.autograd.grad(tr, a)
    assert tr.item() == pytest.approx(float(exact), rel=1e-12)
    vals, vecs = torch.linalg.eigh(a.detach())
    inv_sqrt = (vecs / vals.sqrt()) @ vecs.T
    torch.testing.assert_close(grad, inv_sqrt / 2, rtol=1e-10, atol=1e-12)


def test_lower_precisions_round_as_stated():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-11], dtype=torch.float32)
    assert lowp.tf32_round(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0]
    y = torch.tensor([1000.0, 3.0, 0.0], dtype=torch.bfloat16)
    q = lowp.fp8_round(y, "e4m3")  # scaled by 4: 1000 -> 250 -> 256 in e4m3
    assert q.tolist() == [1024.0, 3.0, 0.0]


def test_rounded_conv_gradient_is_the_rounded_data_gradient():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 3, 8, 8, generator=g, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, generator=g)
    conv = lowp.make_conv("tf32")
    out = conv(x, w, None, 1)
    torch.testing.assert_close(out, torch.nn.functional.conv2d(
        lowp.tf32_round(x.detach()), lowp.tf32_round(w), None, padding=1))
    up = torch.randn(out.shape, generator=g)
    (gx,) = torch.autograd.grad(out, x, up)
    want = torch.nn.grad.conv2d_input(x.shape, lowp.tf32_round(w), lowp.tf32_round(up), padding=1)
    torch.testing.assert_close(gx, want)


def test_the_statistics_control_rounds_each_operand_and_passes_the_gradient():
    mm = lowp.make_mm("tf32_ns")
    a = torch.tensor([[1.0 + 2**-11, 2.0]], dtype=torch.float64, requires_grad=True)
    b = torch.tensor([[3.0], [1.0 + 2**-12]], dtype=torch.float64)
    out = mm(a, b)
    assert out.item() == (1.0 + 2**-10) * 3.0 + 2.0 * 1.0
    (g,) = torch.autograd.grad(out, a)
    assert g.tolist() == [[3.0, 1.0]]
    assert lowp.make_mm(None) is torch.matmul and lowp.make_mm("tf32") is torch.matmul


@pytest.mark.parametrize("control", ["tf32", "tf32_ns"])
def test_each_control_moves_the_reference(inputs, control):
    cfg = _cfg()
    base = first_steps(cfg, TRAFFIC, inputs, steps=2)
    low = first_steps(cfg, TRAFFIC, inputs, steps=2, mode=control)
    assert low["losses"] != base["losses"]
    assert not torch.equal(low["grad1"], base["grad1"])


def test_the_configuration_picks_its_pieces_by_name(monkeypatch):
    """The optimizer, the style and the content term are files named by the
    configuration: another name needs only another file."""
    cfg = dict(_cfg(), optimizer="no-such-optimizer")
    with pytest.raises(KeyError, match="reference/optim/no-such-optimizer.py"):
        first_steps(cfg, TRAFFIC, make_inputs(cfg, TRAFFIC, 1, "cpu"), steps=2)
    for folder, name in (("reference/optim", "adam"), ("reference/style", "w2"),
                         ("reference/content", "mse"), ("runners", "adam")):
        assert plugin.load(folder, name) is plugin.load(folder, name)
