"""PyTorch port: the measurement tools on the CPU.

The engine's phase attribution against the JAX engine's names
(``tests/test_engine.py``'s phase test), ``bench.build_step`` against the
JAX package's ``__graft_entry__._build`` on the same inputs,
``bench.main``'s JSON line, ``tools/bench_pyramid_torch.py``'s record,
``tools/profile_step_torch.py`` on the CPU (not measured) and its summary of
a device trace, and every tool's refusal of its default device without
CUDA.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from style_transfer_tpu_torch import StyleTransfer, bench
from style_transfer_tpu_torch.engine import phase_totals
from style_transfer_tpu_torch.models.weights import random_params
from style_transfer_tpu_torch.utils.ema import ema_init

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import bench_pyramid_torch  # noqa: E402
import lbfgs_determinacy_torch  # noqa: E402
import profile_step_torch  # noqa: E402

torch.set_num_threads(2)


def test_phase_totals_match_jax_engine_names(content_pil, style_pil, tmp_path):
    """One 64 px scale, 4 iterations in chunks of 2 with a checkpoint every
    2 and a callback: the JAX engine's phase names (``engine.py`` of the JAX
    package), the nested target rows indented, the port's ``prologue`` and
    ``callbacks@S``, and ``reset`` clearing the store."""
    phase_totals(reset=True)
    st = StyleTransfer(device="cpu", weights=random_params(0), callback_chunk=2)
    st.stylize(content_pil, [style_pil], min_scale=64, end_scale=64, iterations=4,
               initial_iterations=4, checkpoint=str(tmp_path / "ck.npz"),
               checkpoint_every=2, callback=lambda it: None)
    ph = phase_totals()
    assert set(ph) == {
        "scale-entry@64", "targets@64", "  targets:content-feats",
        "  targets:style-stats", "  targets:finalize", "chunk1@64x2", "chunk@64x2",
        "ckpt-snapshot@64", "scale-exit@64", "final-image", "prologue", "callbacks@64"}
    fams = {k.split("@")[0] for k in ph if not k.startswith(" ")}
    assert {"targets", "scale-entry", "final-image", "chunk1", "chunk"} <= fams
    assert all(v >= 0.0 for v in ph.values())
    # The nested rows lie inside their parent phase.
    nested = sum(v for k, v in ph.items() if k.startswith("  targets:"))
    assert nested <= ph["targets@64"]
    phase_totals(reset=True)
    assert phase_totals() == {}


def test_build_step_matches_graft_build():
    """The same seed through ``_build`` (JAX, 64x96) and ``build_step``:
    two Adam iterations' losses within rtol 2e-3, the JAX package's bar
    against its torch trajectory (test_fullloop_torch.py)."""
    runner, params, consts, state = graft._build(n_h=64, n_w=96)
    _, j_losses = runner(params, consts, state, 2)
    runner, params, consts, state = bench.build_step(64, 96, device="cpu")
    _, t_losses = runner(params, consts, state, 2)
    assert tuple(state.image.shape) == (1, 3, 64, 96)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=2e-3)


def test_bench_main_prints_one_json_line(capsys):
    rec = bench.main(["--device", "cpu", "--size", "32", "--chunk", "2",
                      "--timed-chunks", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == rec
    # The JAX bench's keys, and the device.
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert rec["metric"] == "adam_iters_per_sec_32px"
    assert rec["unit"] == "it/s" and rec["device"] == "cpu"
    assert rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 26.7, abs=1e-3)


@pytest.mark.parametrize("tool", ["bench", "bench_pyramid", "profile", "determinacy"])
def test_default_device_needs_cuda(tool, monkeypatch):
    """Each tool runs on cuda:0 unless asked for the CPU, and fails there
    without a card: it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"bench": lambda: bench.main([]),
            "bench_pyramid": lambda: bench_pyramid_torch.run(64),
            "profile": lambda: profile_step_torch.profile(32, 32),
            "determinacy": lambda: lbfgs_determinacy_torch.measure(
                seeds=1, iters=1, sizes=((32, 32),))}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_pyramid_bench_record():
    rec = bench_pyramid_torch.run(64, device="cpu", iterations=3, initial_iterations=3)
    # tools/bench_pyramid.py's keys, and the device.
    assert set(rec) == {"metric", "value", "unit", "end_scale", "label", "iter_wall",
                        "overhead_wall", "phases", "untimed", "captures", "scales",
                        "device"}
    assert rec["metric"] == "pyramid_wall" and rec["end_scale"] == 64
    assert rec["device"] == "cpu"
    assert rec["captures"] == {}  # the CPU runs the step eagerly
    assert list(rec["scales"]) == ["64x48"]
    scale = rec["scales"]["64x48"]
    assert set(scale) == {"wall", "iters", "ms_per_iter", "peak_mib"}
    assert scale["iters"] == 3 and scale["peak_mib"] == 0.0
    assert set(rec["phases"]) == {"prologue", "scale-entry", "targets", "chunk1",
                                  "callbacks", "scale-exit", "final-image"}
    # Each figure is rounded to 0.01 s.
    assert sum(rec["phases"].values()) + rec["untimed"] == pytest.approx(
        rec["value"], abs=0.011)
    assert rec["iter_wall"] + rec["overhead_wall"] == pytest.approx(rec["value"], abs=0.011)
    assert 0 <= rec["overhead_wall"] < rec["value"]


def test_pyramid_bench_zoom_record():
    """``--optimizer lbfgs-zoom`` runs the zoom pyramid and names its metric."""
    rec = bench_pyramid_torch.run(64, device="cpu", iterations=2, initial_iterations=2,
                                  optimizer="lbfgs-zoom")
    assert rec["metric"] == "pyramid_wall_lbfgs_zoom" and rec["captures"] == {}
    assert rec["scales"]["64x48"]["iters"] == 2


def test_lbfgs_determinacy_on_cpu(capsys):
    """On the CPU the step runs eagerly and reproducibly: every run of a
    seed gives the same losses, from either init."""
    out = lbfgs_determinacy_torch.measure(device="cpu", seeds=2, iters=3,
                                          sizes=((24, 32),))
    assert set(out) == {("uniform", (24, 32)), ("gray", (24, 32))}
    for ge, ee in out.values():
        assert ge == [0.0, 0.0] and ee == [0.0, 0.0]
    assert "gray 32x24, seeds 0-1, iterations 1-3" in capsys.readouterr().out
    _, _, _, state = bench.build_step(24, 32, device="cpu", optimizer="lbfgs")
    gray = lbfgs_determinacy_torch.gray_start(state)
    assert torch.equal(gray.image, state.image / 255.0 + 0.5)
    assert torch.equal(gray.ema.value, ema_init(gray.image, 0.99).value)
    assert int(gray.opt.n_iter) == 0
    zoom = lbfgs_determinacy_torch.gray_start(state, "lbfgs-zoom")
    assert torch.equal(zoom.image, gray.image) and int(zoom.opt.count) == 0


def test_zoom_determinacy_on_cpu(capsys):
    """The zoom runner from the gray init, three eager runs: every pair
    agrees on the CPU, and the per-iteration rows cover every iteration."""
    out = lbfgs_determinacy_torch.measure(device="cpu", seeds=1, iters=3, sizes=((24, 32),),
                                          optimizer="lbfgs-zoom", w2_grad="trace",
                                          inits=("gray",), eager_runs=3)
    assert out == {("gray", (24, 32)): ([0.0], [0.0])}
    text = capsys.readouterr().out
    assert "lbfgs-zoom trace gray 32x24, seeds 0-0, iterations 1-3" in text
    assert "eager against eager (3 runs)" in text
    rows = [line for line in text.splitlines() if "per iteration" in line]
    assert len(rows) == 2 and all(len(row.split(": ")[1].split()) == 3 for row in rows)


def test_profile_on_cpu_is_not_measured(capsys):
    assert profile_step_torch.profile(24, 32, iters=1, device="cpu") is None
    assert "not measured" in capsys.readouterr().out


def _event(name, device_type, start, end, kernels=(), flops=0, parent=None, shapes=()):
    e = SimpleNamespace(name=name, device_type=device_type, flops=flops,
                        input_shapes=list(shapes),
                        time_range=SimpleNamespace(elapsed_us=lambda: end - start),
                        kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels],
                        cpu_parent=parent, cpu_children=[])
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def test_profile_summary_of_a_device_trace():
    """``summarize`` on a hand-made trace of the profiler's event kinds:
    buckets by kernel name and launching op, kernels no op claims under
    "(no op)", FLOPs of the outermost counted op spread over its
    convolution and GEMM kernels."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    fprop, gemv = "sm80_xmma_fprop_implicit_gemm_f32", "void gemv2N_kernel<float2>"
    conv2d = _event("aten::conv2d", cpu, 0, 50, flops=4e9)
    layout = "void cudnn::engines_precompiled::nchwToNhwcKernel<bf16>"
    cudnn = _event("aten::cudnn_convolution", cpu, 0, 50, [(fprop, 40.0), (layout, 5.0)],
                   parent=conv2d)
    back = _event("aten::convolution_backward", cpu, 50, 120,
                  [("void cudnn::detail::dgrad_engine<float>", 30.0), (gemv, 20.0)],
                  shapes=[[1, 64, 8, 8], [1, 3, 8, 8], [64, 3, 3, 3], [], [64]])
    add = _event("aten::add", cpu, 120, 130,
                 [("void at::native::vectorized_elementwise_kernel<4>", 5.0)])
    device = [
        _event(fprop, cuda, 0, 40),
        _event("void cudnn::detail::dgrad_engine<float>", cuda, 50, 80),
        _event(gemv, cuda, 80, 100),
        _event("void at::native::vectorized_elementwise_kernel<4>", cuda, 120, 125),
        _event("stt::stt_nsk_gemm(Launch)", cuda, 130, 155),
        _event(layout, cuda, 40, 45),
    ]
    s = profile_step_torch.summarize([conv2d, cudnn, back, add, *device], iters=5,
                                     wall_us=200.0)
    assert s["kernel_ms_per_iter"] == pytest.approx(125.0 / 5e3)
    assert s["busy"] == pytest.approx(125.0 / 200.0)
    assert s["ns_ms_per_iter"] == pytest.approx(25.0 / 5e3)
    assert s["buckets"] == pytest.approx({
        "cuDNN conv forward": 40 / 5e3, "cuDNN conv dgrad": 30 / 5e3,
        "cuBLAS GEMM/GEMV": 20 / 5e3, "elementwise/reduction": 5 / 5e3,
        "NS kernels (stt_nsk_)": 25 / 5e3, "layout copies": 5 / 5e3})
    assert sum(s["buckets"].values()) == pytest.approx(s["kernel_ms_per_iter"])
    sources = {x["op"]: x["ms_per_iter"] for x in s["sources"]}
    assert sources == pytest.approx({
        "aten::cudnn_convolution": 45 / 5e3, "aten::convolution_backward": 50 / 5e3,
        "aten::add": 5 / 5e3, "(no op)": 25 / 5e3})
    top = {k["name"]: k for k in s["top"]}
    assert top[gemv]["source"] == (
        "aten::convolution_backward [[1, 64, 8, 8], [1, 3, 8, 8], [64, 3, 3, 3]]")
    assert top[fprop]["source"] == "aten::cudnn_convolution"
    assert top["stt::stt_nsk_gemm(Launch)"]["source"] == "(no op)"
    # conv2d's FLOPs go to its convolution kernel, not to its layout copy.
    assert top[fprop]["tflops"] == pytest.approx(4e9 / 40e-6 / 1e12)
    assert top[layout]["tflops"] is None and top[gemv]["tflops"] is None


def test_profile_summary_of_graph_replays():
    """A CUDA graph's kernels, which no op launches, take their buckets,
    launching ops and FLOP rates from the summary of an eager step: a
    kernel that step launched from two ops is split over their buckets in
    its proportions, and the sources are the eager step's."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    conv = "sm80_xmma_fprop_implicit_gemm_f32"
    eager = profile_step_torch.summarize([
        _event("aten::cudnn_convolution", cpu, 0, 30, [(conv, 30.0)], flops=3e9),
        _event("aten::convolution_backward", cpu, 30, 40, [(conv, 10.0)]),
        _event(conv, cuda, 0, 30), _event(conv, cuda, 30, 40),
        _event("stt::stt_nsk_gemm(Launch)", cuda, 40, 50),
    ], iters=1, wall_us=50.0)
    replays = [_event("cudaGraphLaunch", cpu, 0, 1),
               *(_event(conv, cuda, 80 * i, 80 * i + 80) for i in range(2)),
               _event("stt::stt_nsk_gemm(Launch)", cuda, 160, 200)]
    s = profile_step_torch.summarize(replays, iters=2, wall_us=250.0, attribution=eager)
    assert s["kernel_ms_per_iter"] == pytest.approx(200.0 / 2e3)
    assert s["busy"] == pytest.approx(200.0 / 250.0)
    assert s["buckets"] == pytest.approx({
        "cuDNN conv forward": 120 / 2e3, "cuDNN conv dgrad": 40 / 2e3,
        "NS kernels (stt_nsk_)": 40 / 2e3})
    assert s["sources"] == eager["sources"]
    top = {k["name"]: k for k in s["top"]}
    assert top[conv]["source"] == "aten::cudnn_convolution"
    assert top[conv]["tflops"] == pytest.approx(eager["top"][0]["tflops"])
    assert top["stt::stt_nsk_gemm(Launch)"]["source"] == "(no op)"
