"""The trace's reduction: kernel buckets on names recorded from the
benchmark's card runs, busy time and idle gaps on a made-up timeline, and
the readers' refusal of a trace without the kernels they read."""

import json
from pathlib import Path

import pytest

from benchmark.metrics import _idle, _kernels, _ns
from benchmark.metrics._kernels import TRUNK, Trace, bucket

RECORDED = json.loads((Path(__file__).parent / "kernel_names.json").read_text())["kernels"]


@pytest.mark.parametrize("name,want", RECORDED, ids=[n[:60] for n, _ in RECORDED])
def test_recorded_kernel_buckets(name, want):
    assert bucket(name) == want


def test_cublas_xmma_gemms_are_not_convolutions():
    assert bucket("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_"
                  "warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas") == "cuBLAS GEMM"
    assert bucket("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
                  "tilesize256x64x8_stage3") == "conv forward"
    assert "cuBLAS GEMM" not in TRUNK and "conv FFT" in TRUNK


def _trace():
    ops = [("void stt::(anonymous namespace)::stt_nsk_ns_cluster<64>(float const*)", 0, 100_000),
           ("sm90_xmma_fprop_implicit_gemm_bf16", 50_000, 100_000),  # overlaps the first
           ("void at::native::vectorized_elementwise_kernel<4>", 200_000, 50_000),
           ("sm90_xmma_dgrad_implicit_gemm_bf16", 260_000, 40_000),
           ("Memcpy DtoD (Device -> Device)", 300_005, 95_000)]
    host = [("cudaGraphLaunch", 140_000, 210_000), ("aten::copy_", 160_000, 195_000)]
    return Trace(ops, host, 0.0005)


def test_busy_time_is_the_union_of_operations():
    t = _trace()
    assert t.busy_s() == pytest.approx((150_000 + 50_000 + 40_000 + 95_000) / 1e9, abs=1e-12)
    assert t.seconds(TRUNK) == pytest.approx(140_000 / 1e9)
    assert t.seconds((_kernels.NS,)) == pytest.approx(100_000 / 1e9)


def test_idle_gaps_are_labelled_by_the_innermost_host_call():
    gaps = dict(_trace().idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(50_000 / 1e9)  # 150-200 us, mid 175 us
    assert gaps["(gaps under 20 us between device operations)"] == pytest.approx(
        (10_000 + 5) / 1e9)


def test_readers_fail_without_their_kernels():
    empty = Trace([("void at::native::vectorized_elementwise_kernel<4>", 0, 10)], [], 1.0)
    ctx = {"kind": "step", "trace": empty, "ns_least_s": 1e-5, "trunk_least_s": 1e-3,
           "traced_iterations": 1}
    with pytest.raises(RuntimeError):
        _ns.read(ctx, "step")
    from benchmark.harness import _reader

    with pytest.raises(RuntimeError):
        _reader("trunk_roofline")(ctx)
    assert _ns.read(dict(ctx, kind="pyramid"), "step") is None
    assert _idle.read(ctx, "step") == pytest.approx(100.0 * (1 - 10e-9))


def test_every_metric_of_the_benchmark_has_a_reader():
    from benchmark.harness import ROOT, _reader

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert callable(_reader(m["name"]))
