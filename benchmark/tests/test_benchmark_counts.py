"""The work counts against a count by hand."""

import json
from pathlib import Path

import pytest

from benchmark import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.fixture(scope="module")
def cfg():
    return json.loads((CONFIGS / "vgg19-w2-adam-f32.json").read_text())


def test_trunk_flops_per_pixel(cfg):
    # conv1_1, conv1_2 at full size; conv2_x at 1/4; conv3_x at 1/16; conv4_x
    # at 1/64; conv5_1 at 1/256: 2 * 9 * cin * cout FLOPs a pixel each,
    # forward and data gradient.
    by_hand = 2 * 9 * (3 * 64 + 64 * 64 + (64 * 128 + 128 * 128) / 4
                       + (128 * 256 + 3 * 256 * 256) / 16
                       + (256 * 512 + 3 * 512 * 512) / 64 + 512 * 512 / 256)
    assert counts.trunk_flops(cfg, 1024, 1024) == 2 * by_hand * 1024 * 1024
    assert counts.trunk_flops(cfg, 1024, 1024) / 1024**2 == pytest.approx(1.44e6, rel=0.01)


def test_moments_and_ns_flops(cfg):
    # f f^T and its backward at relu1_1 .. relu5_1: 2 * 2 * C^2 a pixel of the tap.
    assert counts.moments_flops(cfg, 1024, 1024) / 1024**2 == 4 * (64**2 + 128**2 / 4 + 256**2 / 16
                                                                 + 512**2 / 64 + 512**2 / 256)
    assert counts.ns_groups(cfg) == {64: 1, 128: 1, 256: 1, 512: 2}
    # 1 + 3 * 11 products of 2 C^3 FLOPs: 19.6 GFLOP an iteration.
    assert counts.ns_flops(cfg) == 34 * 2 * (64**3 + 128**3 + 256**3 + 2 * 512**3)
    assert counts.ns_flops(cfg) / 1e9 == pytest.approx(19.6, abs=0.05)
    # FLOPs bind the NS chain: 39.5 us at 495 TFLOP/s.
    assert counts.ns_least_s(cfg, 495e12, 3.35e12) == pytest.approx(counts.ns_flops(cfg) / 495e12)


def test_print_step_flops_and_floor_halving(cfg):
    shapes = counts.conv_shapes(cfg, 2172, 2896)
    assert [s[0] for s in shapes] == [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28]
    assert shapes[-1][3:] == (135, 181)  # 2172 -> 1086 -> 543 -> 271 -> 135
    assert counts.step_flops(cfg, 2172, 2896) / 1e12 == pytest.approx(9.539, abs=0.001)


def test_trunk_least_time_takes_the_larger_bound(cfg):
    flops_only = counts.trunk_flops(cfg, 384, 512) / 495e12
    assert counts.trunk_least_s(cfg, 384, 512, 495e12, 1e30) == pytest.approx(flops_only)
    assert counts.trunk_least_s(cfg, 384, 512, 495e12, 3.35e12) > flops_only
    bf16 = dict(cfg, precision="bf16")
    assert (counts.trunk_least_s(bf16, 384, 512, 1e30, 3.35e12)
            == pytest.approx(counts.trunk_least_s(cfg, 384, 512, 1e30, 3.35e12) / 2))


def test_pyramid_canvases_and_peaks(cfg):
    traffic = {"content": [512, 384], "min_scale": 128, "end_scale": 512,
               "initial_iterations": 1000, "iterations": 500}
    assert counts.scale_canvases(traffic) == [(128, 96, 1000), (181, 136, 500), (256, 192, 500),
                                              (362, 272, 500), (512, 384, 500)]
    assert counts.peak_flops(cfg, "NVIDIA H100 80GB HBM3") == 495e12
    assert counts.peak_flops(dict(cfg, peak="bf16_dense"), "NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(KeyError):
        counts.peaks("cpu")
