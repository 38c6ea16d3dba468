"""PyTorch port: CLI options beyond the Adam default, on the CPU."""

import json

import numpy as np
import pytest
import torch

from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu_torch import cli as tcli

torch.set_num_threads(2)


@pytest.fixture()
def files(tmp_path, content_pil, style_pil):
    content, style = tmp_path / "c.png", tmp_path / "s.png"
    content_pil.save(content)  # 128x96
    style_pil.save(style)
    weights = tmp_path / "w.npz"
    np.savez(weights, **random_params(0))
    return [str(content), str(style), "--devices", "cpu", "--vgg-weights",
            str(weights), "-o", str(tmp_path / "out.png"),
            "--trace", str(tmp_path / "trace.json")], tmp_path / "trace.json"


def test_optimizer_lbfgs_runs(files):
    argv, trace = files
    tcli.main(argv + ["--optimizer", "lbfgs", "--end-scale", "48", "-ii", "4"])
    t = json.loads(trace.read_text())
    assert t["args"]["optimizer"] == "lbfgs"
    assert [it["i"] for it in t["iterates"]] == [1, 2, 3, 4]
    assert all(np.isfinite(it["loss"]) for it in t["iterates"])


def test_end_scale_plus(files):
    """``--end-scale N+`` caps the total pixels of a non-square canvas."""
    argv, trace = files
    tcli.main(argv + ["--end-scale", "64+", "--min-scale", "64", "-i", "2",
                      "-ii", "2", "--callback-chunk", "2"])
    t = json.loads(trace.read_text())
    # 128x96 content, 4:3 aspect: safe scale = sqrt(4/3)*64 = 73
    assert t["args"]["end_scale"] == int((128 / 96) ** 0.5 * 64)
    assert {(it["w"], it["h"]) for it in t["iterates"]} == {(73, 55)}
