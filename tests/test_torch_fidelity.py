"""PyTorch port: ``tools/fidelity_torch.py``, the fidelity harness, in
process on the CPU at 64 px.

Self-consistency: outputs of one run fed back as the 'reference' of a
second identical run must score perfectly and pass; a wrong reference must
fail with exit code 1."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def tool(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "fidelity_torch", REPO / "tools" / "fidelity_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for var in ("STT_LPIPS_WEIGHTS", "STT_VGG19_NPZ"):
        monkeypatch.delenv(var, raising=False)
    return mod


def _inputs(tmp_path, seed):
    rng = np.random.RandomState(seed)
    content, style = tmp_path / "c.png", tmp_path / "s.png"
    Image.fromarray(rng.randint(0, 255, (96, 128, 3), np.uint8)).save(content)
    Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(style)
    return [str(content), str(style), "--configs", "c2_pyramid512", "--end-scale", "64",
            "--min-scale", "64", "--iterations", "4", "--devices", "cpu"], rng


def _lines(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_fidelity_self_consistency(tmp_path, tool, capsys):
    common, _ = _inputs(tmp_path, 0)
    ref_dir = tmp_path / "ref"
    assert tool.main(common + ["--out", str(ref_dir)]) == 0
    assert (ref_dir / "c2_pyramid512.png").is_file()
    assert "RANDOM VGG weights" in capsys.readouterr().err

    assert tool.main(common + ["--out", str(tmp_path / "ours"),
                               "--reference", str(ref_dir)]) == 0
    lines = _lines(capsys.readouterr().out)
    rec = next(l for l in lines if l.get("config") == "c2_pyramid512")
    assert rec["pass"] is True
    assert rec["psnr"] > 50  # identical trajectories
    assert rec["perceptual"] < 1e-4
    assert rec["perceptual_metric"] == "vgg_distance_proxy"
    summary = next(l for l in lines if "summary" in l)["summary"]
    assert summary["compared"] == summary["passed"] == 1
    assert summary["thresholds"] == {"psnr_min": 20.0, "perceptual_max": 0.02}


def test_fidelity_detects_mismatch(tmp_path, tool, capsys):
    """A wrong reference output must fail the thresholds (exit 1)."""
    common, rng = _inputs(tmp_path, 1)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).save(
        ref_dir / "c2_pyramid512.png")
    assert tool.main(common + ["--out", str(tmp_path / "ours"),
                               "--reference", str(ref_dir)]) == 1
    rec = next(l for l in _lines(capsys.readouterr().out)
               if l.get("config") == "c2_pyramid512")
    assert rec["pass"] is False and rec["psnr"] < 20.0
