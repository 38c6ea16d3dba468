"""A run of a cell on the card, through the command the benchmark names
(``-m cuda``; skips without a card)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_of_the_step_cell(trace):
    _card()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run([*spec["command"], "--workload", "f32-step512", "--seed",
                          str(2**31 + 101), "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["compared"]
    assert list(result)[-1] == "compared"
    assert out.stderr.strip().splitlines()[-1].startswith("compared ")
    want = {m["name"] for m in spec["end_to_end" if not trace else "per_layer"]
            if "f32-step512" in m.get("workloads", ["f32-step512"])}
    assert set(result["metrics"]) == want
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


@pytest.mark.cuda
def test_the_command_refuses_a_tree_without_the_program(tmp_path):
    _card()
    subprocess.run(["cp", "-r", str(ROOT / "benchmark"), str(tmp_path)], check=True)
    subprocess.run(["cp", str(ROOT / "BENCHMARK.json"), str(tmp_path)], check=True)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "f32-step512",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
