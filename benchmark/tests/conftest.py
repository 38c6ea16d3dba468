"""Tiny cells for the CPU: the cells of ``BENCHMARK.json`` with their
traffic cut to a 64x48 canvas and a 64x64 style image."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
# Tiny shapes: more threads only contend, the more so beside other workers.
torch.set_num_threads(2)

TINY = {
    "step": dict(content=[64, 48], style=[64, 64], scale=64, chunk=2),
    "pyramid": dict(content=[64, 48], style=[64, 64], min_scale=32, end_scale=64,
                    initial_iterations=4, iterations=4, chunk=2, trace_host_iterations=2),
}


def tiny(name):
    from benchmark import harness

    cell = harness.load_cell(name)
    cell.traffic.update(TINY[cell.kind])
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
