"""Iteration telemetry: the STIterate record and trace accumulation.

Port of ``style_transfer_tpu/utils/trace.py`` (reference progress contract,
``style_transfer.py:298-307`` and ``cli.py:107-140``): one ``STIterate`` per
optimization iteration and a ``trace.json`` with the run args plus all
iterates.

``gpu_ram`` is ``torch.cuda.max_memory_allocated`` of the device, whose peak
the engine resets at the start of each scale: the figure is the peak of the
scale the iterate belongs to (0 on the CPU).
"""

import json
from dataclasses import asdict, dataclass

import torch

__all__ = ["STIterate", "TraceRecorder", "peak_device_ram", "reset_peak_device_ram"]


@dataclass
class STIterate:
    w: int
    h: int
    i: int
    i_max: int
    loss: float
    time: float
    gpu_ram: int


def reset_peak_device_ram(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_device_ram(device) -> int:
    """Peak bytes allocated on ``device`` since the last reset (0 off CUDA)."""
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


class TraceRecorder:
    """Accumulates iterates; serializes to the reference's trace.json schema."""

    def __init__(self, args=None):
        self.args = args
        self.iterates = []

    def append(self, iterate: STIterate):
        self.iterates.append(asdict(iterate))

    def get_trace(self):
        args = self.args
        if args is not None and not isinstance(args, dict):
            args = dict(args.__dict__)
        return {"args": args, "iterates": self.iterates}

    def write(self, path="trace.json"):
        with open(path, "w") as fp:
            json.dump(self.get_trace(), fp, indent=4)
