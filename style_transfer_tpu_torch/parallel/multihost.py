"""Runs started by torchrun (one process per device, on one host or many).

Port of ``style_transfer_tpu/parallel/multihost.py``: :func:`initialize`
joins the process group from torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), and is a no-op
that returns False without it, as the JAX one is without a coordinator.

    torchrun --nproc-per-node 2 -m style_transfer_tpu_torch.cli content.jpg style.jpg
"""

import datetime
import os

import torch
import torch.distributed as dist

from .launch import DEFAULT_TIMEOUT_S

__all__ = ["initialize", "is_multihost", "local_device", "local_device_count"]

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK``, or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    index = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or index >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {index} has no CUDA device of its own")
    return torch.device("cuda", index)


def initialize(device_type: str = "cuda") -> bool:
    """Joins torchrun's process group (NCCL on CUDA devices, gloo on the
    CPU), every collective bounded as the launcher's. Returns False, doing
    nothing, when the process was not started by torchrun."""
    if not all(k in os.environ for k in _ENV):
        return False
    if not dist.is_initialized():
        device = local_device(device_type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://",
                                timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    return True


def is_multihost() -> bool:
    """Whether the process group spans more than one host."""
    if not dist.is_initialized():
        return False
    world = dist.get_world_size()
    return int(os.environ.get("LOCAL_WORLD_SIZE", world)) < world


def local_device_count() -> int:
    """The devices this host offers: its CUDA devices, or the CPU."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1
