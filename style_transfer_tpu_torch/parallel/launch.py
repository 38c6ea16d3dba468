"""Start one process per device for a sharded run.

JAX is single controller and needs no launcher; here each device is driven
by a process of its own (``torch.multiprocessing`` with ``spawn``), and the
processes form one ``torch.distributed`` group:

* the backend is NCCL when every rank has a CUDA device of its own, and
  gloo on the CPU or when ranks share one card (``mesh.pick_backend``);
* the CUDA kernels are built once here, before the ranks start, so they do
  not all run nvcc (the build renames its library into place atomically, so
  this saves time only);
* every collective is bounded by the group's ``timeout``;
* when a rank raises, it prints its error, the others are killed and
  :func:`launch` raises in turn; nothing is retried on fewer devices;
* a Ctrl-C stops the run as it stops a one-device run, with the output
  written: in a rank, SIGINT only sets the mesh's ``interrupt`` (a
  ``KeyboardInterrupt`` at an arbitrary point would leave the rank in
  another collective than its peers), and the ranks agree at a chunk end to
  stop (``mesh.any_rank_stops``); the launcher passes a SIGINT on to the
  ranks and goes on waiting for them;
* CPU ranks share the host's cores: each takes ``cpu_count // world``
  threads.
"""

import contextlib
import datetime
import os
import signal
import socket
import sys
import threading
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import factor_devices, make_mesh, pick_backend

__all__ = ["DEFAULT_TIMEOUT_S", "launch"]

DEFAULT_TIMEOUT_S = 300.0


def _free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, devices, backend, port, timeout_s, args):
    interrupt = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: interrupt.set())
    world = len(devices)
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(make_mesh(device, interrupt), *args)
    except BaseException:
        # The launcher reports the first rank it finds failed, which may be
        # a peer that lost its connection: every rank prints its own error.
        print(f"rank {rank} of {world} failed:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        raise
    finally:
        dist.destroy_process_group()


def launch(fn, devices, args=(), timeout_s: float = DEFAULT_TIMEOUT_S):
    """Runs ``fn(mesh, *args)`` in one new process per entry of ``devices``
    (rank i on ``devices[i]``; a device named twice is shared by two ranks)
    and waits for all of them. ``fn`` must be importable by name (a
    module-level function), since the ranks start from a fresh interpreter.
    Raises ``torch.multiprocessing.ProcessRaisedException`` (or
    ``ProcessExitedException``) when a rank fails, after ending the others.
    Called from the main thread, it passes each SIGINT on to the ranks
    while it waits for them.
    """
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", d.index or 0) if d.type == "cuda" else d
               for d in devices]
    backend = pick_backend(devices)
    rows, cols = factor_devices(len(devices))
    print(f"Sharding over {len(devices)} ranks ({rows}x{cols} grid) on "
          f"{' '.join(map(str, devices))} with the {backend} backend")
    if any(d.type == "cuda" for d in devices):
        from ..ops.cuda import build

        build.load()
    ranks = []

    def pass_on(signum, frame):
        for proc in ranks:
            with contextlib.suppress(ProcessLookupError):  # a rank that has ended
                os.kill(proc.pid, signal.SIGINT)

    main_thread = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGINT, pass_on) if main_thread else None
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=len(devices), join=False, start_method="spawn",
            args=(fn, devices, backend, _free_port(), timeout_s, tuple(args)))
        ranks.extend(ctx.processes)
        while not ctx.join():
            pass
    finally:
        if main_thread:
            signal.signal(signal.SIGINT, signal.SIG_DFL if previous is None else previous)
