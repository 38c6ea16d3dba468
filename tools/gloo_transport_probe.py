#!/usr/bin/env python3
"""Which torch.distributed calls take CUDA tensors with two ranks that share
one card, for the sharded path's transport (``parallel/mesh.py``).

    python3 tools/gloo_transport_probe.py gloo          # collectives, staged p2p
    PROBE_CUDA_P2P=1 python3 tools/gloo_transport_probe.py gloo  # + p2p of CUDA tensors
    python3 tools/gloo_transport_probe.py nccl          # NCCL with both ranks on cuda:0

Two ranks on cuda:0 run all_reduce (sum and max), all_gather and broadcast
of CUDA tensors, a send/recv staged through host tensors, and, when asked,
a send/recv of the CUDA tensors themselves; each call prints OK with its
result and host time, or FAILED with the error. A call that kills its rank
ends the run with a non-zero exit code. Needs one GPU.
"""

import datetime
import os
import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _step(rank, name, fn):
    print(f"rank {rank}: {name} ...", flush=True)
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
        print(f"rank {rank}: {name} OK {out} {1e3 * (time.perf_counter() - t0):.2f} ms",
              flush=True)
    except Exception as err:  # report and go on to the next call
        print(f"rank {rank}: {name} FAILED {type(err).__name__}: {str(err)[:300]}",
              flush=True)


def _worker(rank, backend, port):
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    x = torch.full((4, 1000), float(rank + 1), device="cuda:0")
    peer = 1 - rank

    def all_reduce(op=dist.ReduceOp.SUM):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return float(y[0, 0])

    def all_gather():
        out = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(out, x)
        return [float(o[0, 0]) for o in out]

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return float(y[0, 0])

    def p2p(staged):
        send = x.cpu() if staged else x
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, peer), dist.P2POp(dist.irecv, recv, peer)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return float(recv[0, 0])

    for name, fn in (("all_reduce", all_reduce),
                     ("all_reduce MAX", lambda: all_reduce(dist.ReduceOp.MAX)),
                     ("all_gather", all_gather), ("broadcast", broadcast),
                     ("p2p staged through host", lambda: p2p(True))):
        _step(rank, f"{backend} {name}", fn)
        dist.barrier()
    if backend == "nccl" or os.environ.get("PROBE_CUDA_P2P"):
        _step(rank, f"{backend} p2p of CUDA tensors", lambda: p2p(False))
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_worker, args=(sys.argv[1], _port()), nprocs=2, join=True)
