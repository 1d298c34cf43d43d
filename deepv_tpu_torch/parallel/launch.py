"""Start the ranks of a multi-card run: one process each, inside one
``torch.distributed`` process group.

    results = spawn(fn, world_size, args, backend="nccl")

runs ``fn(*args)`` in ``world_size`` fresh processes (the ``spawn`` start
method: each imports what ``fn`` needs anew, so ``fn`` must be importable
by name, and a worker of the port imports no JAX). Each process first joins
a process group on a free localhost port with its rank and the world size,
and leaves it when ``fn`` returns. The call returns every rank's return
value, in rank order (``torch.save``d by the rank into a temporary
directory of this call, loaded back here); if one rank raises, the others
are stopped and the call raises.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: how long a collective may wait for the other ranks before it fails
TIMEOUT = datetime.timedelta(minutes=10)


def _free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _result_path(out_dir: str, rank: int) -> str:
    return os.path.join(out_dir, f"rank{rank}.pt")


def _rank_main(rank: int, world_size: int, backend: str, port: int, out_dir: str, fn,
               args) -> None:
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world_size, rank=rank, timeout=TIMEOUT)
    # the ranks share this host's cores for their CPU work
    torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(result, _result_path(out_dir, rank))


def spawn(fn, world_size: int, args=(), backend: str = "nccl") -> list:
    """``fn(*args)`` in ``world_size`` processes, each inside the process
    group (``backend`` over ``tcp://127.0.0.1``); ``dist.get_rank()`` tells
    a process its rank. Returns their return values in rank order; raises
    if one raised."""
    with tempfile.TemporaryDirectory(prefix="deepv_ranks_") as out_dir:
        mp.spawn(_rank_main, args=(world_size, backend, _free_port(), out_dir, fn, tuple(args)),
                 nprocs=world_size, join=True)
        # files this call's own ranks wrote
        return [torch.load(_result_path(out_dir, r), weights_only=False)
                for r in range(world_size)]
