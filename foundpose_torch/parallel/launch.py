"""Runs a function on N ranks of a fresh process group on this machine.

    launch.run(fn, 4, *args)   # fn(rank, world_size, *args) in 4 processes

Each rank is a process of the spawn context (forking a process that holds
threads or a CUDA context is unsafe), initializes the default group through
a file:// store in a temporary directory on the gloo backend (NCCL refuses
several ranks on one card; gloo reduces CPU and CUDA tensors alike), and
calls the module-level function `fn`. A rank that raises makes `run` raise
and stops the other ranks. Every collective has a deadline (`timeout`, 300
s by default, where gloo's own is 30 minutes): a rank stuck in one raises
then, and so does `run`. The JAX package needs no counterpart: its
runtime gives one program every device of the mesh. Multi-node launches go
through torchrun instead.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def _rank_main(rank, fn, world_size, init_method, args, timeout):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_WORLD_SIZE=str(world_size))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world_size,
                            timeout=timeout)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def run(fn, world_size: int, *args, timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """fn(rank, world_size, *args) on world_size spawned ranks; raises if a
    rank fails, or if a collective waits longer than `timeout`. `fn` and
    `args` must pickle (module-level function)."""
    with tempfile.TemporaryDirectory(prefix="foundpose_group_") as d:
        mp.start_processes(
            _rank_main,
            args=(fn, world_size, f"file://{os.path.join(d, 'store')}", args, timeout),
            nprocs=world_size, join=True, start_method="spawn",
        )
