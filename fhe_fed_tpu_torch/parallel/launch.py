"""Run a function in `world_size` ranks on this host, one process per rank.

    results = spawn(fn, world_size, args, device="cpu")

Each rank starts with torch.multiprocessing's spawn method (a fresh
interpreter that imports `fn` by its module path: keep rank bodies in a
module that imports nothing heavy at top level), joins the process group
through a file store in a fresh temporary directory (no port is chosen,
so concurrent runs never collide), calls fn(rank, world_size, *args),
and leaves the group. On the CPU the ranks run gloo with one intra-op
thread each; on CUDA, NCCL with one card a rank.

The ranks' return values come back through the file system (torch.save
under the same directory), in rank order.
"""

from __future__ import annotations

import pathlib
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import multihost


def _rank_main(rank: int, fn, world_size: int, store: str, device: str,
               backend: str | None, args: tuple) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    multihost.init_distributed(f"file://{store}", world_size, rank, device,
                               backend)
    try:
        out = fn(rank, world_size, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, pathlib.Path(store).with_name(f"result_{rank}.pt"))


def spawn(fn, world_size: int, args: tuple = (),
          device: str = "cuda", backend: str | None = None) -> list:
    """fn(rank, world_size, *args) in world_size ranks; returns their
    results in rank order. A rank that raises fails the whole run."""
    with tempfile.TemporaryDirectory() as tmp:
        store = str(pathlib.Path(tmp) / "store")
        mp.spawn(_rank_main, args=(fn, world_size, store, device, backend,
                                   args),
                 nprocs=world_size, join=True)
        return [torch.load(pathlib.Path(tmp) / f"result_{r}.pt",
                           weights_only=False) for r in range(world_size)]
