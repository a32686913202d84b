"""Spawning a group of ranks in new processes.

`spawn(fn, world, *args, model=M)` starts `world` processes joined by a
gloo process group (rendezvous through a file in a fresh temporary
directory, never a fixed port), runs fn(mesh, *args) in each, on the
(world // M) x M mesh, and returns their results in rank order. It is how the dry run, the card checks and the
tests run W ranks on one host; gloo also takes CUDA tensors (staged
through the host), so several ranks can share one card, which NCCL
refuses. torchrun over NCCL, one rank a card, is the production launch
(parallel/mesh.py::initialize_distributed).

A rank that raises fails the call with its traceback, and the others are
stopped; a group that has not ended after `timeout` seconds is killed
and the call raises. Nothing falls back.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from collections.abc import Callable
from typing import Any

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from samplenet_tpu_torch.parallel.mesh import make_mesh


def _rank_main(rank: int, fn: Callable, world: int, tmp: str, device: str,
               args: tuple, timeout: float, model: int) -> None:
    torch.set_num_threads(1)        # the ranks share the host's cores
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(make_mesh(model=model, device=dev), *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, device: str = "cpu",
          timeout: float = 120.0, model: int = 1) -> list[Any]:
    """[fn(mesh, *args) of rank r for r in range(world)] on a mesh with
    `model` ranks on its model axis: fn must be a module-level function
    and its result picklable by torch.save (CPU tensors, numbers,
    containers)."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, world, tmp, str(device), args, timeout, model),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world} ranks of {fn.__name__} did not end within "
                        f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
