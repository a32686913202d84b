"""Data parallelism on torch.distributed: the mesh, placement and the
collectives of a data-parallel train step.

Mirrors samplenet_tpu/parallel/mesh.py:1-96. There a ('data', 'model')
mesh shards every batch-leading tensor over 'data' and GSPMD inserts the
collectives, so that W devices compute what one device computes on the
whole global batch. Here each of W processes (ranks) holds B/W rows of a
global batch B (rank r rows [r*B/W, (r+1)*B/W), as P('data') places
them) and the port issues the collectives itself:

  * every BatchNorm statistic in training is taken over the global batch:
    each layer's sum and sum of squares, packed as one [2, C] tensor, is
    summed across ranks (`all_reduce_sum`, whose backward sums the
    cotangent), in nn/layers.py::BatchNorm and between the launches of
    the train chains' kernels (ops/cuda/point_mlp_*_kernel.py);
  * after the backward the trained parameters' gradients are averaged
    with one flat all-reduce (`average_gradients`, called by the guarded
    optimiser), the psum XLA inserts;
  * random draws (augmentation, dropout) are made for the global batch
    from generators seeded alike on every rank, each rank keeping its own
    rows (`global_rows`), as jax.random does on a sharded array.

No DistributedDataParallel: the steps call their modules next to frozen
networks, and DDP's buffer broadcast would hide running statistics that
differ across ranks. A module learns its mesh from `data_parallel`
(SyncBatchNorm.convert_sync_batchnorm's idiom), not from global state;
without a mesh nothing changes.

Tensor parallelism over the 'model' axis (`param_sharding_rules`,
:66-85) is not ported: `make_mesh(model > 1)` raises (ROADMAP Queue 1
item 9b).
"""

from __future__ import annotations

import os
import threading
from collections import Counter
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


@dataclass(frozen=True, eq=False)
class Mesh:
    """W data-parallel ranks: the process group (None for the default
    group), this process's rank, the world size W and the rank's device.
    `distributed` is False for a world of one without a process group, in
    which every collective is the identity."""

    group: Any
    rank: int
    size: int
    device: torch.device
    distributed: bool

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.size, "model": 1}


def local_device(device_type: str = "cuda") -> torch.device:
    """The rank's device: cuda:LOCAL_RANK (raises where there is no such
    card) or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or local >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank with LOCAL_RANK={local} needs cuda:{local}, but "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" CUDA device(s) are visible")
    return torch.device("cuda", local)


def initialize_distributed(device_type: str = "cuda") -> bool:
    """init_process_group from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL for cuda, gloo for cpu.
    Without that environment the run is a world of one and nothing is
    initialised, as the JAX function tolerates single-process runs.
    True where a process group exists afterwards."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    device = local_device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return True


def make_mesh(data: int | None = None, model: int = 1, *, group=None,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh over every rank of `group` (the default group; a world of
    one where no process group is initialised). `data` must be the world
    size where given. `device` defaults to the current CUDA device under
    NCCL, else the CPU."""
    if model != 1:
        raise NotImplementedError(
            f"make_mesh(model={model}): tensor parallelism over the 'model' "
            f"axis is not ported (ROADMAP Queue 1 item 9b); the port's "
            f"meshes are data-parallel only")
    distributed = dist.is_initialized()
    size = dist.get_world_size(group) if distributed else 1
    rank = dist.get_rank(group) if distributed else 0
    if data is not None and data != size:
        raise ValueError(f"mesh {data}x{model} != {size} ranks")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if distributed and dist.get_backend(group) == "nccl" \
            else torch.device("cpu")
    return Mesh(group=group, rank=rank, size=size,
                device=torch.device(device), distributed=distributed)


# ------------------------------------------------------------- collectives

_collectives: Counter[str] = Counter()
_collectives_lock = threading.Lock()


def collective_counts() -> dict[str, int]:
    """All-reduces issued by this process since the last reset: the total
    and the bytes they carried (every all-reduce of the port goes through
    `all_reduce_`)."""
    with _collectives_lock:
        return dict(_collectives)


def reset_collective_counts() -> None:
    with _collectives_lock:
        _collectives.clear()


def all_reduce_(t: torch.Tensor, mesh: Mesh,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of t over the mesh's ranks, no gradient."""
    if mesh.distributed:
        dist.all_reduce(t, op=op, group=mesh.group)
        with _collectives_lock:
            _collectives["all_reduce"] += 1
            _collectives["bytes"] += t.numel() * t.element_size()
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_(t.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh), None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of t over the ranks, differentiable: the backward sums the
    cotangent over the ranks, so that each rank's gradient is that of the
    sum of every rank's loss."""
    return _AllReduceSum.apply(t, mesh)


def average_gradients(params, mesh: Mesh) -> None:
    """Each parameter's .grad replaced by its mean over the ranks, with one
    flat all-reduce (parameters without a gradient are left out alike on
    every rank)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, mesh).div_(mesh.size)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def global_mean(values: dict[str, torch.Tensor], mesh: Mesh | None
                ) -> dict[str, torch.Tensor]:
    """Each 0-d metric averaged over the ranks (one all-reduce): per-rank
    means over equal shards average to the global batch's mean."""
    if mesh is None or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().to(torch.float64).reshape(())
                        for k in keys])
    all_reduce_(flat, mesh).div_(mesh.size)
    return {k: v.to(values[k].dtype) for k, v in zip(keys, flat)}


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None and mesh.distributed:
        dist.barrier(group=mesh.group)


# ---------------------------------------------------------------- placement

def batch_rows(mesh: Mesh | None, batch: int) -> slice:
    """The rank's rows of a global batch of `batch` rows; raises where the
    ranks cannot hold equal shares."""
    if mesh is None:
        return slice(0, batch)
    if batch % mesh.size:
        raise ValueError(f"global batch {batch} is not divisible by the "
                         f"{mesh.size} ranks of the mesh")
    b = batch // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def global_rows(mesh: Mesh | None, local: int) -> tuple[int, slice]:
    """(B, rows): the global batch of ranks holding `local` rows each, and
    this rank's rows of it, for drawing randomness for the global batch."""
    size = 1 if mesh is None else mesh.size
    return local * size, batch_rows(mesh, local * size)


def shard_batch(mesh: Mesh | None, batch: Any) -> Any:
    """The rank's rows of a batch-leading array or tensor, or of each one
    in a tuple, list or dict."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return batch[batch_rows(mesh, len(batch))]


def _state_tensors(target) -> list[torch.Tensor]:
    if isinstance(target, torch.nn.Module):
        return [*target.parameters(), *target.buffers()]
    return list(target)


def replicated(mesh: Mesh, target, *, check: bool = False) -> Any:
    """Every parameter and buffer of a module (or each tensor of a list)
    broadcast from rank 0, in place. With `check`, first asserts that
    every rank already holds rank 0's bits."""
    tensors = _state_tensors(target)
    if not mesh.distributed:
        return target
    if check:
        same = True
        for t in tensors:
            ref = _broadcast(t.detach().clone(), mesh)
            same = same and torch.equal(ref, t.detach())
        if not min_over_ranks(int(same), mesh):
            raise AssertionError("ranks hold different bits of a replicated "
                                 "parameter or buffer")
    with torch.no_grad():
        for t in tensors:
            _broadcast(t.data, mesh)
    return target


def _broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """t from rank 0 on every rank, in place."""
    dist.broadcast(t, 0, group=mesh.group)
    return t


def shard_params(mesh: Mesh, target, *, check: bool = False) -> Any:
    """The JAX function places each parameter by `param_sharding_rules`,
    which replicate everything at model = 1, the only model axis the port
    has: so this is `replicated`."""
    return replicated(mesh, target, check=check)


def data_parallel(target, mesh: Mesh | None):
    """Puts `target` (a module, or a TrainState: its model and its
    optimiser) under `mesh`: every submodule that declares a `mesh`
    attribute (BatchNorm, whose statistics become global, the owners of
    dropout) gets it, and so does the guarded optimiser, which then
    averages the gradients. `mesh=None` takes it off. Returns target."""
    model = getattr(target, "model", target)
    for m in model.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    optimizer = getattr(target, "optimizer", None)
    if optimizer is not None:
        optimizer.mesh = mesh
    return target


def min_over_ranks(n: int, mesh: Mesh | None) -> int:
    """The smallest of every rank's `n`."""
    if mesh is None:
        return n
    t = torch.tensor(n, dtype=torch.int64, device=mesh.device)
    return int(all_reduce_(t, mesh, dist.ReduceOp.MIN))
