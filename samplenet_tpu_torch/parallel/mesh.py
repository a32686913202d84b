"""Data and tensor parallelism on torch.distributed: the ('data', 'model')
mesh, placement and the collectives of a parallel train step.

Mirrors samplenet_tpu/parallel/mesh.py:1-96. There a ('data', 'model')
mesh shards every batch-leading tensor over 'data', shards the widest
layers over 'model' (`param_sharding_rules`, :66-85) and GSPMD inserts
the collectives, so that every mesh shape computes what one device
computes on the whole global batch. Here each of W = D * M processes
(ranks) is one device of that mesh: rank = data_index * M + model_index
(np.reshape(devices, (D, M)), :44), so adjacent ranks share a model
group. The D ranks of one model index hold the D row shards of a global
batch B (data index d rows [d*B/D, (d+1)*B/D), as P('data') places them);
the M ranks of one data index hold the same rows. The port issues the
collectives itself:

  * every BatchNorm statistic in training is taken over the global batch:
    each layer's sum and sum of squares, packed as one [2, C] tensor, is
    summed over the data group (`all_reduce_sum`, whose backward sums the
    cotangent), in nn/layers.py::BatchNorm and between the launches of
    the train chains' kernels (`Blocks`, the reducer the kernel wrappers
    of ops/cuda/ take);
  * after the backward the trained parameters' gradients are averaged
    over the data group with one flat all-reduce (`average_gradients`,
    called by the guarded optimiser), the psum XLA inserts; under a model
    axis the optimiser's non-finite flag is then agreed over the world;
  * random draws (augmentation, dropout) are made for the global batch
    from generators seeded alike on every rank, each rank keeping its
    data index's rows (`global_rows`), as jax.random does on a sharded
    array;
  * tensor parallelism (M > 1): `shard_params` keeps on each rank the
    column block of every leaf that `param_sharding_rules` shards (a
    layer's output channels, dim 0 of a torch weight, with its bias and
    its BatchNorm). A sharded layer runs column-parallel: its input
    enters through `copy_to_model` (identity forward; the backward sums
    the cotangent over the model group, since each rank's columns give
    a part of the input's gradient), the rank's columns make its channel
    block, its BatchNorm normalises that block with statistics summed
    over the data group only, and `gather_from_model` all-gathers the
    block where a layer needs the whole feature (backward: the rank's
    slice). A fused kernel takes whole weights, gathered the same way:
    every rank of a model group then computes the same whole-weight
    gradient from the same rows, and the gather's backward keeps the
    rank's slice (the JAX package forces a kernel's non-batch operands
    replicated, ops/pallas/partitioning.py, so GSPMD gathers them too).

No DistributedDataParallel: the steps call their modules next to frozen
networks, and DDP's buffer broadcast would hide running statistics that
differ across ranks. A module learns its mesh from `data_parallel`
(SyncBatchNorm.convert_sync_batchnorm's idiom) and its shard from
`shard_params`, not from global state; without a mesh nothing changes.
"""

from __future__ import annotations

import math
import os
import threading
import weakref
from collections import Counter
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

@dataclass(frozen=True, eq=False)
class Mesh:
    """W = D * M ranks: the world's process group (None for the default
    group), this process's world rank, W, the rank's device, whether a
    process group exists (False for a world of one without one, in which
    every collective is the identity), M, and the process groups of the
    rank's data axis (the D ranks of its model index) and model axis (the
    M ranks of its data index)."""

    group: Any
    rank: int
    size: int
    device: torch.device
    distributed: bool
    model: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def data_size(self) -> int:
        return self.size // self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data_size, "model": self.model}

    def axis(self, axis: str) -> tuple[Any, int]:
        """(process group, ranks) of `axis`: "data", "model" or "world"."""
        if axis == "data":
            return self.data_group, self.data_size
        if axis == "model":
            return self.model_group, self.model
        if axis == "world":
            return self.group, self.size
        raise ValueError(f"axis must be 'data', 'model' or 'world', got "
                         f"{axis!r}")


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
    """The D x M mesh over every rank of `group` (the default group; a
    world of one where no process group is initialised): data = W //
    model where not given, and data * model must be W (:30-47). Every
    rank of the world calls this together: it creates the data and model
    groups (torch.distributed.new_group) where both axes exceed 1.
    `device` defaults to the current CUDA device under NCCL, else the
    CPU."""
    distributed = dist.is_initialized()
    size = dist.get_world_size(group) if distributed else 1
    rank = dist.get_rank(group) if distributed else 0
    if data is None:
        data = size // model
    if model < 1 or data * model != size:
        raise ValueError(f"mesh {data}x{model} != {size} ranks")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if distributed and dist.get_backend(group) == "nccl" \
            else torch.device("cpu")
    data_group = model_group = group
    if distributed and data > 1 and model > 1:
        ranks = dist.get_process_group_ranks(group) if group is not None \
            else list(range(size))
        for m in range(model):          # every rank makes every group
            g = dist.new_group([ranks[d * model + m] for d in range(data)])
            if m == rank % model:
                data_group = g
        for d in range(data):
            g = dist.new_group([ranks[d * model + m] for m in range(model)])
            if d == rank // model:
                model_group = g
    return Mesh(group=group, rank=rank, size=size,
                device=torch.device(device), distributed=distributed,
                model=model, data_group=data_group, model_group=model_group)


# ------------------------------------------------------------- collectives

_collectives: Counter[str] = Counter()
_collectives_lock = threading.Lock()


def collective_counts() -> dict[str, int]:
    """Collectives issued by this process since the last reset: the
    all-reduces and the bytes they carried ("all_reduce", "bytes"), the
    all-gathers and the bytes each rank sent ("all_gather",
    "gather_bytes"). Every collective of a step goes through
    `all_reduce_` or `all_gather`; one over an axis of one rank is not
    issued."""
    with _collectives_lock:
        return dict(_collectives)


def reset_collective_counts() -> None:
    with _collectives_lock:
        _collectives.clear()


def all_reduce_(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM,
                axis: str = "data") -> torch.Tensor:
    """In-place all-reduce of t over the ranks of the mesh's `axis` (the
    batch axis by default), no gradient."""
    group, n = mesh.axis(axis)
    if mesh.distributed and n > 1:
        dist.all_reduce(t, op=op, group=group)
        with _collectives_lock:
            _collectives["all_reduce"] += 1
            _collectives["bytes"] += t.numel() * t.element_size()
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, dim: int = -1) -> torch.Tensor:
    """Every model-group rank's t, concatenated along `dim` in model-index
    order, no gradient."""
    group, n = mesh.axis("model")
    if not mesh.distributed or n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    with _collectives_lock:
        _collectives["all_gather"] += 1
        _collectives["gather_bytes"] += t.numel() * t.element_size()
    return torch.cat(parts, dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce_(t.contiguous().clone(), mesh, axis=axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh,
                           axis=ctx.axis), None, None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh,
                   axis: str = "data") -> torch.Tensor:
    """The sum of t over the ranks of `axis`, differentiable: the backward
    sums the cotangent over them, so that each rank's gradient is that of
    the sum of every rank's loss."""
    return _AllReduceSum.apply(t, mesh, axis)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh,
                           axis="model"), None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x entering a column-parallel layer: the identity, whose backward
    sums the cotangent over the model group (each rank's columns give
    one part of x's gradient)."""
    return x if mesh.model == 1 else _CopyToModel.apply(x, mesh)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.width = mesh, dim, x.shape[dim]
        return all_gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.model_rank * ctx.width,
                        ctx.width), None, None


def gather_from_model(x: torch.Tensor, mesh: Mesh,
                      dim: int = -1) -> torch.Tensor:
    """The model group's blocks of x all-gathered along `dim`; the
    backward keeps this rank's slice of the cotangent."""
    return x if mesh.model == 1 else _GatherFromModel.apply(x, mesh, dim)


def average_gradients(params, mesh: Mesh) -> None:
    """Each parameter's .grad replaced by its mean over the data group,
    with one flat all-reduce (parameters without a gradient are left out
    alike on every rank; a sharded parameter's data group holds its
    block on every rank)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, mesh).div_(mesh.data_size)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def global_mean(values: dict[str, torch.Tensor], mesh: Mesh | None
                ) -> dict[str, torch.Tensor]:
    """Each 0-d metric averaged over the world (one all-reduce): per-rank
    means over equal shards average to the global batch's mean, and the
    ranks of a model group hold the same value."""
    if mesh is None or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().to(torch.float64).reshape(())
                        for k in keys])
    all_reduce_(flat, mesh, axis="world").div_(mesh.size)
    return {k: v.to(values[k].dtype) for k, v in zip(keys, flat)}


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None and mesh.distributed:
        dist.barrier(group=mesh.group)


class Blocks:
    """The reducer the train chains' wrappers take (ops/cuda/
    point_mlp_*_kernel.py): the blocks of a global batch split over the
    data axis, for statistics per block: blocks of `block_b` clouds of
    the global batch (the ghost chain's; the exact chain is one block of
    all of them). The rank runs its kernels on sub-blocks of `sub`
    clouds, the largest count that divides both its batch and block_b,
    and `group` = block_b / sub consecutive sub-blocks in global
    (data-index-major) order make one block; with group 1 every block
    lies within a rank and its statistics need no collective. The JAX
    package chooses block_b from the global batch and GSPMD gathers a
    block that straddles devices, so its result is the single device's;
    `sums` gives the same here with one all-reduce over the data group."""

    def __init__(self, mesh: Mesh, local_b: int, block_b: int):
        self.mesh = mesh
        self.ranks = mesh.data_size
        self.block_b = block_b
        self.sub = math.gcd(local_b, block_b)
        self.group = block_b // self.sub

    def sums(self, t: torch.Tensor) -> torch.Tensor:
        """t [P, ...], this rank's sums per sub-block -> each sub-block's
        row summed over its block."""
        if self.group == 1:
            return t
        p, w, r = t.shape[0], self.ranks, self.mesh.data_rank
        if p == 1 and self.group == w:        # one block of every rank
            return all_reduce_(t.clone(), self.mesh)
        full = t.new_zeros((w * p, *t.shape[1:]))
        full[r * p:(r + 1) * p] = t
        all_reduce_(full, self.mesh)
        full = full.reshape(w * p // self.group, self.group, *t.shape[1:])
        return full.sum(1).repeat_interleave(self.group, 0)[r * p:(r + 1) * p]

    def means(self, t: torch.Tensor) -> torch.Tensor:
        """t [P, ...], this rank's means per sub-block -> the means over
        each sub-block's block (sub-blocks hold equal counts)."""
        return self.sums(t) / self.group

    def global_means(self, rows: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each [P, C] of rows averaged over the sub-blocks of every data
        rank, one all-reduce for them all."""
        flat = all_reduce_(torch.cat([r.sum(0) for r in rows]), self.mesh)
        flat = flat / (self.ranks * rows[0].shape[0])
        return list(flat.split([r.shape[1] for r in rows]))


def batch_blocks(mesh: Mesh | None, local_b: int,
                 block_b: int | None = None) -> Blocks | None:
    """The reducer of blocks of `block_b` clouds (one block of the whole
    global batch by default, the exact chain's) for a rank holding
    `local_b` rows; None without a mesh."""
    if mesh is None:
        return None
    return Blocks(mesh, local_b,
                  local_b * mesh.data_size if block_b is None else block_b)


# ---------------------------------------------------------------- placement

def batch_rows(mesh: Mesh | None, batch: int) -> slice:
    """The rank's rows of a global batch of `batch` rows (its data index's
    share); raises where the data ranks cannot hold equal shares."""
    if mesh is None:
        return slice(0, batch)
    if batch % mesh.data_size:
        raise ValueError(f"global batch {batch} is not divisible by the "
                         f"{mesh.data_size} data ranks of the mesh")
    b = batch // mesh.data_size
    return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


def global_rows(mesh: Mesh | None, local: int) -> tuple[int, slice]:
    """(B, rows): the global batch of data ranks holding `local` rows
    each, and this rank's rows of it, for drawing randomness for the
    global batch."""
    size = 1 if mesh is None else mesh.data_size
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
    """A module's parameters and buffers but those of its sharded layers
    (each rank holds its own block of them), or a list of tensors."""
    if isinstance(target, torch.nn.Module):
        return [t for m in target.modules() if getattr(m, "shard", None)
                is None for t in (*m.parameters(recurse=False),
                                  *m.buffers(recurse=False))]
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


def param_sharding_rules(mesh: Mesh):
    """rule(name, leaf) -> 0 where `leaf` (a parameter or buffer in the
    port's layout) is sharded over 'model' on dim 0, else None. The JAX
    rule (:66-85), applied to the leaf's shape in the JAX layout: a 2-D
    kernel [in, out] with out >= 512 and out % (8 * model) == 0 is
    sharded on out, and so is a 1-D leaf of such a size (a bias, a
    BatchNorm's scale, bias and running statistics). A torch weight is
    [out, in] (a Linear) or [out, in, 1] (a PointConv, a Dense kernel in
    JAX), so out is dim 0 of every leaf."""
    model = mesh.model

    def rule(name: str, leaf: torch.Tensor) -> int | None:
        if model == 1 or leaf.dim() not in (1, 2, 3):
            return None
        out = leaf.shape[0]
        return 0 if out >= 512 and out % (8 * model) == 0 else None

    return rule


def model_block(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's block of t along dim 0: the model index's 1/M share."""
    k = t.shape[0] // mesh.model
    return t[mesh.model_rank * k:(mesh.model_rank + 1) * k]


def shard_params(mesh: Mesh, target, *, check: bool = False) -> Any:
    """Places `target` (a module, or a TrainState: its model and its
    optimiser) on the mesh, in place, and returns it: every parameter and
    buffer broadcast from rank 0 (`replicated`), then each rank keeps the
    column block (dim 0, the rank's model index) of every leaf that
    `param_sharding_rules` shards, and so do the optimiser's Adam moments
    of a sharded parameter. A layer with a sharded leaf gets `shard` =
    mesh, which makes it column-parallel (nn/layers.py); the rule shards
    every leaf of such a layer but num_batches_tracked. At model = 1 this
    is `replicated`. Layers already sharded are left as they are."""
    model = getattr(target, "model", target)
    replicated(mesh, model, check=check)
    if mesh.model == 1:
        return target
    optimizer = getattr(target, "optimizer", None)
    moments = {} if optimizer is None else optimizer.inner.optimizer.state
    rule = param_sharding_rules(mesh)
    with torch.no_grad():
        for m in model.modules():
            if getattr(m, "shard", None) is not None:
                continue
            leaves = [*m.named_parameters(recurse=False),
                      *m.named_buffers(recurse=False)]
            sharded = [(n, t) for n, t in leaves if rule(n, t) is not None]
            if not sharded:
                continue
            names = {n for n, _ in sharded}
            left = [n for n, t in leaves if t.dim() and n not in names]
            if left:
                raise NotImplementedError(
                    f"{type(m).__name__}: the rule shards "
                    f"{[n for n, _ in sharded]} but not {left}")
            for n, t in sharded:
                for v in moments.get(t, {}).values():
                    if v.shape == t.shape:
                        v.data = model_block(v, mesh).clone()
                t.data = model_block(t.data, mesh).clone()
            m.shard = mesh
    return target


def sharded_modules(target) -> list[tuple[str, torch.nn.Module]]:
    """(name, layer) of each sharded layer of a module."""
    return [(n, m) for n, m in target.named_modules()
            if getattr(m, "shard", None) is not None]


def full_state_dict(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The module's state_dict with every sharded leaf all-gathered whole
    (on every rank): what one process holds."""
    sd = module.state_dict()
    for prefix, m in sharded_modules(module):
        for n, t in (*m.named_parameters(recurse=False),
                     *m.named_buffers(recurse=False)):
            if t.dim():
                key = f"{prefix}.{n}" if prefix else n
                sd[key] = all_gather(t.detach(), m.shard, 0)
    return sd


def full_gradients(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Each parameter's .grad, all-gathered whole where the parameter is
    sharded."""
    owner = {id(p): m for _, m in sharded_modules(module)
             for p in m.parameters(recurse=False)}
    return {k: (p.grad if id(p) not in owner else
                all_gather(p.grad, owner[id(p)].shard, 0))
            for k, p in module.named_parameters() if p.grad is not None}


_device_meshes: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def device_mesh(mesh: Mesh):
    """The mesh as a torch.distributed DeviceMesh ('data', 'model') over
    the same ranks, made once (every rank calls this together the first
    time: it creates process groups), for DTensor placements."""
    if mesh not in _device_meshes:
        from torch.distributed.device_mesh import DeviceMesh

        ranks = dist.get_process_group_ranks(mesh.group) \
            if mesh.group is not None else list(range(mesh.size))
        _device_meshes[mesh] = DeviceMesh(
            mesh.device.type,
            torch.tensor(ranks).reshape(mesh.data_size, mesh.model),
            mesh_dim_names=("data", "model"))
    return _device_meshes[mesh]


def sharded_state_dict(module: torch.nn.Module) -> dict[str, Any]:
    """The module's state_dict with every sharded leaf a DTensor over the
    mesh's DeviceMesh: the rank's block, Shard(0) on 'model' and
    Replicate on 'data'. Its local tensors share storage with the
    module's leaves, so torch.distributed.checkpoint writes each block
    once from it and reads into the module in place
    (train/checkpoints.py::save_sharded / restore_sharded)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    sd = module.state_dict()
    for prefix, m in sharded_modules(module):
        mesh = m.shard
        for n, t in (*m.named_parameters(recurse=False),
                     *m.named_buffers(recurse=False)):
            if t.dim():
                shape = (t.shape[0] * mesh.model, *t.shape[1:])
                sd[f"{prefix}.{n}" if prefix else n] = DTensor.from_local(
                    t.detach(), device_mesh(mesh), [Replicate(), Shard(0)],
                    run_check=False, shape=torch.Size(shape),
                    stride=torch.empty(shape, device="meta").stride())
    return sd


def data_parallel(target, mesh: Mesh | None):
    """Puts `target` (a module, or a TrainState: its model and its
    optimiser) under `mesh`: every submodule that declares a `mesh`
    attribute (BatchNorm, whose statistics become the global batch's,
    the owners of dropout) gets it, and so does the guarded optimiser,
    which then averages the gradients. `mesh=None` takes it off. Returns
    target. Sharding the wide layers is `shard_params`'s."""
    model = getattr(target, "model", target)
    for m in model.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    optimizer = getattr(target, "optimizer", None)
    if optimizer is not None:
        optimizer.mesh = mesh
    return target


def min_over_ranks(n: int, mesh: Mesh | None) -> int:
    """The smallest of every rank's `n`, over the world."""
    if mesh is None:
        return n
    t = torch.tensor(n, dtype=torch.int64, device=mesh.device)
    return int(all_reduce_(t, mesh, dist.ReduceOp.MIN, axis="world"))
