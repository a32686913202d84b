"""1-NN of every query in a database cloud, and the 1-NN snap: the CUDA
kernels' wrappers and their plain PyTorch versions.

Mirrors samplenet_tpu/ops/pallas/chamfer_kernel.py:28-83 (the Pallas body)
and :176-218 (`nn_direction`, `nn_snap`, `nn_distance_pallas`). The
kernels are csrc/nn_direction.cu; its note says what bounds them and how
they are laid out, and their launch (lanes a query, queries a thread,
block width, points staged at a time) comes from nn_plan.py. Both
versions compute d = (dx*dx + dy*dy) + dz*dz without FMA contraction and
take the first index of the minimum, so on the card they agree bit for
bit under every plan; the snapped points are copies of the database's. A
NaN distance ranks below every number, as in the JAX package's path off
the TPU (samplenet_tpu/ops/pairwise.py::chunked_min_argmin, which
nn_distance and nn_match_from_clouds run there): a query with a NaN
distance to some point gets dist NaN and the first such index, and a
query with a NaN coordinate index 0.
"""

from __future__ import annotations

import functools

import torch

from samplenet_tpu_torch.ops.cuda import nn_plan as npl
from samplenet_tpu_torch.ops.cuda._build import check, library, stream_handle
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel

KERNEL = "nn_direction"
KERNEL_SNAP = "nn_snap"


def _check_args(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 3 or y.dim() != 3 or x.shape[-1] != 3 or y.shape[-1] != 3 \
            or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"nn_direction takes x [B, N1, 3] and y [B, N2, 3], got "
            f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.shape[1] == 0 or y.shape[1] == 0:
        raise ValueError("nn_direction needs N1 >= 1 and N2 >= 1")
    if x.dtype != y.dtype or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"nn_direction takes float32 (or float64 on the plain "
                        f"path), got {x.dtype}, {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")


def nn_direction_plain(x: torch.Tensor, y: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist [B, N1] f32, idx [B, N1] int32): squared distance to, and
    index of, each x point's nearest y point; ties to the lowest index, and
    NaN before every number (amin and argmin propagate it)."""
    dx = x[:, :, None, 0] - y[:, None, :, 0]      # [B, N1, N2]
    dy = x[:, :, None, 1] - y[:, None, :, 1]
    dz = x[:, :, None, 2] - y[:, None, :, 2]
    d = dx * dx
    d = d + dy * dy
    d = d + dz * dz
    return d.amin(dim=2), torch.argmin(d, dim=2).to(torch.int32)


def nn_direction(x: torch.Tensor, y: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist [B, N1], idx [B, N1]): NN of every x point in y, through the
    op samplenet::nn_direction: `nn_direction_plain` on CPU tensors, the
    kernel on CUDA tensors (ops/dispatch.py); under `plain_on_cuda()` the
    plain version on the card. dist is differentiable in x and y."""
    _check_args(x, y)
    if use_kernel(x):  # checked here too: tracing runs no CUDA impl
        _check_cuda(x, y, KERNEL)
    elif x.device.type == "cuda":                  # under plain_on_cuda()
        return nn_direction_plain(x, y)
    return nn_direction_op(x, y)


@torch.library.custom_op("samplenet::nn_direction", mutates_args=(),
                         device_types="cpu")
def nn_direction_op(x: torch.Tensor, y: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The op a torch.export program carries; on the CPU the plain
    version."""
    return nn_direction_plain(x, y)


@nn_direction_op.register_kernel("cuda")
def _nn_direction_cuda(x, y):
    _check_cuda(x, y, KERNEL)
    b, n1, _ = x.shape
    return launch(x, y, kernel_plan(x.device.index, b, n1, y.shape[1]))


@nn_direction_op.register_fake
def _nn_direction_fake(x, y):
    shape = x.shape[:2]
    return x.new_empty(shape), x.new_empty(shape, dtype=torch.int32)


def _nn_direction_setup(ctx, inputs, output):
    x, y = inputs
    ctx.save_for_backward(x, y, output[1])


def _nn_direction_bwd(ctx, g_dist, _g_idx):
    """The plain version's gradient away from ties (amin splits a tie, this
    gives it to the first index): 2g(x - y[idx]) to x, its negation summed
    into y by a one-hot bmm (no float atomics)."""
    from samplenet_tpu_torch.ops.chamfer import scatter_rows, take_rows

    x, y, idx = ctx.saved_tensors
    v = 2.0 * g_dist[..., None] * (x - take_rows(y, idx))
    return v, -scatter_rows(idx, v, y.shape[1])


nn_direction_op.register_autograd(_nn_direction_bwd,
                                  setup_context=_nn_direction_setup)


def _check_cuda(x: torch.Tensor, y: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, "
                         f"got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the {name} kernel takes float32, got {x.dtype}")


@functools.lru_cache(maxsize=256)
def kernel_plan(device: int, b: int, n1: int, n2: int) -> npl.NnPlan:
    """The kernel's launch plan on CUDA device `device`; checks that the
    kernel counts shared memory and its limits as the plan does."""
    lib = library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = npl.plan(b, n1, n2, sms)
    limits = (npl.MAX_WARPS, npl.MAX_CHUNK, npl.LANES[-1], npl.QUERIES[-1])
    if (tuple(lib.snt_nn_limit(i) for i in range(4)) != limits
            or lib.snt_nn_smem(plan.chunk, n2) != plan.smem(n2)
            or lib.snt_nn_smem(32, 33) != npl.nn_smem(32, 33)):
        raise RuntimeError("csrc/nn_direction.cu and nn_plan.py disagree on "
                           "the kernel's limits or shared memory")
    return plan


def launch(x: torch.Tensor, y: torch.Tensor, plan: npl.NnPlan,
           snap: bool = False) -> tuple[torch.Tensor, ...]:
    """The kernel (the snap entry with `snap`) on checked arguments under
    `plan`: (dist, idx), or (dist, idx, snapped). The outputs do not depend
    on the plan (the card tests run every one). Strided x or y are made
    contiguous first, the kernel reading rows (a no-op for contiguous
    ones)."""
    x, y = x.contiguous(), y.contiguous()
    b, n1, _ = x.shape
    n2 = y.shape[1]
    if not npl.valid(plan, b, n1, n2):
        raise ValueError(f"the nn kernel does not take {plan} for B={b}, "
                         f"N1={n1}, N2={n2}")
    dist = torch.empty((b, n1), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, n1), dtype=torch.int32, device=x.device)
    snapped = (torch.empty((b, n1, 3), dtype=torch.float32, device=x.device)
               if snap else None)
    lib = library()
    args = (b, n1, n2, plan.lanes, plan.queries, plan.warps, plan.chunk,
            stream_handle(x))
    with torch.cuda.device(x.device):
        if snap:
            err = lib.snt_nn_snap(x.data_ptr(), y.data_ptr(), dist.data_ptr(),
                                  idx.data_ptr(), snapped.data_ptr(), *args)
        else:
            err = lib.snt_nn_direction(x.data_ptr(), y.data_ptr(),
                                       dist.data_ptr(), idx.data_ptr(), *args)
    name = KERNEL_SNAP if snap else KERNEL
    check(err, name)
    count_launch(name)
    return (dist, idx, snapped) if snap else (dist, idx)


def nn_snap_plain(x: torch.Tensor, y: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dist [B, N1], idx [B, N1], snapped [B, N1, 3]): `nn_direction_plain`
    and the nearest y point of each x point, gathered at idx. No gradient
    flows through it: the snap is an inference step."""
    with torch.no_grad():
        dist, idx = nn_direction_plain(x, y)
        snapped = torch.gather(y, 1, idx.long()[..., None].expand(-1, -1, 3))
    return dist, idx, snapped


def nn_snap(x: torch.Tensor, y: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dist [B, N1], idx [B, N1], snapped [B, N1, 3]): each x point's
    nearest y point and that point's coordinates, the hard projection's
    1-NN snap (chamfer_kernel.py:192-209). CPU tensors take
    `nn_snap_plain`, CUDA tensors the kernel (ops/dispatch.py)."""
    _check_args(x, y)
    if not use_kernel(x):
        return nn_snap_plain(x, y)
    _check_cuda(x, y, KERNEL_SNAP)
    b, n1, _ = x.shape
    return launch(x, y, kernel_plan(x.device.index, b, n1, y.shape[1]),
                  snap=True)


def nn_distance_pallas(xyz1: torch.Tensor, xyz2: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """(dist1, idx1, dist2, idx2): the nearest-neighbour distances both
    ways (the tf_nndistance contract), two `nn_direction` calls; the name
    is the JAX package's (chamfer_kernel.py:212-218)."""
    d1, i1 = nn_direction(xyz1, xyz2)
    d2, i2 = nn_direction(xyz2, xyz1)
    return d1, i1, d2, i2
