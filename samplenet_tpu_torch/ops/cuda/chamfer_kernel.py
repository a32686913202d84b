"""1-NN of every query in a database cloud, and the 1-NN snap: the CUDA
kernels' wrappers and their plain PyTorch versions.

Mirrors samplenet_tpu/ops/pallas/chamfer_kernel.py:28-83 (the Pallas body)
and :176-218 (`nn_direction`, `nn_snap`, `nn_distance_pallas`). The
kernels are csrc/nn_direction.cu; its note says what bounds them and how
they are laid out. Both versions compute d = (dx*dx + dy*dy) + dz*dz
without FMA contraction, count a NaN distance as +inf and take the first
index of the minimum, so on the card they agree bit for bit; the snapped
points are copies of the database's.
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.cuda._build import check, library, stream_handle
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel

KERNEL = "nn_direction"
KERNEL_SNAP = "nn_snap"
_QUERY_TILE = 32       # csrc/nn_direction.cu kQueryTile
_MAX_GRID_Y = 65535


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
    index of, each x point's nearest y point; ties to the lowest index."""
    dx = x[:, :, None, 0] - y[:, None, :, 0]      # [B, N1, N2]
    dy = x[:, :, None, 1] - y[:, None, :, 1]
    dz = x[:, :, None, 2] - y[:, None, :, 2]
    d = dx * dx
    d = d + dy * dy
    d = d + dz * dz
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return d.amin(dim=2), torch.argmin(d, dim=2).to(torch.int32)


def nn_direction(x: torch.Tensor, y: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist [B, N1], idx [B, N1]): NN of every x point in y. CPU tensors
    take `nn_direction_plain`, CUDA tensors the kernel (ops/dispatch.py)."""
    _check_args(x, y)
    if not use_kernel(x):
        return nn_direction_plain(x, y)
    return _nn_direction_cuda(x, y)


def _check_cuda(x: torch.Tensor, y: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, "
                         f"got {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"the {name} kernel takes contiguous x and y")
    if x.dtype != torch.float32:
        raise TypeError(f"the {name} kernel takes float32, got {x.dtype}")
    n1 = x.shape[1]
    if -(-n1 // _QUERY_TILE) > _MAX_GRID_Y:
        raise ValueError(f"N1={n1} exceeds the kernel's grid "
                         f"({_QUERY_TILE * _MAX_GRID_Y} queries)")


def _nn_direction_cuda(x: torch.Tensor, y: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    _check_cuda(x, y, KERNEL)
    b, n1, _ = x.shape
    n2 = y.shape[1]
    dist = torch.empty((b, n1), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, n1), dtype=torch.int32, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.snt_nn_direction(
            x.data_ptr(), y.data_ptr(), dist.data_ptr(), idx.data_ptr(),
            b, n1, n2, stream_handle(x))
    check(err, KERNEL)
    count_launch(KERNEL)
    return dist, idx


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
    dist = torch.empty((b, n1), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, n1), dtype=torch.int32, device=x.device)
    snapped = torch.empty((b, n1, 3), dtype=torch.float32, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.snt_nn_snap(
            x.data_ptr(), y.data_ptr(), dist.data_ptr(), idx.data_ptr(),
            snapped.data_ptr(), b, n1, y.shape[1], stream_handle(x))
    check(err, KERNEL_SNAP)
    count_launch(KERNEL_SNAP)
    return dist, idx, snapped


def nn_distance_pallas(xyz1: torch.Tensor, xyz2: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """(dist1, idx1, dist2, idx2): the nearest-neighbour distances both
    ways (the tf_nndistance contract), two `nn_direction` calls; the name
    is the JAX package's (chamfer_kernel.py:212-218)."""
    d1, i1 = nn_direction(xyz1, xyz2)
    d2, i2 = nn_direction(xyz2, xyz1)
    return d1, i1, d2, i2
