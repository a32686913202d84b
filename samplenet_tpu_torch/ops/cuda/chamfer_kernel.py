"""1-NN of every query in a database cloud: the CUDA kernel's wrapper and
its plain PyTorch version.

Mirrors samplenet_tpu/ops/pallas/chamfer_kernel.py:28-83 (the Pallas body)
and :176-186 (`nn_direction`). The kernel is csrc/nn_direction.cu; its note
says what bounds it and how it is laid out. Both versions compute
d = (dx*dx + dy*dy) + dz*dz without FMA contraction and take the first
index of the minimum, so on the card they agree bit for bit.
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.cuda._build import check, library, stream_handle
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel

KERNEL = "nn_direction"
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
    return d.amin(dim=2), torch.argmin(d, dim=2).to(torch.int32)


def nn_direction(x: torch.Tensor, y: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist [B, N1], idx [B, N1]): NN of every x point in y. CPU tensors
    take `nn_direction_plain`, CUDA tensors the kernel (ops/dispatch.py)."""
    _check_args(x, y)
    if not use_kernel(x):
        return nn_direction_plain(x, y)
    return _nn_direction_cuda(x, y)


def _nn_direction_cuda(x: torch.Tensor, y: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    if x.device.type != "cuda":
        raise ValueError(f"the nn_direction kernel takes CUDA tensors, "
                         f"got {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("the nn_direction kernel takes contiguous x and y")
    if x.dtype != torch.float32:
        raise TypeError(f"the nn_direction kernel takes float32, got {x.dtype}")
    b, n1, _ = x.shape
    n2 = y.shape[1]
    if -(-n1 // _QUERY_TILE) > _MAX_GRID_Y:
        raise ValueError(f"N1={n1} exceeds the kernel's grid "
                         f"({_QUERY_TILE * _MAX_GRID_Y} queries)")
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
