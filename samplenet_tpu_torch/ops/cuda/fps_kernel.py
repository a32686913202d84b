"""Seeded farthest point sampling emitting indices and points: the CUDA
kernel's wrapper and its plain PyTorch version.

Mirrors samplenet_tpu/ops/pallas/fps_kernel.py:27-88 (the Pallas body) and
:173-248, whose four entry points are all this one kernel: the plain FPS is
count = 1 with given[:, 0] = start (ops/fps.py builds those arguments). The
kernel is csrc/fps.cu; its note says what bounds it and how it is laid out.
Both versions compute (dx*dx + dy*dy) + dz*dz without FMA contraction and
take the first index of the maximum, so on the card they agree bit for bit.

Precondition, as in the JAX package: given[b, :count[b]] lie in [0, N).
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.cuda._build import (
    check,
    library,
    max_dynamic_smem,
    stream_handle,
)
from samplenet_tpu_torch.ops.dispatch import count_launch, use_kernel

KERNEL = "fps"


def _check_args(points, given, count, npoint) -> None:
    if points.dim() != 3 or points.shape[-1] != 3 or points.shape[1] == 0:
        raise ValueError(f"fps takes points [B, N>=1, 3], got "
                         f"{tuple(points.shape)}")
    b = points.shape[0]
    if npoint < 1 or tuple(given.shape) != (b, npoint) \
            or tuple(count.shape) != (b,):
        raise ValueError(
            f"fps takes given [B, npoint] and count [B] with npoint >= 1; got "
            f"given {tuple(given.shape)}, count {tuple(count.shape)}, "
            f"npoint {npoint}, B {b}")
    if points.dtype != torch.float32:
        raise TypeError(f"fps takes float32 points, got {points.dtype}")
    if given.dtype != torch.int32 or count.dtype != torch.int32:
        raise TypeError(f"fps takes int32 given and count, got "
                        f"{given.dtype}, {count.dtype}")
    if not (points.device == given.device == count.device):
        raise ValueError("points, given and count must share a device")


def fps_plain(points: torch.Tensor, given: torch.Tensor, count: torch.Tensor,
              npoint: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx [B, npoint] int32, xyz [B, npoint, 3]): the loop of
    samplenet_tpu/ops/fps.py:130-141, one step per output point."""
    b, n, _ = points.shape
    px, py, pz = points.unbind(-1)                      # [B, N] each
    rows = torch.arange(b, device=points.device)
    dist = torch.full((b, n), float("inf"), dtype=torch.float32,
                      device=points.device)
    idx = torch.empty((b, npoint), dtype=torch.int32, device=points.device)
    xyz = torch.empty((b, npoint, 3), dtype=torch.float32,
                      device=points.device)
    for t in range(npoint):
        far = torch.argmax(dist, dim=1)
        sel = torch.where(t < count, given[:, t].long(), far)
        s = points[rows, sel]                           # [B, 3]
        idx[:, t] = sel.to(torch.int32)
        xyz[:, t] = s
        dx = px - s[:, 0:1]
        dy = py - s[:, 1:2]
        dz = pz - s[:, 2:3]
        d = dx * dx
        d = d + dy * dy
        d = d + dz * dz
        dist = torch.minimum(dist, d)
    return idx, xyz


def fps(points: torch.Tensor, given: torch.Tensor, count: torch.Tensor,
        npoint: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded FPS: (idx [B, npoint] int32, xyz [B, npoint, 3]) with
    xyz[b, t] == points[b, idx[b, t]] bit for bit. CPU tensors take
    `fps_plain`, CUDA tensors the kernel (ops/dispatch.py)."""
    _check_args(points, given, count, npoint)
    if not use_kernel(points):
        return fps_plain(points, given, count, npoint)
    return _fps_cuda(points, given, count, npoint)


def _fps_cuda(points, given, count, npoint):
    if points.device.type != "cuda":
        raise ValueError(f"the fps kernel takes CUDA tensors, got "
                         f"{points.device}")
    if not (points.is_contiguous() and given.is_contiguous()
            and count.is_contiguous()):
        raise ValueError("the fps kernel takes contiguous tensors")
    b, n, _ = points.shape
    smem = 16 * n
    if smem > max_dynamic_smem(points.device):
        raise ValueError(
            f"N={n} points need {smem} bytes of shared memory, more than a "
            f"block of {torch.cuda.get_device_name(points.device)} can hold")
    idx = torch.empty((b, npoint), dtype=torch.int32, device=points.device)
    xyz = torch.empty((b, npoint, 3), dtype=torch.float32,
                      device=points.device)
    lib = library()
    with torch.cuda.device(points.device):
        err = lib.snt_fps(points.data_ptr(), given.data_ptr(),
                          count.data_ptr(), idx.data_ptr(), xyz.data_ptr(),
                          b, n, npoint, stream_handle(points))
    check(err, KERNEL)
    count_launch(KERNEL)
    return idx, xyz
