"""Farthest point sampling and point gathers.

Mirrors samplenet_tpu/ops/fps.py:22-205. Every FPS entry point is the one
seeded kernel (ops/cuda/fps_kernel.py), dispatched by device
(ops/dispatch.py): the plain FPS is the seeded one with count = 1 and
given[:, 0] = start, as in the Pallas kernel (fps_kernel.py:37-38).
Semantics follow the reference GPU op FarthestPointSample (greedy max-min,
first index 0 by default) and sputils._fps_from_given_pc. Points are
[B, N, 3] float32.
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.cuda.fps_kernel import fps


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C] points gathered by [B, M] int indices -> [B, M, C]."""
    index = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, index)


def _plain_prefix(points: torch.Tensor, npoint: int,
                  start_idx: torch.Tensor | int):
    b = points.shape[0]
    given = torch.zeros((b, npoint), dtype=torch.int32, device=points.device)
    given[:, 0] = torch.as_tensor(start_idx, dtype=torch.int32,
                                  device=points.device)
    count = torch.ones((b,), dtype=torch.int32, device=points.device)
    return given, count


def farthest_point_sample_with_points(
    npoint: int, points: torch.Tensor, *,
    start_idx: torch.Tensor | int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy FPS from `start_idx` (scalar or [B]): (idx [B, npoint] int32,
    xyz [B, npoint, 3])."""
    given, count = _plain_prefix(points, npoint, start_idx)
    return fps(points, given, count, npoint)


def farthest_point_sample(
    npoint: int, points: torch.Tensor, *, start_idx: torch.Tensor | int = 0,
) -> torch.Tensor:
    """Greedy FPS: [B, npoint] int32 selected indices."""
    return farthest_point_sample_with_points(npoint, points,
                                             start_idx=start_idx)[0]


def fps_from_given_with_points(
    npoint: int, points: torch.Tensor, given_idx: torch.Tensor,
    given_count: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """FPS completion from a prefix: the first `given_count[b]` outputs are
    `given_idx[b, :count]` verbatim (given_idx [B, npoint] compacted to the
    front, count >= 1), the rest greedily add the farthest point from the
    selected set. Returns (idx [B, npoint] int32, xyz [B, npoint, 3])."""
    return fps(points, given_idx.to(torch.int32).contiguous(),
               given_count.to(torch.int32).contiguous(), npoint)


def fps_from_given(
    npoint: int, points: torch.Tensor, given_idx: torch.Tensor,
    given_count: torch.Tensor,
) -> torch.Tensor:
    """`fps_from_given_with_points` without the points."""
    return fps_from_given_with_points(npoint, points, given_idx,
                                      given_count)[0]
