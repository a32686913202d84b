"""Farthest point sampling, point gathers, weighted index sampling and the
complement of a sampled set.

Mirrors samplenet_tpu/ops/fps.py:22-241. Every FPS entry point is the one
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


def inverse_cdf_indices(weights: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """[B, npoint] int32: for uniform draws u [B, npoint] in [0, 1), the
    index of each draw scaled by the row's total weight in the cumulative
    weights of weights [B, N] (the count of cdf entries below it), clipped
    to [0, N)."""
    cdf = torch.cumsum(weights, dim=-1)
    scaled = u * cdf[:, -1:]
    idx = (cdf[:, None, :] < scaled[:, :, None]).sum(-1)
    return torch.clamp(idx, 0, weights.shape[-1] - 1).to(torch.int32)


def prob_sample(weights: torch.Tensor, npoint: int, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Weighted multinomial index sampling with replacement (`ProbSample`,
    tf_sampling_g.cu:7-104: cumulative sum, then a search): [B, npoint]
    int32 indices into the N axis of non-negative weights [B, N], the
    draws from `generator`."""
    u = torch.rand((weights.shape[0], npoint), generator=generator,
                   device=weights.device, dtype=weights.dtype)
    return inverse_cdf_indices(weights, u)


def non_sampled(ndataset: int, idx: torch.Tensor) -> torch.Tensor:
    """[B, ndataset - npoint] int32, ascending: the indices of range(ndataset)
    not in each row of idx [B, npoint] (unique indices;
    reconstruction/external/sampling/tf_sampling.py:79-108). As in the JAX
    package, the non-sampled rank first by index, then the sampled, and the
    first ndataset - npoint are kept."""
    b, npoint = idx.shape
    sampled = torch.zeros((b, ndataset), dtype=torch.bool, device=idx.device)
    sampled.scatter_(1, idx.long(), True)
    order = torch.arange(ndataset, device=idx.device)
    key = torch.where(sampled, order + ndataset, order)
    comp = torch.argsort(key, dim=1)[:, :ndataset - npoint]
    return torch.sort(comp, dim=1).values.to(torch.int32)
