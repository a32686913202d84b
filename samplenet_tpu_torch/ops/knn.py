"""Batched k-nearest neighbours, point grouping and radius grouping.

Mirrors samplenet_tpu/ops/knn.py:21-121: `knn_point` is the chunked k-NN
of ops/pairwise.py (ascending, ties to the lowest index), `group_point`
the neighbour gather, `query_ball_point` the radius grouping
(tf_grouping.cpp:13-30) and `select_top_k` the SelectionSort contract's k
prefix (tf_grouping.cpp:32-38). Plain tensor code: no Pallas kernel
computes any of them.
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.pairwise import chunked_topk_neg, pairwise_sqdist


def knn_point(k: int, point_cloud: torch.Tensor, query_cloud: torch.Tensor,
              *, chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist, idx), each [B, M, k]: the k nearest points of point_cloud
    [B, N, 3] to each query of query_cloud [B, M, 3], ascending."""
    return chunked_topk_neg(query_cloud, point_cloud, k, chunk=chunk)


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C] gathered at idx [B, M, K] -> [B, M, K, C]."""
    b, m, kk = idx.shape
    flat = idx.reshape(b, m * kk, 1).long().expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, flat).reshape(b, m, kk, points.shape[-1])


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, *, chunk: int = 512
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx [B, M, nsample] int32, pts_cnt [B, M] int32): for each query of
    new_xyz [B, M, 3], the first `nsample` points of xyz [B, N, 3] within
    `radius` by index order; a query with fewer repeats its first in-ball
    point, one with none takes index 0 with count 0. The count is capped
    at nsample. The query axis runs in chunks of `chunk`, so at most
    [B, chunk, N] distances live at once."""
    n = xyz.shape[1]
    idxs, cnts = [], []
    for s in range(0, new_xyz.shape[1], chunk):
        d2 = pairwise_sqdist(new_xyz[:, s:s + chunk], xyz)   # [B, mc, N]
        in_ball = d2 < radius * radius
        order = torch.arange(n, device=xyz.device)
        key = torch.where(in_ball, order, order + n)   # in-ball points first
        idx_sorted = torch.sort(key, dim=-1).indices[..., :nsample]
        pts_cnt = in_ball.sum(-1)
        first = torch.where(pts_cnt[..., None] > 0, idx_sorted[..., :1], 0)
        pos = torch.arange(nsample, device=xyz.device)
        idxs.append(torch.where(pos < pts_cnt[..., None], idx_sorted, first)
                    .to(torch.int32))
        cnts.append(torch.clamp(pts_cnt, max=nsample).to(torch.int32))
    return torch.cat(idxs, dim=1), torch.cat(cnts, dim=1)


def select_top_k(k: int, dist: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values [B, M, k] ascending, idx [B, M, k] int32): the k smallest
    entries of each row of dist [B, M, N], ties to the lowest index."""
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)
