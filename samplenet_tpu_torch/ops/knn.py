"""Batched k-nearest neighbours and point grouping.

Mirrors samplenet_tpu/ops/knn.py:21-55: `knn_point` is the chunked k-NN
of ops/pairwise.py (ascending, ties to the lowest index), `group_point`
the neighbour gather.
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.pairwise import chunked_topk_neg


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
