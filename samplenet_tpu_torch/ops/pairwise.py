"""Batched pairwise squared distances, nearest neighbour and k-NN, in true f32.

Mirrors samplenet_tpu/ops/pairwise.py: d2(x, y) = |x|^2 + |y|^2 - 2<x, y>,
clamped at 0, with the inner product a full-f32 matmul (no TF32, no
torch.cdist shortcut), chunked over the query axis so no more than
[B, chunk, M] distances live at once. Ties go to the lowest index: argmin
takes the first minimum, and the k-NN is a stable ascending sort.
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import full_f32_matmul


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[..., N, C] x [..., M, C] -> [..., N, M] squared L2 distances."""
    x = x.float()
    y = y.float()
    x2 = (x * x).sum(-1, keepdim=True)                  # [..., N, 1]
    y2 = (y * y).sum(-1, keepdim=True)                  # [..., M, 1]
    with full_f32_matmul():
        xy = torch.matmul(x, y.transpose(-1, -2))
    d2 = x2 - 2.0 * xy + y2.transpose(-1, -2)
    # matmul round-off can push tiny distances slightly negative
    return torch.clamp(d2, min=0.0)


def chunked_min_argmin(x: torch.Tensor, y: torch.Tensor, *, chunk: int = 512
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist [B, N], idx [B, N] int32): nearest y-point of every x-point."""
    dists, idxs = [], []
    for s in range(0, x.shape[1], chunk):
        d2 = pairwise_sqdist(x[:, s:s + chunk], y)
        dists.append(d2.amin(dim=-1))
        idxs.append(torch.argmin(d2, dim=-1).to(torch.int32))
    return torch.cat(dists, dim=1), torch.cat(idxs, dim=1)


def chunked_topk_neg(x: torch.Tensor, y: torch.Tensor, k: int, *,
                     chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist [B, N, k] ascending, idx [B, N, k] int32): the k nearest
    y-points of every x-point."""
    dists, idxs = [], []
    for s in range(0, x.shape[1], chunk):
        d2 = pairwise_sqdist(x[:, s:s + chunk], y)
        vals, idx = torch.sort(d2, dim=-1, stable=True)
        dists.append(vals[..., :k])
        idxs.append(idx[..., :k].to(torch.int32))
    return torch.cat(dists, dim=1), torch.cat(idxs, dim=1)
