"""Chamfer / nn_distance: bidirectional nearest-neighbour squared distances.

Mirrors samplenet_tpu/ops/chamfer.py. Both directions take their NN index
from `nn_direction` (the CUDA kernel on a CUDA tensor, its plain version on
a CPU tensor). The distance is then recomputed through a gather of the
neighbour (chamfer.py:43-52), so a non-finite cloud gives a non-finite
distance. The VJP is the reference's +-2g(x - y) pull/push
(chamfer.py:79-88); its scatter side is a one-hot bmm (chamfer.py:55-65),
not index_add_/scatter_add_, which are atomic on CUDA and run in no fixed
order. Indices carry no gradient.
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.cuda.chamfer_kernel import nn_direction
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import full_f32_matmul


def take_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather: points [B, M, C] at idx [B, K] -> [B, K, C]."""
    flat = idx.long()[:, :, None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, flat)


def scatter_rows(idx: torch.Tensor, vals: torch.Tensor,
                 out_rows: int) -> torch.Tensor:
    """sum_i onehot(idx[b, i]) * vals[b, i, :] -> [B, out_rows, C], as a
    one-hot bmm: every sum in a fixed order."""
    slots = torch.arange(out_rows, device=idx.device, dtype=idx.dtype)
    onehot = (idx[:, :, None] == slots).to(vals.dtype)    # [B, n, out_rows]
    with full_f32_matmul():
        return torch.bmm(onehot.transpose(1, 2), vals)


def _sqnorm(v: torch.Tensor) -> torch.Tensor:
    return (v * v).sum(-1)


class _NNDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        xyz1, xyz2 = xyz1.contiguous(), xyz2.contiguous()
        _, idx1 = nn_direction(xyz1, xyz2)
        _, idx2 = nn_direction(xyz2, xyz1)
        dist1 = _sqnorm(xyz1 - take_rows(xyz2, idx1))
        dist2 = _sqnorm(xyz2 - take_rows(xyz1, idx2))
        ctx.save_for_backward(xyz1, xyz2, idx1, idx2)
        ctx.mark_non_differentiable(idx1, idx2)
        return dist1, idx1, dist2, idx2

    @staticmethod
    def backward(ctx, g1, _gi1, g2, _gi2):
        xyz1, xyz2, idx1, idx2 = ctx.saved_tensors
        v1 = 2.0 * g1[..., None] * (xyz1 - take_rows(xyz2, idx1))  # [B, N, 3]
        v2 = 2.0 * g2[..., None] * (xyz2 - take_rows(xyz1, idx2))  # [B, M, 3]
        dx1 = dx2 = None
        if ctx.needs_input_grad[0]:
            dx1 = v1 - scatter_rows(idx2, v2, xyz1.shape[1])
        if ctx.needs_input_grad[1]:
            dx2 = v2 - scatter_rows(idx1, v1, xyz2.shape[1])
        return dx1, dx2


def nn_distance(xyz1: torch.Tensor, xyz2: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """(dist1 [B, N], idx1 [B, N], dist2 [B, M], idx2 [B, M]) for xyz1
    [B, N, 3] and xyz2 [B, M, 3]: each point's squared distance to, and
    int32 index of, its nearest point in the other cloud."""
    return _NNDistance.apply(xyz1, xyz2)


def chamfer_distance(xyz1: torch.Tensor, xyz2: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point squared NN costs both ways: (cost_1to2 [B, N],
    cost_2to1 [B, M])."""
    d1, _, d2, _ = nn_distance(xyz1, xyz2)
    return d1, d2


def chamfer_loss(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Symmetric mean Chamfer loss: mean over points of each direction,
    summed, then mean over the batch (chamfer.py:127-134)."""
    d1, d2 = chamfer_distance(xyz1, xyz2)
    return (d1.mean(dim=1) + d2.mean(dim=1)).mean()
