"""Matching ops: approximate EMD, and hard matching (1-NN indices,
de-duplicated, completed by seeded FPS).

The EMD half mirrors samplenet_tpu/ops/matching.py:31-191 and :331-347:
`approx_match` and `match_cost` re-implement the reference ApproxMatch /
MatchCost pair (classification/structural_losses/tf_approxmatch.cpp:
23-105) as plain
tensor code over [B, n, m], and `approx_emd_cost` / `emd_loss` take the
fused kernel (ops/cuda/emd_kernel.py: the kernel on a CUDA tensor, its
plain version on a CPU tensor), whose gradient is the analytic
MatchCostGrad. `approx_match` writes d2 in broadcast-difference form, as
the kernel does, not by the XLA path's |x|^2 + |y|^2 - 2xy identity:
the steep levels multiply d2's error by up to 65536. The pair is the
tests' reference against the JAX package; no training path takes it.
`emd_matching`, the evaluation's EMD hard matching, takes the argmax of
`approx_match` (no kernel in either package).

The NN half mirrors matching.py:194-328, itself the on-device form of the
reference's per-cloud numpy loop (registration/src/sputils.py
nn_matching). The TPU package compacts first-occurrence indices with a
one-hot matmul because TPU scatter is serialized (matching.py:229-256);
here that is an integer cumsum and `scatter_`.
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.cuda.chamfer_kernel import nn_direction
from samplenet_tpu_torch.ops.cuda.emd_kernel import (
    LEVELS,
    emd_cost_autograd,
    saturations,
    sqdist_broadcast,
)
from samplenet_tpu_torch.ops.fps import fps_from_given_with_points, gather_point


def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Approximate bipartite matching weights [B, n, m] of xyz1 [B, n, 3]
    and xyz2 [B, m, 3] (matching.py:31-117): row sums tend to
    max(n,m)//n, column sums to max(n,m)//m. No gradient. The batch runs
    in chunks (the largest divisor of B whose three level buffers stay
    under 1.2 GB), as in JAX."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    limit = max(1, int(1.2e9) // (3 * n * m * 4))
    batch_chunk = max(c for c in range(1, min(limit, b) + 1) if b % c == 0)
    with torch.no_grad():
        return torch.cat([
            _approx_match_impl(xyz1[s:s + batch_chunk],
                               xyz2[s:s + batch_chunk])
            for s in range(0, b, batch_chunk)])


def _approx_match_impl(xyz1, xyz2) -> torch.Tensor:
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    factorl, factorr = saturations(n, m)
    f32 = torch.float32 if xyz1.dtype != torch.float64 else torch.float64
    d2 = sqdist_broadcast(xyz1, xyz2)
    satl = torch.full((b, n), factorl, dtype=f32, device=xyz1.device)
    satr = torch.full((b, m), factorr, dtype=f32, device=xyz1.device)
    match = torch.zeros((b, n, m), dtype=f32, device=xyz1.device)
    for level in LEVELS:
        weight = torch.exp(level * d2) * satr[:, None, :]
        row_sum = 1e-9 + weight.sum(2, keepdim=True)
        weight = weight / row_sum * satl[:, :, None]
        col_sum = 1e-9 + weight.sum(1)
        ratio = torch.clamp(satr / col_sum, max=1.0)
        weight = weight * ratio[:, None, :]
        satl = torch.clamp(satl - weight.sum(2), min=0.0)
        satr = torch.clamp(satr - weight.sum(1), min=0.0)
        match = match + weight
    return match


def match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor,
               match: torch.Tensor) -> torch.Tensor:
    """[B] transport cost sum match * |x1 - x2| (matching.py:120-131);
    autograd gives the reference MatchCostGrad, match * (x1 - x2) / d
    with d clamped at 1e-20."""
    d2 = sqdist_broadcast(xyz1, xyz2)
    d = torch.sqrt(torch.clamp(d2, min=1e-40))
    return (match.detach() * d).sum((1, 2))


def approx_emd_cost(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """match_cost(x1, x2, approx_match(x1, x2)), the form every training
    path consumes (matching.py:156-186): [B], differentiable in both
    clouds with the match held fixed. It runs the fused EMD
    (ops/cuda/emd_kernel.py): the kernel on a CUDA tensor, its plain
    version on a CPU tensor."""
    return emd_cost_autograd(xyz1, xyz2)


def emd_loss(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Mean approximate-EMD loss (the AE objective, pointnet_ae.py:
    125-133)."""
    return approx_emd_cost(xyz1, xyz2).mean()


def emd_match_indices(full_pc: torch.Tensor,
                      simplified: torch.Tensor) -> torch.Tensor:
    """[B, m] int32: for each simplified point, the full-cloud point with
    the largest approximate-EMD transport weight, ties to the lowest
    index. The argmax runs over the full-cloud axis of approx_match, the
    JAX package's deliberate fix (matching.py:331-347): the reference
    (classification/models/samplenet_model.py:152-168) argmaxes over the
    simplified cloud's axis and indexes the full cloud with that, which
    picks among its first m points whatever the geometry."""
    match = approx_match(full_pc, simplified)                 # [B, N, m]
    return torch.argmax(match, dim=1).to(torch.int32)


def emd_matching(full_pc: torch.Tensor,
                 simplified: torch.Tensor) -> torch.Tensor:
    """EMD-based hard matching: [B, m, 3], each simplified point's
    strongest transport partner in full_pc (`emd_match_indices`)."""
    return gather_point(full_pc, emd_match_indices(full_pc, simplified))


def first_occurrence_mask(idx: torch.Tensor) -> torch.Tensor:
    """occ[b, i] = True iff idx[b, i] does not appear at any j < i."""
    m = idx.shape[1]
    eq = idx[:, :, None] == idx[:, None, :]                   # [B, m, m]
    earlier = torch.ones((m, m), dtype=torch.bool,
                         device=idx.device).tril(diagonal=-1)
    return ~(eq & earlier).any(dim=2)


def _compact_indices(idx: torch.Tensor, occ: torch.Tensor,
                     k: int) -> torch.Tensor:
    """First-occurrence indices moved to the front, order kept: [B, k]
    int32. Slots past the unique count read 0; callers mask by the count."""
    b, m = idx.shape
    trash = max(m, k)                 # dropped entries land past the end
    pos = torch.cumsum(occ.to(torch.int64), dim=1) - 1
    pos = torch.where(occ, pos, torch.full_like(pos, trash))
    out = torch.zeros((b, trash + 1), dtype=torch.int32, device=idx.device)
    out.scatter_(1, pos, idx.to(torch.int32))
    return out[:, :k]


def _match_indices_and_points(
    full_pc: torch.Tensor, idx: torch.Tensor, k: int, *, complete_fps: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unique NN indices completed to k by seeded FPS, and their points,
    which the FPS kernel emits bit for bit."""
    idx = idx.to(torch.int32)
    if not complete_fps:
        out_idx = idx[:, :k]
        return out_idx, gather_point(full_pc, out_idx)
    occ = first_occurrence_mask(idx)
    count = occ.sum(dim=1).to(torch.int32)
    compact = _compact_indices(idx, occ, k)
    return fps_from_given_with_points(k, full_pc, compact,
                                      torch.clamp(count, max=k))


def nn_match_indices(full_pc: torch.Tensor, idx: torch.Tensor, k: int, *,
                     complete_fps: bool = True) -> torch.Tensor:
    """Index-space hard matching: [B, k] int32 indices into full_pc."""
    return _match_indices_and_points(full_pc, idx, k,
                                     complete_fps=complete_fps)[0]


def nn_matching(full_pc: torch.Tensor, idx: torch.Tensor, k: int, *,
                complete_fps: bool = True) -> torch.Tensor:
    """Hard matching of NN indices idx [B, m] into full_pc [B, N, 3]:
    [B, k, 3] matched points (sputils.nn_matching parity)."""
    return _match_indices_and_points(full_pc, idx, k,
                                     complete_fps=complete_fps)[1]


def nn_match_from_clouds(
    full_pc: torch.Tensor, simplified: torch.Tensor, k: int, *,
    complete_fps: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each simplified point in full_pc, then matching
    (samplenet.py:119-141). Returns (matched [B, k, 3], indices [B, k])."""
    _, idx = nn_direction(simplified, full_pc)
    out_idx, pts = _match_indices_and_points(full_pc, idx, k,
                                             complete_fps=complete_fps)
    return pts, out_idx
