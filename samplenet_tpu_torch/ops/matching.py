"""Hard matching: 1-NN indices, de-duplicated, completed by seeded FPS.

Mirrors the NN half of samplenet_tpu/ops/matching.py:194-328, itself the
on-device form of the reference's per-cloud numpy loop
(registration/src/sputils.py nn_matching). The TPU package compacts
first-occurrence indices with a one-hot matmul because TPU scatter is
serialized (matching.py:229-256); here that is an integer cumsum and
`scatter_`. The EMD half waits for a later slice.
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.cuda.chamfer_kernel import nn_direction
from samplenet_tpu_torch.ops.fps import fps_from_given_with_points, gather_point


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
