"""Sampling losses (paper Eq. 1: L = L_task + alpha*L_simplify + lmbda*L_project).

Mirrors samplenet_tpu/models/losses.py:18-61. Classification-track weights:
alpha=30, lmbda=1, gamma=1, delta=0, k=7. The reconstruction track's
size-scaled variant comes with that track.
"""

from __future__ import annotations

import torch

from samplenet_tpu_torch.ops.chamfer import nn_distance


def simplification_loss(ref_pc: torch.Tensor, samp_pc: torch.Tensor,
                        pc_size: int, gamma: float = 1.0,
                        delta: float = 0.0) -> torch.Tensor:
    """mean CD(samp->ref) + mean over the batch of the per-cloud max
    CD(samp->ref) + (gamma + delta*pc_size) * mean CD(ref->samp); both
    clouds [B, *, 3]."""
    cost_p1_p2, _, cost_p2_p1, _ = nn_distance(samp_pc, ref_pc)
    max_cost = cost_p1_p2.amax(dim=1).mean()
    return (cost_p1_p2.mean() + max_cost
            + (gamma + delta * pc_size) * cost_p2_p1.mean())


def projection_loss(sigma: torch.Tensor) -> torch.Tensor:
    """The projection loss is sigma^2 itself: it drives the temperature
    toward zero, so the soft projection anneals to a hard selection."""
    return sigma
