"""Soft projection: the differentiable-sampling relaxation of SampleNet.

Mirrors samplenet_tpu/models/soft_projection.py:30-130: the temperature
parameter (reference key `project._temperature`), `sigma()` in its three
conventions, and `project`, which replaces each query point by the
softmax(-d^2 / sigma^2) mixture of its k nearest input points. `project`
always runs `ops/cuda/soft_projection_kernel.py::soft_project`: the
kernels on a CUDA tensor, their plain version on a CPU tensor (as JAX
picks the Pallas kernel on a TPU). `_group` and `_weights` are JAX's XLA
formulation (k-NN by |x|^2 + |y|^2 - 2xy, gather, softmax), kept for the
feature propagation of the reconstruction track. The hard projection
(one-hot of the largest weight, classification/soft_projection.py:73-76)
snaps each query to its nearest input point, which is in every
k-neighbourhood: it always runs `ops/cuda/chamfer_kernel.py::nn_snap`,
the 1-NN snap kernel on a CUDA tensor, its plain version on a CPU tensor.

  * torch (registration/src/soft_projection.py:92-99): sigma^2 = max(t^2, min_sigma)
  * tf (classification/soft_projection.py:41): sigma^2 = t^2
  * recon (reconstruction/src/soft_projection.py:51-54): sigma^2 = max(t, min_sigma)^2
"""

from __future__ import annotations

import torch
from torch import nn

from samplenet_tpu_torch.ops.cuda.chamfer_kernel import nn_snap
from samplenet_tpu_torch.ops.cuda.soft_projection_kernel import soft_project
from samplenet_tpu_torch.ops.knn import group_point, knn_point


def sigma_from_temperature(temperature: torch.Tensor, mode: str,
                           min_sigma: float) -> torch.Tensor:
    if mode == "torch":
        return torch.clamp(temperature ** 2, min=min_sigma)
    if mode == "tf":
        return temperature ** 2
    if mode == "recon":
        return torch.clamp(temperature, min=min_sigma) ** 2
    raise ValueError(f"unknown sigma_mode: {mode!r}")


class SoftProjection(nn.Module):
    """Holds the temperature; a frozen one still lives in `_temperature`,
    with requires_grad off, as in the reference torch module."""

    def __init__(self, group_size: int, initial_temperature: float = 1.0,
                 is_temperature_trainable: bool = True,
                 min_sigma: float = 1e-2, sigma_mode: str = "torch", *,
                 device=None):
        super().__init__()
        if sigma_mode not in ("torch", "tf", "recon"):
            raise ValueError(f"unknown sigma_mode: {sigma_mode!r}")
        self.group_size = group_size
        self.min_sigma = min_sigma
        self.sigma_mode = sigma_mode
        self._temperature = nn.Parameter(
            torch.tensor(initial_temperature, dtype=torch.float32,
                         device=device),
            requires_grad=is_temperature_trainable)

    def sigma(self) -> torch.Tensor:
        return sigma_from_temperature(self._temperature, self.sigma_mode,
                                      self.min_sigma)

    def _group(self, point_cloud: torch.Tensor, query_cloud: torch.Tensor,
               point_features: torch.Tensor | None = None):
        """(grouped points [B, M, k, 3], grouped features or None)."""
        _, idx = knn_point(self.group_size, point_cloud, query_cloud)
        grouped = group_point(point_cloud, idx)
        feats = None if point_features is None \
            else group_point(point_features, idx)
        return grouped, feats

    def _weights(self, grouped_points: torch.Tensor,
                 query_cloud: torch.Tensor):
        """(softmax weights [B, M, k], scaled distances [B, M, k])."""
        deltas = grouped_points - query_cloud[:, :, None, :]
        dist = (deltas * deltas).sum(-1) / self.sigma()
        return torch.softmax(-dist, dim=-1), dist

    def project(self, point_cloud: torch.Tensor, query_cloud: torch.Tensor,
                hard: bool = False):
        """(projected [B, M, 3], None, None) for point_cloud [B, N, 3] and
        query_cloud [B, M, 3]; the soft projection is differentiable in
        both clouds and in the temperature. The weights and distances live
        only inside the kernel, as on the JAX package's Pallas path
        (soft_projection.py:109-121). With `hard` each query snaps to its
        nearest input point (no gradient: an inference step)."""
        if hard:
            _, _, snapped = nn_snap(query_cloud.contiguous(),
                                    point_cloud.contiguous())
            return snapped, None, None
        projected, _ = soft_project(point_cloud, query_cloud, self.sigma(),
                                    self.group_size)
        return projected, None, None
