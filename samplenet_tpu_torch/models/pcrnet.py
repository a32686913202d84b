"""PCRNet: siamese PointNet features -> FC head -> 7-dof twist.

Mirrors samplenet_tpu/models/pcrnet.py:19-53 (registration/models/
pcrnet.py:8-83): one per-point MLP 3-64-64-64-128-bottleneck (ReLU, no
batch norm) shared by template and source, a max over each cloud's
points, the two features concatenated through FC 1024-1024-512-512-256-7,
and the quaternion divided by max(||q||, 1e-12); the pre-normalised
quaternion is returned beside the twist, for the QuaterNet norm
regulariser. Keys are the reference's (feat.conv1..5, fc1..6), the ones
samplenet_tpu/interop/torch_import.py::pcrnet_to_torch writes.

Without BN the feature chain never takes a kernel: it runs as matmuls
(cuBLAS on the card), train or eval, as the JAX package runs it
(nn/layers.py::point_mlp). Initialisation follows flax, from an explicit
torch.Generator: lecun-normal kernels, zero biases. Under tensor
parallelism (parallel/mesh.py::shard_params) conv5 and the FC layers of
512 or more outputs run column-parallel (nn/layers.py), each output
gathered after its ReLU (conv5's after the max over points).
"""

from __future__ import annotations

import torch
from torch import nn

from samplenet_tpu_torch.nn.layers import (
    Linear,
    add_point_mlp,
    default_generator,
    point_mlp,
    whole_channels,
)

FEATURE_WIDTHS = (64, 64, 64, 128)
FC_WIDTHS = (1024, 1024, 512, 512, 256)


class PointNetFeatures(nn.Module):
    def __init__(self, bottleneck_size: int = 1024, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.widths = (*FEATURE_WIDTHS, bottleneck_size)
        add_point_mlp(self, 3, self.widths, use_bn=False, device=device,
                      generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, N, 3] -> [B, bottleneck]."""
        return point_mlp(self, len(self.widths), x, pool_max=True,
                         use_bn=False)


class PCRNet(nn.Module):
    def __init__(self, bottleneck_size: int = 1024, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.bottleneck_size = bottleneck_size
        self.feat = PointNetFeatures(bottleneck_size, device=device,
                                     generator=gen)
        widths = (2 * bottleneck_size, *FC_WIDTHS, 7)
        self._n_fc = len(widths) - 1
        for i in range(self._n_fc):
            self.add_module(f"fc{i + 1}", Linear(
                widths[i], widths[i + 1], device=device, generator=gen))

    def forward(self, x0: torch.Tensor, x1: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """x0 template, x1 source: both [B, N, 3]. Returns (twist [B, 7]
        with a unit quaternion, the pre-normalised quaternion [B, 4])."""
        y = torch.cat([self.feat(x0), self.feat(x1)], dim=-1)
        for i in range(1, self._n_fc):
            fc = getattr(self, f"fc{i}")
            y = whole_channels(fc, torch.relu(fc(y)))
        fc = getattr(self, f"fc{self._n_fc}")
        y = whole_channels(fc, fc(y))
        pre_quat = y[:, 0:4]
        quat = pre_quat / torch.clamp(
            torch.linalg.vector_norm(pre_quat, dim=-1, keepdim=True),
            min=1e-12)
        return torch.cat([quat, y[:, 4:]], dim=-1), pre_quat
