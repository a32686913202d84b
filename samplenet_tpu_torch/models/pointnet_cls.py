"""Vanilla PointNet classifier: the frozen task network of the
classification track.

Mirrors samplenet_tpu/models/pointnet_cls.py:54-122 with use_tnets=False
(classification/models/pointnet_cls_basic.py:55-145): per-point MLP
3->64->64->64->128->1024 with BN + ReLU, global max over points, FC
512 -> 256 with BN + ReLU, and a linear head. Plain torch: the JAX
package runs this chain with pool_max=False, so it never reaches a Pallas
kernel (pointnet_cls.py:90-95); its 1024-wide last layer is also beyond
the eval kernel's shared memory.

State_dict keys (`pointnet_state_dict_from_jax` writes them): conv1..5 and
bn1..5 for the per-point MLP, fc1, bn_fc1, fc2, bn_fc2 and fc3 for the
head. Eval only: the dropout of the classifier's own training and the
T-net variant come with the classifier trainer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from samplenet_tpu_torch.nn.layers import (
    add_mlp_head,
    add_point_mlp,
    default_generator,
    mlp_head,
    point_mlp,
)

CONV_WIDTHS = (64, 64, 64, 128, 1024)
FC_WIDTHS = (512, 256)


class PointNetClassifier(nn.Module):
    """[B, N, 3] clouds -> ([B, num_classes] logits, end_points)."""

    def __init__(self, num_classes: int = 40, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.num_classes = num_classes
        add_point_mlp(self, 3, CONV_WIDTHS, device=device, generator=gen)
        add_mlp_head(self, CONV_WIDTHS[-1], (*FC_WIDTHS, num_classes),
                     device=device, generator=gen)

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> tuple[torch.Tensor, dict]:
        if training:
            raise NotImplementedError(
                "the classifier's train mode (dropout) comes with its "
                "trainer (ROADMAP Queue 1 item 8)")
        h = point_mlp(self, len(CONV_WIDTHS), x)         # [B, N, 1024]
        g = h.amax(dim=1)
        end_points = {"critical_set_idx": torch.argmax(h, dim=1), "GFV": g}
        logits = mlp_head(self, len(FC_WIDTHS) + 1, g)
        return logits, end_points


def classification_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Mean sparse softmax cross-entropy (pointnet_cls_basic.py:139-145)."""
    return F.cross_entropy(logits, labels.long())


def pointnet_loss(logits: torch.Tensor, labels: torch.Tensor,
                  end_points: dict) -> torch.Tensor:
    """pointnet_cls.py:133-144 for the vanilla classifier, whose end points
    carry no feature transform: the classification loss. The T-net's
    orthogonality term comes with the T-net variant."""
    del end_points
    return classification_loss(logits, labels)
