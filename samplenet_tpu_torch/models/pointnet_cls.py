"""PointNet classifiers of the classification track: the vanilla network
and the T-net variant, in eval and train mode.

Mirrors samplenet_tpu/models/pointnet_cls.py:25-144. The vanilla network
(classification/models/pointnet_cls_basic.py:55-145) is the per-point MLP
3->64->64->64->128->1024 with BN + ReLU, a global max over points, FC
512 -> 256 with BN + ReLU, and a linear head. The T-net variant
(pointnet_cls.py:21-132, transform_nets.py) regresses a 3x3 input
transform, applies it, runs 64-64, regresses a 64x64 feature transform
(returned as end_points["transform"] for the orthogonality loss), applies
it and runs 64-128-1024 before the same head.

Train mode is flax's: BatchNorm with batch statistics and running
averages at momentum `bn_momentum` (nn/layers.py::BatchNorm), and
Dropout(dropout_rate) after bn_fc2, and with T-nets also after bn_fc1
(:103-111). The dropout mask comes from an explicit torch.Generator:
each entry is kept where a uniform draw falls below 1 - rate, and kept
entries are scaled by 1 / (1 - rate), as flax does. Under a data-parallel
`mesh` (parallel/mesh.py::data_parallel) the mask is drawn for the global
batch and each rank keeps its rows, and the orthogonality loss, a sum
over the batch, is summed over the data ranks. Under tensor parallelism
(parallel/mesh.py::shard_params) the wide layers run column-parallel
(nn/layers.py): the last conv's per-point features stay the rank's
channel block, whose max and argmax over points are taken on the block
and then gathered, and each sharded FC layer's output is gathered after
its BN and ReLU, before dropout. The T-nets' BNs run
at momentum 0.9 whatever `bn_momentum` is, because the JAX package builds
its TransformNets without passing it (:76-77, :82-83); under the
scheduled BN decay their statistics therefore take two averages a step.
The port copies that.

Plain torch, on cuBLAS f32: the JAX package runs these chains without
pool_max, so they never reach a Pallas kernel (samplenet_tpu/nn/
layers.py:100-109, 189-196). `dtype` is its compute dtype (bf16 with
`--bf16`, samplenet_tpu/models/pointnet_cls.py:31-43, 67-108): every
conv chain, the T-nets' FC layers and the head's fc1, fc2 and their BNs
run in it with flax's casts (nn/layers.py); the T-nets' transform layers
and fc3 promote their input to f32, and so do the transforms' products
with the bf16 features (jnp.einsum promotes), so the transforms and the
logits are f32.

State_dict keys (`pointnet_state_dict_from_jax` writes them): the vanilla
network's conv1..5 and bn1..5; the T-net variant's tnet_input and
tnet_feature (each convs.conv1..3, convs.bn1..3, fc_0, bn_0, fc_1, bn_1
and transform, after the flax module names), convs_a.conv1..2 /
convs_a.bn1..2 and convs_b.conv1..3 / convs_b.bn1..3; both have fc1,
bn_fc1, fc2, bn_fc2 and fc3 for the head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from samplenet_tpu_torch.nn.layers import (
    BN_MOMENTUM,
    BatchNorm,
    Linear,
    PointMLP,
    add_mlp_head,
    add_point_mlp,
    default_generator,
    dense,
    point_mlp,
    whole_channels,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import full_f32_matmul
from samplenet_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, global_rows

CONV_WIDTHS = (64, 64, 64, 128, 1024)
FC_WIDTHS = (512, 256)
TNET_CONV_WIDTHS = (64, 128, 1024)
TNET_FC_WIDTHS = (512, 256)
CONVS_A_WIDTHS = (64, 64)
CONVS_B_WIDTHS = (64, 128, 1024)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None,
            mesh: Mesh | None = None) -> torch.Tensor:
    """flax.linen.Dropout(rate) in train mode: each entry kept where a
    uniform draw from `generator` is below 1 - rate and scaled by
    1 / (1 - rate), the others 0; rate 0 returns x, rate 1 zeros. Under
    `mesh`, x is this rank's rows and the draws cover the global batch."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in train mode draws its mask from an "
                         "explicit torch.Generator, as the classifier "
                         "trainer passes one: give generator=")
    keep_prob = 1.0 - rate
    total, rows = global_rows(mesh, x.shape[0])
    keep = torch.rand((total, *x.shape[1:]), generator=generator,
                      device=x.device)[rows] < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _apply_transform(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """einsum("bnc,bcd->bnd", x, t) in plain f32 (x promoted to t's type,
    as jnp.einsum promotes bf16 features)."""
    with full_f32_matmul():
        return torch.bmm(x.to(t.dtype), t)


class TransformNet(nn.Module):
    """T-net: [B, N, C] -> a [B, k, k] transform, the identity at
    initialisation (transform_nets.py:12-80: zero kernel, identity bias).
    Its BNs run at flax's default momentum 0.9."""

    def __init__(self, k: int, in_features: int, *,
                 dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.k = k
        self.dtype = dtype
        self.convs = PointMLP(in_features, TNET_CONV_WIDTHS, dtype=dtype,
                              device=device, generator=gen)
        widths = (TNET_CONV_WIDTHS[-1], *TNET_FC_WIDTHS)
        for i in range(len(TNET_FC_WIDTHS)):
            self.add_module(f"fc_{i}", Linear(widths[i], widths[i + 1],
                                              device=device, generator=gen))
            self.add_module(f"bn_{i}", BatchNorm(widths[i + 1],
                                                 device=device))
        self.transform = Linear(
            widths[-1], k * k, device=device,
            weight=torch.zeros(k * k, widths[-1]),
            bias=torch.eye(k).reshape(-1))

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        last = getattr(self.convs, f"conv{len(TNET_CONV_WIDTHS)}")
        g = whole_channels(last, self.convs(x, training).amax(dim=1))
        for i in range(len(TNET_FC_WIDTHS)):
            fc = getattr(self, f"fc_{i}")
            g = dense(fc, g, self.dtype)
            g = torch.relu(getattr(self, f"bn_{i}")(g, training, self.dtype))
            g = whole_channels(fc, g)
        t = self.transform(g.to(self.transform.weight.dtype))
        return whole_channels(self.transform, t).reshape(-1, self.k, self.k)


class PointNetClassifier(nn.Module):
    """[B, N, 3] clouds -> ([B, num_classes] logits, end_points).

    use_tnets=False is the frozen task network of the SampleNet pipeline;
    True adds the input and feature transforms. `forward(x,
    training=True, generator=g)` runs train-mode BN and dropout; g is
    needed while dropout_rate > 0."""

    def __init__(self, num_classes: int = 40, *, use_tnets: bool = False,
                 dropout_rate: float = 0.3, bn_momentum: float = BN_MOMENTUM,
                 dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.num_classes = num_classes
        self.use_tnets = use_tnets
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.mesh = None
        if use_tnets:
            self.tnet_input = TransformNet(3, 3, dtype=dtype, device=device,
                                           generator=gen)
            self.convs_a = PointMLP(3, CONVS_A_WIDTHS,
                                    bn_momentum=bn_momentum, dtype=dtype,
                                    device=device, generator=gen)
            self.tnet_feature = TransformNet(CONVS_A_WIDTHS[-1],
                                             CONVS_A_WIDTHS[-1], dtype=dtype,
                                             device=device, generator=gen)
            self.convs_b = PointMLP(CONVS_A_WIDTHS[-1], CONVS_B_WIDTHS,
                                    bn_momentum=bn_momentum, dtype=dtype,
                                    device=device, generator=gen)
        else:
            add_point_mlp(self, 3, CONV_WIDTHS, bn_momentum=bn_momentum,
                          device=device, generator=gen)
        add_mlp_head(self, CONV_WIDTHS[-1], (*FC_WIDTHS, num_classes),
                     bn_momentum=bn_momentum, device=device, generator=gen)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, dict]:
        end_points: dict = {}
        if self.use_tnets:
            x = _apply_transform(x, self.tnet_input(x, training))
            x = self.convs_a(x, training)
            t_feat = self.tnet_feature(x, training)
            end_points["transform"] = t_feat
            x = self.convs_b(_apply_transform(x, t_feat), training)
            last = getattr(self.convs_b, f"conv{len(CONVS_B_WIDTHS)}")
        else:
            x = point_mlp(self, len(CONV_WIDTHS), x, training=training,
                          dtype=self.dtype)
            last = getattr(self, f"conv{len(CONV_WIDTHS)}")
        end_points["critical_set_idx"] = whole_channels(
            last, torch.argmax(x, dim=1))
        g = whole_channels(last, x.amax(dim=1))            # [B, 1024]
        end_points["GFV"] = g
        rate = self.dropout_rate if training else 0.0
        dt = self.dtype
        g = torch.relu(self.bn_fc1(dense(self.fc1, g, dt), training, dt))
        g = whole_channels(self.fc1, g)
        if self.use_tnets:
            g = dropout(g, rate, generator, self.mesh)
        g = torch.relu(self.bn_fc2(dense(self.fc2, g, dt), training, dt))
        g = whole_channels(self.fc2, g)
        end_points["retrieval_vectors"] = g
        g = dropout(g, rate, generator, self.mesh)
        logits = whole_channels(
            self.fc3, self.fc3(g.to(self.fc3.weight.dtype)))  # f32 logits
        return logits, end_points


def classification_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Mean sparse softmax cross-entropy (pointnet_cls_basic.py:139-145)."""
    return F.cross_entropy(logits, labels.long())


def matrix_regularization_loss(transform: torch.Tensor,
                               mesh: Mesh | None = None) -> torch.Tensor:
    """||T T^t - I||_F^2 / 2, summed over the batch too (tf.nn.l2_loss,
    pointnet_cls.py:117-132): under `mesh`, over the global batch."""
    k = transform.shape[-1]
    with full_f32_matmul():
        tt = torch.bmm(transform, transform.transpose(1, 2))
    diff = tt - torch.eye(k, dtype=transform.dtype, device=transform.device)
    loss = 0.5 * (diff * diff).sum()
    return loss if mesh is None else all_reduce_sum(loss, mesh)


def pointnet_loss(logits: torch.Tensor, labels: torch.Tensor,
                  end_points: dict, reg_weight: float = 0.001,
                  mesh: Mesh | None = None) -> torch.Tensor:
    """The classification loss, plus reg_weight times the orthogonality
    loss of end_points["transform"] where the T-net variant gives one
    (pointnet_cls.py:133-144). Under `mesh` the first is this rank's mean
    (the ranks' means average to the global one) and the second the
    global batch's sum."""
    loss = classification_loss(logits, labels)
    if "transform" in end_points:
        loss = loss + reg_weight * matrix_regularization_loss(
            end_points["transform"], mesh)
    return loss
