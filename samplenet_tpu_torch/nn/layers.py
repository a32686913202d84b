"""Shared neural building blocks, eval and train forward.

Mirrors samplenet_tpu/nn/layers.py:54-312 (`PointMLP`, `MLPHead`). A 1x1
conv over points is a per-point matmul: each conv keeps the reference's
Conv1d weight shape [out, in, 1] (registration/src/samplenet.py:40-44) but
computes as a matmul on the squeezed weight over [B, N, C] rows; there is
no nn.Conv1d on the compute path, since cuDNN would run f32 convs in TF32.

Layers carry the reference torch names (conv{i}, bn{i}, fc{i}, bn_fc{i}),
so a module built from them has the reference state_dict keys. The layers
are added to an owning module by `add_point_mlp` / `add_mlp_head` and run
by `point_mlp` / `mlp_head`; `PointMLP` and `MLPHead` own them alone, and
models/samplenet.py adds them flat to SampleNet, as the reference does.

Initialisation follows flax, from an explicit torch.Generator: lecun-normal
kernels, zero biases, BN scale 1 / bias 0 / mean 0 / var 1.

Train mode is flax's BatchNorm, not torch's BatchNorm1d: batch statistics
over every axis but the last, the fast variance mean(x^2) - mean(x)^2
clamped at 0 (biased), and running averages m * old + (1 - m) * batch
with flax's momentum m (0.9). With `pool_max` the conv chain runs as
`point_mlp_exact_train_max` (exact global statistics; the kernel on a
CUDA tensor), which reports the statistics that update the running
averages, as samplenet_tpu/nn/layers.py:48-51 (`BNTrainStats.update`).
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

from samplenet_tpu_torch.ops.cuda.point_mlp_exact_kernel import (
    point_mlp_exact_train_max,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import (
    fold_bn_affine,
    point_mlp_max,
)

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal: N(0, 1/fan_in) truncated to two standard
    deviations, rescaled to keep the variance (variance_scaling)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def default_generator(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None \
        else torch.Generator().manual_seed(0)


class PointConv(nn.Module):
    """Per-point linear layer with a Conv1d-shaped weight [out, in, 1]."""

    def __init__(self, in_features: int, out_features: int, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        w = torch.empty(out_features, in_features, 1)
        lecun_normal_(w, in_features, default_generator(generator))
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def kernel(self) -> torch.Tensor:
        """The weight as a Dense kernel [in, out]."""
        return self.weight[:, :, 0].t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [..., in]
        return torch.matmul(x, self.kernel()) + self.bias


class Linear(nn.Linear):
    """nn.Linear with flax's initialisation."""

    def __init__(self, in_features: int, out_features: int, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__(in_features, out_features, device="meta")
        w = torch.empty(out_features, in_features)
        lecun_normal_(w, in_features, default_generator(generator))
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, flax's arithmetic:
    (x - mean) * (rsqrt(var + eps) * scale) + bias, with the running
    statistics at eval and the batch statistics in training. Its
    parameters and buffers carry BatchNorm1d's names, num_batches_tracked
    included. `momentum` is flax's (the weight of the old average)."""

    def __init__(self, features: int, *, momentum: float = BN_MOMENTUM,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long, device=device))

    def update_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Running averages from one batch's mean and biased variance."""
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked += 1

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        if not training:
            mean, var = self.running_mean, self.running_var
        else:
            flat = x.reshape(-1, x.shape[-1])
            mean = flat.mean(0)
            var = torch.clamp((flat * flat).mean(0) - mean * mean, min=0.0)
            self.update_stats(mean.detach(), var.detach())
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean) * mul + self.bias


def add_point_mlp(owner: nn.Module, in_features: int,
                  features: Sequence[int], *,
                  bn_momentum: float = BN_MOMENTUM, device=None,
                  generator: torch.Generator | None = None) -> None:
    """Adds conv1..L and bn1..L to `owner`."""
    gen = default_generator(generator)
    widths = (in_features, *features)
    for i in range(len(features)):
        owner.add_module(f"conv{i + 1}", PointConv(
            widths[i], widths[i + 1], device=device, generator=gen))
        owner.add_module(f"bn{i + 1}", BatchNorm(
            widths[i + 1], momentum=bn_momentum, device=device))


def point_mlp(owner: nn.Module, n_layers: int, x: torch.Tensor, *,
              training: bool = False, pool_max: bool = False) -> torch.Tensor:
    """conv -> BN -> ReLU per layer over x [B, N, C]. With `pool_max` the
    result is the max over points, [B, C_out], and the chain runs as one
    kernel on a CUDA tensor: at eval each BN folds into its layer's affine
    and the chain is `point_mlp_max` (samplenet_tpu/nn/layers.py:196-223);
    in training it is `point_mlp_exact_train_max` (:151-186)."""
    layers = [(getattr(owner, f"conv{i + 1}"), getattr(owner, f"bn{i + 1}"))
              for i in range(n_layers)]
    if pool_max and training:
        pooled, means, vars_ = point_mlp_exact_train_max(
            x, [conv.kernel() for conv, _ in layers],
            [conv.bias for conv, _ in layers],
            [bn.weight for _, bn in layers], [bn.bias for _, bn in layers],
            eps=BN_EPS)
        for (_, bn), mean, var in zip(layers, means, vars_):
            bn.update_stats(mean, var)
        return pooled
    if pool_max:
        wbs = []
        for conv, bn in layers:
            wbs += fold_bn_affine(conv.kernel(), conv.bias, bn.weight,
                                  bn.bias, bn.running_mean, bn.running_var,
                                  BN_EPS)
        return point_mlp_max(x, tuple(wbs))
    for conv, bn in layers:
        x = torch.relu(bn(conv(x), training))
    return x


def add_mlp_head(owner: nn.Module, in_features: int,
                 features: Sequence[int], *, use_bn: bool = True,
                 activate_final: bool = False,
                 bn_momentum: float = BN_MOMENTUM, device=None,
                 generator: torch.Generator | None = None) -> None:
    """Adds fc1..L to `owner`, and with `use_bn` a bn_fc{i} for each layer
    that is activated (all but the last unless `activate_final`)."""
    gen = default_generator(generator)
    widths = (in_features, *features)
    n = len(features)
    for i in range(n):
        owner.add_module(f"fc{i + 1}", Linear(
            widths[i], widths[i + 1], device=device, generator=gen))
        if use_bn and (i < n - 1 or activate_final):
            owner.add_module(f"bn_fc{i + 1}", BatchNorm(
                widths[i + 1], momentum=bn_momentum, device=device))


def mlp_head(owner: nn.Module, n_layers: int, x: torch.Tensor, *,
             activate_final: bool = False,
             training: bool = False) -> torch.Tensor:
    """fc -> (BN) -> ReLU over x [B, C], leaving the last layer linear
    unless `activate_final`. Plain torch in both modes."""
    for i in range(n_layers):
        x = getattr(owner, f"fc{i + 1}")(x)
        if i < n_layers - 1 or activate_final:
            bn = getattr(owner, f"bn_fc{i + 1}", None)
            if bn is not None:
                x = bn(x, training)
            x = torch.relu(x)
    return x


class PointMLP(nn.Module):
    """Per-point MLP over [B, N, C]: conv -> BN -> ReLU on every layer."""

    def __init__(self, in_features: int, features: Sequence[int], *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.features = tuple(features)
        add_point_mlp(self, in_features, self.features, device=device,
                      generator=generator)

    def forward(self, x: torch.Tensor, training: bool = False,
                pool_max: bool = False) -> torch.Tensor:
        return point_mlp(self, len(self.features), x, training=training,
                         pool_max=pool_max)


class MLPHead(nn.Module):
    """Fully-connected head over [B, C]: BN + ReLU on every layer except,
    unless `activate_final`, the last."""

    def __init__(self, in_features: int, features: Sequence[int], *,
                 use_bn: bool = True, activate_final: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.features = tuple(features)
        self.activate_final = activate_final
        add_mlp_head(self, in_features, self.features, use_bn=use_bn,
                     activate_final=activate_final, device=device,
                     generator=generator)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        return mlp_head(self, len(self.features), x,
                        activate_final=self.activate_final, training=training)
