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
CUDA tensor; bf16 operands where the JAX package's TPU would run its
exact kernel with fused_bf16), or, with `fused_train=True` in ghost mode
where the shapes allow it, as `point_mlp_train_max` (ghost BN over
blocks of clouds, bf16 operands by default); either reports the exact
global statistics that update the running averages, as
samplenet_tpu/nn/layers.py:48-51 (`BNTrainStats.update`).
`resolve_fused_mode` is the JAX package's rule for picking between them
(:111-149), `use_eval_kernel` its rule for the eval kernel (:84-93).

A compute `dtype` (bf16; the JAX package's `dtype` field, :66-68, reached
by `--bf16`) runs the chain as tensor ops with flax's casts and no kernel,
train or eval, as the JAX package does (:88, :120; its XLA matmuls, so on
the card cuBLAS bf16 GEMMs): Dense casts its input, kernel and bias to
the dtype and returns it (`dense`); BatchNorm takes its statistics in f32,
normalises in f32 and returns the dtype, its running statistics f32.
Parameters stay f32.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

from samplenet_tpu_torch.ops.cuda.point_mlp_exact_kernel import (
    auto_block_b_exact,
    point_mlp_exact_train_max,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import (
    fold_bn_affine,
    point_mlp_max,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_train_kernel import (
    auto_block_b,
    point_mlp_train_max,
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


def dense(layer: nn.Module, x: torch.Tensor,
          dtype: torch.dtype | None) -> torch.Tensor:
    """A PointConv or Linear `layer` on x, as flax's Dense with `dtype`:
    without one, the layer itself; with one, x, the kernel and the bias
    cast to it, the product rounded to it, then the bias added in it."""
    if dtype is None:
        return layer(x)
    kernel = layer.kernel() if isinstance(layer, PointConv) \
        else layer.weight.t()
    return torch.matmul(x.to(dtype), kernel.to(dtype)) + layer.bias.to(dtype)


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

    def forward(self, x: torch.Tensor, training: bool = False,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """With a compute `dtype`, as flax's BatchNorm(dtype=...): the
        statistics of x taken in f32 (the running statistics' type), the
        normalisation in f32 (x promoted), the result cast to `dtype`."""
        if not training:
            mean, var = self.running_mean, self.running_var
        else:
            flat = x.reshape(-1, x.shape[-1]).to(self.running_mean.dtype)
            mean = flat.mean(0)
            var = torch.clamp((flat * flat).mean(0) - mean * mean, min=0.0)
            self.update_stats(mean.detach(), var.detach())
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (x - mean) * mul + self.bias
        return y if dtype is None else y.to(dtype)


def add_point_mlp(owner: nn.Module, in_features: int,
                  features: Sequence[int], *, use_bn: bool = True,
                  bn_momentum: float = BN_MOMENTUM, device=None,
                  generator: torch.Generator | None = None) -> None:
    """Adds conv1..L and, with `use_bn`, bn1..L to `owner`."""
    gen = default_generator(generator)
    widths = (in_features, *features)
    for i in range(len(features)):
        owner.add_module(f"conv{i + 1}", PointConv(
            widths[i], widths[i + 1], device=device, generator=gen))
        if use_bn:
            owner.add_module(f"bn{i + 1}", BatchNorm(
                widths[i + 1], momentum=bn_momentum, device=device))


EVAL_KERNEL_MIN_POINTS = 128


def use_eval_kernel(x: torch.Tensor, *, training: bool, pool_max: bool,
                    dtype: torch.dtype | None = None) -> bool:
    """Whether an eval chain of x [B, N, C] is `point_mlp_max`: pool_max,
    eval, no compute dtype and N >= 128, as samplenet_tpu/nn/layers.py:
    84-93 (`_fused_ok`) decides on its TPU. `point_mlp` also requires that
    no gradient has to cross the chain."""
    return pool_max and not training and dtype is None and x.dim() == 3 \
        and x.shape[1] >= EVAL_KERNEL_MIN_POINTS


def _needs_grad(x: torch.Tensor, layers) -> bool:
    """Whether autograd would record the chain: grad mode is on and the
    input or a parameter requires a gradient."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        p.requires_grad for conv, bn in layers
        for p in (*conv.parameters(), *bn.parameters())))


FUSED_MODES = ("ghost", "exact")


def fused_bf16_of(mode: str, fused_bf16: bool | None) -> bool:
    """The fused chain's matmul precision: `fused_bf16`, or by default bf16
    for ghost and f32 for exact (samplenet_tpu/nn/layers.py:111-114)."""
    return fused_bf16 if fused_bf16 is not None else mode == "ghost"


def resolve_fused_mode(x: torch.Tensor, widths: Sequence[int], *,
                       training: bool, pool_max: bool,
                       fused_train: bool | None = None,
                       fused_mode: str = "ghost",
                       fused_bf16: bool | None = None,
                       dtype: torch.dtype | None = None) -> str:
    """The train chain for x [B, N, C] through layers of `widths`, as
    samplenet_tpu/nn/layers.py:116-149 picks its fused kernel on its TPU:

    - "plain" with a compute `dtype`: tensor ops in that dtype (JAX's XLA
      chain, :120);
    - "ghost" (`point_mlp_train_max`) when `fused_train` is True,
      `fused_mode` is "ghost", the call trains with `pool_max`, N % 128 ==
      0 and `auto_block_b` finds a block;
    - "exact_bf16" (`point_mlp_exact_train_max` with bf16 operands) where
      JAX runs its exact kernel (`fused_train` None, or True with the
      exact mode; training, `pool_max`, N % 128 == 0, two or more layers,
      `auto_block_b_exact` finds a block) and `fused_bf16_of("exact")` is
      True;
    - otherwise "exact", the exact global-BN chain in f32, which computes
      what both the JAX package's XLA chain and its f32 exact kernel
      compute."""
    if fused_mode not in FUSED_MODES:
        raise ValueError(f"fused_mode must be one of {FUSED_MODES}, got "
                         f"{fused_mode!r}")
    if dtype is not None:
        return "plain"
    if fused_train is False or not training or not pool_max \
            or x.dim() != 3 or x.shape[1] % 128:
        return "exact"
    mode = "exact" if fused_train is None else fused_mode
    bf16 = fused_bf16_of(mode, fused_bf16)
    if mode == "ghost":
        bb = auto_block_b(x.shape[0], x.shape[1], tuple(widths), bf16)
        return "exact" if bb is None else "ghost"
    if bf16 and len(widths) >= 2 and auto_block_b_exact(
            x.shape[0], x.shape[1], tuple(widths), bf16) is not None:
        return "exact_bf16"
    return "exact"


def point_mlp(owner: nn.Module, n_layers: int, x: torch.Tensor, *,
              training: bool = False, pool_max: bool = False,
              use_bn: bool = True,
              fused_train: bool | None = None, fused_mode: str = "ghost",
              fused_bf16: bool | None = None,
              dtype: torch.dtype | None = None,
              eval_bf16: bool = False) -> torch.Tensor:
    """conv -> BN -> ReLU per layer over x [B, N, C], or conv -> ReLU
    without `use_bn` (PCRNet's features). With `pool_max` the
    result is the max over points, [B, C_out]. In training the chain is
    `point_mlp_exact_train_max` (samplenet_tpu/nn/layers.py:151-186), or
    `point_mlp_train_max` where `resolve_fused_mode` picks ghost BN, each
    a kernel with a backward on a CUDA tensor. At eval, for N >= 128 and
    when no gradient has to cross the chain, each BN folds into its
    layer's affine and the chain is `point_mlp_max` (:196-223), a
    forward-only kernel. Otherwise the chain runs as tensor ops under
    autograd: below 128 points as the JAX package's XLA chain does there
    (its fused eval kernel runs only for N >= 128, :100-109), and
    wherever a gradient must cross a frozen network, such as the
    reconstruction track's AE on the sampler's m soft-projected points.
    Without BN the chain is always tensor ops (cuBLAS matmuls on the
    card), train or eval, as the JAX package's PointMLP takes no Pallas
    kernel without BN (samplenet_tpu/nn/layers.py:100-102). A compute
    `dtype` runs tensor ops in it (`dense`, `BatchNorm`) and no kernel.
    `eval_bf16` runs the eval kernel with bf16 operands, the TPU kernel's
    default, which the JAX package does not expose as a flag."""
    if not use_bn:
        for i in range(n_layers):
            x = torch.relu(getattr(owner, f"conv{i + 1}")(x))
        return x.amax(dim=1) if pool_max else x
    layers = [(getattr(owner, f"conv{i + 1}"), getattr(owner, f"bn{i + 1}"))
              for i in range(n_layers)]
    mode = resolve_fused_mode(
        x, [conv.weight.shape[0] for conv, _ in layers], training=training,
        pool_max=pool_max, fused_train=fused_train, fused_mode=fused_mode,
        fused_bf16=fused_bf16, dtype=dtype)
    if pool_max and training and mode != "plain":
        args = (x, [conv.kernel() for conv, _ in layers],
                [conv.bias for conv, _ in layers],
                [bn.weight for _, bn in layers], [bn.bias for _, bn in layers])
        if mode == "ghost":
            pooled, means, vars_ = point_mlp_train_max(
                *args, eps=BN_EPS, bf16=fused_bf16_of("ghost", fused_bf16))
        else:
            pooled, means, vars_ = point_mlp_exact_train_max(
                *args, eps=BN_EPS, bf16=mode == "exact_bf16")
        for (_, bn), mean, var in zip(layers, means, vars_):
            bn.update_stats(mean, var)
        return pooled
    if use_eval_kernel(x, training=training, pool_max=pool_max, dtype=dtype) \
            and not _needs_grad(x, layers):
        wbs = []
        for conv, bn in layers:
            wbs += fold_bn_affine(conv.kernel(), conv.bias, bn.weight,
                                  bn.bias, bn.running_mean, bn.running_var,
                                  BN_EPS)
        # a prefix slice (the progressive evals) is a strided view
        return point_mlp_max(x.contiguous(), tuple(wbs), bf16=eval_bf16)
    for conv, bn in layers:
        x = torch.relu(bn(dense(conv, x, dtype), training, dtype))
    return x.amax(dim=1) if pool_max else x


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
             activate_final: bool = False, training: bool = False,
             dtype: torch.dtype | None = None) -> torch.Tensor:
    """fc -> (BN) -> ReLU over x [B, C], leaving the last layer linear
    unless `activate_final`, in the compute `dtype` where given. Plain
    torch in both modes."""
    for i in range(n_layers):
        x = dense(getattr(owner, f"fc{i + 1}"), x, dtype)
        if i < n_layers - 1 or activate_final:
            bn = getattr(owner, f"bn_fc{i + 1}", None)
            if bn is not None:
                x = bn(x, training, dtype)
            x = torch.relu(x)
    return x


class PointMLP(nn.Module):
    """Per-point MLP over [B, N, C]: conv -> BN -> ReLU on every layer.
    `fused_train`, `fused_mode` and `fused_bf16` select its train chain
    (`resolve_fused_mode`), `dtype` its compute dtype and `eval_bf16` the
    eval kernel's operands (`point_mlp`)."""

    def __init__(self, in_features: int, features: Sequence[int], *,
                 bn_momentum: float = BN_MOMENTUM,
                 fused_train: bool | None = None, fused_mode: str = "ghost",
                 fused_bf16: bool | None = None,
                 dtype: torch.dtype | None = None, eval_bf16: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.features = tuple(features)
        self.fused = dict(fused_train=fused_train, fused_mode=fused_mode,
                          fused_bf16=fused_bf16, dtype=dtype,
                          eval_bf16=eval_bf16)
        add_point_mlp(self, in_features, self.features,
                      bn_momentum=bn_momentum, device=device,
                      generator=generator)

    def forward(self, x: torch.Tensor, training: bool = False,
                pool_max: bool = False) -> torch.Tensor:
        return point_mlp(self, len(self.features), x, training=training,
                         pool_max=pool_max, **self.fused)


class MLPHead(nn.Module):
    """Fully-connected head over [B, C]: BN + ReLU on every layer except,
    unless `activate_final`, the last; in the compute `dtype` where
    given."""

    def __init__(self, in_features: int, features: Sequence[int], *,
                 use_bn: bool = True, activate_final: bool = False,
                 dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.features = tuple(features)
        self.activate_final = activate_final
        self.dtype = dtype
        add_mlp_head(self, in_features, self.features, use_bn=use_bn,
                     activate_final=activate_final, device=device,
                     generator=generator)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        return mlp_head(self, len(self.features), x,
                        activate_final=self.activate_final, training=training,
                        dtype=self.dtype)
