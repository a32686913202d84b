"""SampleNet: simplification network + soft projection (training) or
on-device hard matching (eval); and FPSSampler and RandomSampler, the
FPS and uniform random baselines with SampleNet's call contract.

Mirrors samplenet_tpu/models/samplenet.py:36-264. The simplification
network is a per-point MLP (3->64->64->64->128->bottleneck, BN+ReLU), a
global max over points and an FC head (256->256->256->3m, BN+ReLU except
the linear output), registration/src/samplenet.py:40-59,90-104. At eval,
SampleNet matches each simplified point to its nearest input point,
de-duplicates, and completes the set by seeded FPS, all on the device
(samplenet.py:119-141, which the reference runs per cloud in numpy).

As in the reference torch SampleNet, the layers sit flat on the module
(conv1..5, bn1..5, fc1..4, bn_fc1..3, project._temperature), so the
state_dict has the reference's key surface. SampleNet is the
simplification network plus the projector and the matcher. Clouds are
[B, N, 3] ("bnc") inside; "bcn" is accepted at the edges. In training,
the forward returns (simplified, projected): batch-statistics BN (the
conv chain as the exact-BN kernel, or with `fused_train` the ghost-BN
kernel, nn/layers.py::resolve_fused_mode) and the soft projection of the
simplified points onto the input (samplenet.py:147-200).

`dtype` is the JAX package's compute dtype (bf16 with `--bf16`): the conv
chain and the FC head run in it as tensor ops with flax's casts and no
kernel (nn/layers.py), and the output layer promotes its input back to
f32, so the simplified cloud, the soft projection, the Chamfer losses and
the matching stay f32 (samplenet_tpu/models/samplenet.py:83-86).
`eval_bf16` runs the eval kernel with bf16 operands, the TPU kernel's
default, which the JAX package does not expose as a flag.
"""

from __future__ import annotations

import torch
from torch import nn

from samplenet_tpu_torch.models import losses as losses_lib
from samplenet_tpu_torch.models.soft_projection import SoftProjection
from samplenet_tpu_torch.nn.layers import (
    BN_MOMENTUM,
    Linear,
    add_mlp_head,
    add_point_mlp,
    default_generator,
    mlp_head,
    point_mlp,
)
from samplenet_tpu_torch.ops.fps import (
    farthest_point_sample_with_points,
    gather_point,
)
from samplenet_tpu_torch.ops.matching import nn_match_from_clouds


def _to_bnc(x: torch.Tensor, shape: str) -> torch.Tensor:
    return x.transpose(1, 2).contiguous() if shape == "bcn" else x


def _from_bnc(x: torch.Tensor, shape: str) -> torch.Tensor:
    return x.transpose(1, 2) if shape == "bcn" else x


class SimplificationNet(nn.Module):
    """PointNet-style regressor emitting `num_out_points` coordinates."""

    def __init__(self, num_out_points: int, bottleneck_size: int = 128,
                 conv_widths: tuple = (64, 64, 64, 128),
                 fc_widths: tuple = (256, 256, 256), fc_bn: bool = True, *,
                 bn_momentum: float = BN_MOMENTUM,
                 fused_train: bool | None = None, fused_mode: str = "ghost",
                 fused_bf16: bool | None = None,
                 dtype: torch.dtype | None = None, eval_bf16: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.num_out_points = num_out_points
        self.dtype = dtype
        self.fused = dict(fused_train=fused_train, fused_mode=fused_mode,
                          fused_bf16=fused_bf16, dtype=dtype,
                          eval_bf16=eval_bf16)
        self._n_conv = len(conv_widths) + 1
        self._n_fc = len(fc_widths)
        add_point_mlp(self, 3, (*conv_widths, bottleneck_size),
                      bn_momentum=bn_momentum, device=device, generator=gen)
        add_mlp_head(self, bottleneck_size, fc_widths, use_bn=fc_bn,
                     activate_final=True, bn_momentum=bn_momentum,
                     device=device, generator=gen)
        self.add_module(f"fc{self._n_fc + 1}", Linear(
            fc_widths[-1], 3 * num_out_points, device=device, generator=gen))

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        """x [B, N, 3] -> simplified [B, num_out_points, 3]."""
        g = point_mlp(self, self._n_conv, x, training=training,
                      pool_max=True, **self.fused)            # [B, bottleneck]
        y = mlp_head(self, self._n_fc, g, activate_final=True,
                     training=training, dtype=self.dtype)
        out = getattr(self, f"fc{self._n_fc + 1}")
        y = out(y.to(out.weight.dtype))        # flax promotes bf16 to f32
        return y.reshape(-1, self.num_out_points, 3)


class SampleNet(SimplificationNet):
    """Sampler with the reference's constructor surface
    (registration/src/samplenet.py:23-35). `forward(x)` returns
    (simplified, matched) in `output_shape` layout; `forward(x,
    training=True)` returns (simplified, projected), or (simplified,
    simplified) with `skip_projection`. The classification track uses
    sigma_mode="tf"; the default stays "torch", as in the JAX package."""

    def __init__(self, num_out_points: int, bottleneck_size: int = 128,
                 group_size: int = 7, initial_temperature: float = 1.0,
                 is_temperature_trainable: bool = True,
                 min_sigma: float = 1e-2, input_shape: str = "bnc",
                 output_shape: str = "bnc", complete_fps: bool = True,
                 skip_projection: bool = False, sigma_mode: str = "torch",
                 conv_widths: tuple = (64, 64, 64, 128),
                 fc_widths: tuple = (256, 256, 256), fc_bn: bool = True, *,
                 bn_momentum: float = BN_MOMENTUM,
                 fused_train: bool | None = None, fused_mode: str = "ghost",
                 fused_bf16: bool | None = None,
                 dtype: torch.dtype | None = None, eval_bf16: bool = False,
                 device=None, generator: torch.Generator | None = None):
        if input_shape not in ("bnc", "bcn"):
            raise ValueError("input_shape must be 'bnc' or 'bcn'")
        if output_shape not in ("bnc", "bcn"):
            raise ValueError("output_shape must be 'bnc' or 'bcn'")
        super().__init__(num_out_points, bottleneck_size, conv_widths,
                         fc_widths, fc_bn, bn_momentum=bn_momentum,
                         fused_train=fused_train, fused_mode=fused_mode,
                         fused_bf16=fused_bf16, dtype=dtype,
                         eval_bf16=eval_bf16, device=device,
                         generator=generator)
        self.input_shape = input_shape
        self.output_shape = output_shape
        self.complete_fps = complete_fps
        self.skip_projection = skip_projection
        self.project = SoftProjection(
            group_size, initial_temperature, is_temperature_trainable,
            min_sigma, sigma_mode, device=device)

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(simplified, sampled). At eval, sampled is the unique +
        FPS-completed hard sample of the input, all on the device; in
        training, the soft projection of the simplified points."""
        x = _to_bnc(x, self.input_shape)
        simp = super().forward(x, training=training)
        if not training:
            out, _ = nn_match_from_clouds(x, simp, self.num_out_points,
                                          complete_fps=self.complete_fps)
        elif self.skip_projection:
            out = simp
        else:
            out, _, _ = self.project.project(x, simp)
        return _from_bnc(simp, self.output_shape), _from_bnc(
            out, self.output_shape)

    def simplify(self, x: torch.Tensor, training: bool = False
                 ) -> torch.Tensor:
        """Simplified cloud only (no projection or matching)."""
        x = _to_bnc(x, self.input_shape)
        return _from_bnc(super().forward(x, training=training),
                         self.output_shape)

    def sigma(self) -> torch.Tensor:
        return self.project.sigma()

    def get_simplification_loss(self, ref_pc: torch.Tensor,
                                samp_pc: torch.Tensor, pc_size: int,
                                gamma: float = 1.0, delta: float = 0.0,
                                training: bool = True) -> torch.Tensor:
        """Zero at inference or with skip_projection (samplenet.py:
        182-195); clouds are [B, N, 3]."""
        if self.skip_projection or not training:
            return torch.zeros((), device=ref_pc.device)
        return losses_lib.simplification_loss(ref_pc, samp_pc, pc_size,
                                              gamma, delta)

    def get_projection_loss(self, training: bool = True) -> torch.Tensor:
        if self.skip_projection or not training:
            return torch.zeros((), device=self.project._temperature.device)
        return losses_lib.projection_loss(self.project.sigma())


class FPSSampler(nn.Module):
    """Farthest point sampling, the non-learned baseline, with SampleNet's
    call contract (samplenet_tpu/models/samplenet.py:203-231, registration/
    src/fps.py:8-43): with `permute` each cloud starts from a random point
    drawn from `generator`, else from point 0; then greedy FPS (the fps
    kernel on a CUDA tensor). Returns (sampled, sampled); both losses are
    zero."""

    def __init__(self, num_out_points: int, permute: bool = True,
                 input_shape: str = "bnc", output_shape: str = "bnc"):
        super().__init__()
        self.num_out_points = num_out_points
        self.permute = permute
        self.input_shape = input_shape
        self.output_shape = output_shape

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        x = _to_bnc(x, self.input_shape)
        b, n, _ = x.shape
        start = torch.randint(0, n, (b,), generator=generator,
                              device=x.device) if self.permute else 0
        _, y = farthest_point_sample_with_points(self.num_out_points, x,
                                                 start_idx=start)
        y = _from_bnc(y, self.output_shape)
        return y, y

    def get_simplification_loss(self, ref_pc: torch.Tensor, *args,
                                **kwargs) -> torch.Tensor:
        return torch.zeros((), device=ref_pc.device)

    def get_projection_loss(self, *args, **kwargs) -> torch.Tensor:
        return torch.zeros(())


def random_subset_indices(keys: torch.Tensor, m: int) -> torch.Tensor:
    """[B, m] int32: the positions of each row's m largest keys, descending;
    on i.i.d. uniform keys [B, N] a uniform m-subset drawn without
    replacement (samplenet_tpu/models/samplenet.py:253-256)."""
    return torch.topk(keys, m, dim=1).indices.to(torch.int32)


class RandomSampler(nn.Module):
    """Uniform random sampling without replacement, the random baseline
    (registration/src/random_sampling.py; samplenet_tpu/models/
    samplenet.py:234-264): each cloud keeps the points of its m largest
    i.i.d. uniform keys, drawn from `generator`. Returns (sampled,
    sampled); both losses are zero."""

    def __init__(self, num_out_points: int, input_shape: str = "bnc",
                 output_shape: str = "bnc"):
        super().__init__()
        self.num_out_points = num_out_points
        self.input_shape = input_shape
        self.output_shape = output_shape

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        if generator is None:
            raise ValueError("RandomSampler draws from an explicit "
                             "torch.Generator; pass generator=")
        x = _to_bnc(x, self.input_shape)
        keys = torch.rand(x.shape[:2], generator=generator, device=x.device)
        y = gather_point(x, random_subset_indices(keys, self.num_out_points))
        y = _from_bnc(y, self.output_shape)
        return y, y

    def get_simplification_loss(self, ref_pc: torch.Tensor, *args,
                                **kwargs) -> torch.Tensor:
        return torch.zeros((), device=ref_pc.device)

    def get_projection_loss(self, *args, **kwargs) -> torch.Tensor:
        return torch.zeros(())
