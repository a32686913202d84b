"""Point-cloud autoencoder, the reconstruction track's task network.

Mirrors samplenet_tpu/models/autoencoder.py:28-147 ("ala ICLR-18",
reconstruction/src/ae_templates.py:11-43): the encoder is a per-point MLP
3->64->128->128->256->bottleneck with BN + ReLU and a max over points (the
port's `PointMLP`: the exact-BN kernel in training, or the ghost-BN kernel
with `fused_train` (nn/layers.py::resolve_fused_mode), `point_mlp_max` at
eval for N >= 128 where no gradient must cross it); the decoder is FC
256->256->3*N without BN. The encoder's layers are `encoder.conv{i}` / `encoder.bn{i}`, the decoder's `dec_0`,
`dec_1`, `dec_out`, as the flax tree names them (interop/jax_import.py::
autoencoder_state_dict_from_jax). The losses: Chamfer (both directions
through the nn_direction kernel), approximate EMD (the fused EMD kernel),
and the soft-assignment loss, plain tensor code as it is plain XLA in JAX.
`ConvDecoder` is the JAX package's per-point conv decoder variant
(:150-169), tensor ops as in JAX, where no Pallas kernel runs. Under
tensor parallelism (parallel/mesh.py::shard_params) a wide decoder layer
(the 3*N output) runs column-parallel and its output is gathered
(nn/layers.py).
"""

from __future__ import annotations

import torch
from torch import nn

from samplenet_tpu_torch.nn.layers import (
    Linear,
    PointMLP,
    default_generator,
    whole_channels,
)
from samplenet_tpu_torch.ops.chamfer import nn_distance
from samplenet_tpu_torch.ops.fps import farthest_point_sample_with_points
from samplenet_tpu_torch.ops.matching import approx_emd_cost
from samplenet_tpu_torch.ops.pairwise import pairwise_sqdist


class PointNetAE(nn.Module):
    def __init__(self, num_output_points: int, bottleneck_size: int = 128,
                 encoder_widths: tuple = (64, 128, 128, 256),
                 decoder_widths: tuple = (256, 256), *,
                 fused_train: bool | None = None, fused_mode: str = "ghost",
                 fused_bf16: bool | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.num_output_points = num_output_points
        self.bottleneck_size = bottleneck_size
        self.encoder = PointMLP(3, (*encoder_widths, bottleneck_size),
                                fused_train=fused_train,
                                fused_mode=fused_mode, fused_bf16=fused_bf16,
                                device=device, generator=gen)
        widths = (bottleneck_size, *decoder_widths)
        self._n_dec = len(decoder_widths)
        for i in range(self._n_dec):
            self.add_module(f"dec_{i}", Linear(widths[i], widths[i + 1],
                                               device=device, generator=gen))
        self.dec_out = Linear(widths[-1], 3 * num_output_points,
                              device=device, generator=gen)

    def encode(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        """[B, N, 3] -> [B, bottleneck] global latent."""
        return self.encoder(x, training=training, pool_max=True)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, bottleneck] -> [B, num_output_points, 3]."""
        for i in range(self._n_dec):
            dec = getattr(self, f"dec_{i}")
            z = whole_channels(dec, torch.relu(dec(z)))
        z = whole_channels(self.dec_out, self.dec_out(z))
        return z.reshape(-1, self.num_output_points, 3)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        return self.decode(self.encode(x, training=training))

    @staticmethod
    def sort_output(x_reconstr: torch.Tensor) -> torch.Tensor:
        """FPS-ordered reconstruction (pointnet_ae.py:69-76), through the
        FPS kernel."""
        _, y = farthest_point_sample_with_points(x_reconstr.shape[1],
                                                 x_reconstr.contiguous())
        return y


class ConvDecoder(nn.Module):
    """Per-point conv decoder (reconstruction/src/encoders_decoders.py
    decoder_with_convs_only; samplenet_tpu/models/autoencoder.py:150-169):
    the latent [B, d] is expanded by `expand` to `num_output_points` slots
    of d // 4 channels, refined by a per-point MLP of `widths` (BN + ReLU
    with `use_bn`, no pool) and mapped to 3 coordinates a point by `out`.
    Flax infers d at the first call; here it is `latent_size`."""

    def __init__(self, num_output_points: int, latent_size: int,
                 widths: tuple = (256, 128), use_bn: bool = True, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.num_output_points = num_output_points
        self.latent_size = latent_size
        self.expand = Linear(latent_size,
                             num_output_points * (latent_size // 4),
                             device=device, generator=gen)
        self.convs = PointMLP(latent_size // 4, widths, use_bn=use_bn,
                              device=device, generator=gen)
        self.out = Linear(widths[-1], 3, device=device, generator=gen)

    def forward(self, z: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        """[B, latent_size] -> [B, num_output_points, 3]."""
        x = whole_channels(self.expand, self.expand(z)).reshape(
            z.shape[0], self.num_output_points, self.latent_size // 4)
        last = getattr(self.convs, f"conv{len(self.convs.features)}")
        y = whole_channels(last, self.convs(x, training=training))
        return whole_channels(self.out, self.out(y))


def ae_chamfer_loss(x_reconstr: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean Chamfer distance, both directions (pointnet_ae.py:118-124)."""
    c12, _, c21, _ = nn_distance(x_reconstr, gt)
    return c12.mean() + c21.mean()


def ae_emd_loss(x_reconstr: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean approximate EMD (pointnet_ae.py:125-133): the fused EMD kernel
    on a CUDA tensor (ops/matching.py)."""
    return approx_emd_cost(x_reconstr, gt).mean()


def ae_soft_assignment_loss(x_reconstr: torch.Tensor, gt: torch.Tensor, *,
                            tau_scale: float = 1.0,
                            tau_floor: float = 1e-4) -> torch.Tensor:
    """Softmin matching loss in both directions with a per-cloud adaptive
    temperature tau = tau_scale * mean NN distance (no gradient) +
    tau_floor (samplenet_tpu/models/autoencoder.py:106-141)."""
    d = pairwise_sqdist(x_reconstr, gt)                     # [B, n, m]
    tau_r = d.amin(dim=2).mean(dim=1).detach()
    tau_c = d.amin(dim=1).mean(dim=1).detach()
    tau_r = tau_scale * tau_r[:, None, None] + tau_floor
    tau_c = tau_scale * tau_c[:, None, None] + tau_floor
    w_r = torch.softmax(-d / tau_r, dim=2)
    w_c = torch.softmax(-d / tau_c, dim=1)
    return (w_r * d).sum(2).mean() + (w_c * d).sum(1).mean()


def ae_per_cloud_chamfer(x_reconstr: torch.Tensor,
                         gt: torch.Tensor) -> torch.Tensor:
    """[B] per-cloud Chamfer distance (the NRE's numerator and
    denominator)."""
    c12, _, c21, _ = nn_distance(x_reconstr, gt)
    return c12.mean(dim=1) + c21.mean(dim=1)
