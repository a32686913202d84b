"""On-device point-cloud augmentation for the classification track.

Mirrors the jax side of samplenet_tpu/data/augment.py:68-89: a random
rotation of each cloud about the up (Y) axis, then gaussian jitter
(sigma 0.01) clipped to +-0.05 (classification/train_samplenet.py:
289-293), on the clouds' device, from an explicit torch.Generator on that
device. The draws are torch's, not jax.random's: the two agree in
distribution, not in bits.
"""

from __future__ import annotations

import math

import torch

from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import full_f32_matmul


def rotate_y(generator: torch.Generator, batch: torch.Tensor) -> torch.Tensor:
    """Each cloud of batch [B, N, 3] rotated about Y by a uniform angle."""
    angles = torch.rand(batch.shape[0], generator=generator,
                        device=batch.device) * (2 * math.pi)
    c, s = torch.cos(angles), torch.sin(angles)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, z, s], -1),
                       torch.stack([z, o, z], -1),
                       torch.stack([-s, z, c], -1)], dim=-2)   # [B, 3, 3]
    with full_f32_matmul():
        return torch.bmm(batch, rot)


def jitter(generator: torch.Generator, batch: torch.Tensor,
           sigma: float = 0.01, clip: float = 0.05) -> torch.Tensor:
    noise = torch.randn(batch.shape, generator=generator, device=batch.device)
    return batch + torch.clamp(sigma * noise, -clip, clip)


def augment_for_classification(generator: torch.Generator,
                               batch: torch.Tensor) -> torch.Tensor:
    """Rotate, then jitter: the reference's train-time combination."""
    return jitter(generator, rotate_y(generator, batch))
