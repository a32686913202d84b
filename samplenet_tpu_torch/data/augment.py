"""Point-cloud augmentation: on the device for the classification track,
with numpy on the host for the reconstruction track's input corruption.

The torch functions mirror the jax side of samplenet_tpu/data/augment.py:
68-89: a random rotation of each cloud about the up (Y) axis, then
gaussian jitter (sigma 0.01) clipped to +-0.05 (classification/
train_samplenet.py:289-293), on the clouds' device, from an explicit
torch.Generator on that device. The draws are torch's, not jax.random's:
the two agree in distribution, not in bits. Under a data-parallel `mesh`
each rank holds its rows of the global batch and draws for the whole
global batch from a generator seeded alike on every rank, keeping its
own rows, so that W ranks augment as one process does (jax.random on a
sharded array). The draws are float32 whatever the clouds' dtype, so a
float64 batch takes the float32 run's augmentation.

`rotate_point_cloud_by_angle` (the evaluation's voting rotations),
`jitter_point_cloud` and `noisy_point_cloud` are copies of the numpy side
(augment.py:19-58; the port cannot import the JAX package): for the same
angle or RandomState they give the JAX package's arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import full_f32_matmul
from samplenet_tpu_torch.parallel.mesh import Mesh, global_rows


def rotate_y(generator: torch.Generator, batch: torch.Tensor,
             mesh: Mesh | None = None) -> torch.Tensor:
    """Each cloud of batch [B, N, 3] rotated about Y by a uniform angle."""
    total, rows = global_rows(mesh, batch.shape[0])
    angles = torch.rand(total, generator=generator,
                        device=batch.device)[rows].to(batch.dtype) \
        * (2 * math.pi)
    c, s = torch.cos(angles), torch.sin(angles)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, z, s], -1),
                       torch.stack([z, o, z], -1),
                       torch.stack([-s, z, c], -1)], dim=-2)   # [B, 3, 3]
    with full_f32_matmul():
        return torch.bmm(batch, rot)


def jitter(generator: torch.Generator, batch: torch.Tensor,
           sigma: float = 0.01, clip: float = 0.05,
           mesh: Mesh | None = None) -> torch.Tensor:
    total, rows = global_rows(mesh, batch.shape[0])
    noise = torch.randn((total, *batch.shape[1:]), generator=generator,
                        device=batch.device)[rows].to(batch.dtype)
    return batch + torch.clamp(sigma * noise, -clip, clip)


def augment_for_classification(generator: torch.Generator,
                               batch: torch.Tensor,
                               mesh: Mesh | None = None) -> torch.Tensor:
    """Rotate, then jitter: the reference's train-time combination."""
    return jitter(generator, rotate_y(generator, batch, mesh), mesh=mesh)


def rotation_matrix_y(angle: np.ndarray) -> np.ndarray:
    """Rotation(s) about the up (Y) axis: [..., 3, 3]."""
    c, s = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [np.stack([c, zeros, s], -1),
         np.stack([zeros, ones, zeros], -1),
         np.stack([-s, zeros, c], -1)], axis=-2)


def rotate_point_cloud_by_angle(batch: np.ndarray,
                                angle: float) -> np.ndarray:
    """Every cloud of batch [B, N, 3] rotated about Y by `angle`."""
    rot = rotation_matrix_y(np.asarray(angle))
    return np.einsum("bnc,cd->bnd", batch, rot).astype(np.float32)


def jitter_point_cloud(batch: np.ndarray, rng: np.random.RandomState,
                       sigma: float = 0.01, clip: float = 0.05) -> np.ndarray:
    """Gaussian noise of `sigma`, clipped to +-clip, on every coordinate."""
    noise = np.clip(sigma * rng.randn(*batch.shape), -clip, clip)
    return (batch + noise).astype(np.float32)


def noisy_point_cloud(batch: np.ndarray, rng: np.random.RandomState,
                      ratio: float = 0.1) -> np.ndarray:
    """Replace a random `ratio` of point slots with uniform [-1, 1] noise
    (the same slots in every cloud of the batch)."""
    b, n, c = batch.shape
    out = batch.copy()
    idx = rng.permutation(n)[: int(n * ratio)]
    out[:, idx, :] = rng.rand(b, len(idx), c) * 2 - 1
    return out.astype(np.float32)
