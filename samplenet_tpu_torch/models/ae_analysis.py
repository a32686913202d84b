"""AE latent-space analysis ops.

Mirrors samplenet_tpu/models/ae_analysis.py:23-111, the reconstruction
track's analysis API (reconstruction/src/{autoencoder,
sampler_autoencoder}.py): latent transform, decode and interpolation,
EMD-based sample matching and sample interpolation
(sampler_autoencoder.py:88-131), the critical-point indices (the inputs
that attain each channel's max-pool), and batched reconstructions from
sampled clouds with their per-cloud Chamfer distance. Functions over a
port `PointNetAE` `ae`, whose parameters the JAX package passes apart as
`ae_vars`. The batched two take and give numpy and run on the AE's
device: there the encoder is `point_mlp_max` for N >= 128
(nn/layers.py::use_eval_kernel) and the Chamfer distance `nn_direction`
both ways (`ae_per_cloud_chamfer`).
"""

from __future__ import annotations

import numpy as np
import torch

from samplenet_tpu_torch.models.autoencoder import (
    PointNetAE,
    ae_per_cloud_chamfer,
)
from samplenet_tpu_torch.ops.fps import gather_point
from samplenet_tpu_torch.ops.matching import approx_match


def transform(ae: PointNetAE, x: torch.Tensor) -> torch.Tensor:
    """Clouds [B, N, 3] -> latent codes [B, bottleneck]."""
    return ae.encode(x, training=False)


def decode(ae: PointNetAE, z: torch.Tensor) -> torch.Tensor:
    """Latent codes -> reconstructions [B, num_output_points, 3]."""
    return ae.decode(z)


def _alphas(steps: int, like: torch.Tensor) -> torch.Tensor:
    return torch.linspace(0.0, 1.0, steps + 2, dtype=like.dtype,
                          device=like.device)


def interpolate(ae: PointNetAE, x: torch.Tensor, y: torch.Tensor,
                steps: int) -> torch.Tensor:
    """Decode the latent line between clouds x and y ([N, 3] each):
    [steps + 2, n_out, 3] (autoencoder.py interpolate)."""
    z = transform(ae, torch.stack([x, y]))
    alphas = _alphas(steps, z)[:, None]
    return decode(ae, (1.0 - alphas) * z[0][None] + alphas * z[1][None])


def match_samples(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """s1 [B, M, 3] reordered to best match s2 (sampler_autoencoder.
    match_samples): for each s2 point, the s1 point with the largest
    approximate-EMD weight in approx_match(s2, s1), ties to the lowest
    index."""
    match = approx_match(s2, s1)                            # [B, M2, M1]
    return gather_point(s1, torch.argmax(match, dim=2).to(torch.int32))


def interpolate_samples(s1: torch.Tensor, s2: torch.Tensor,
                        steps: int) -> torch.Tensor:
    """Linear interpolation between sample sets s1 and s2 ([M, 3] each),
    s1 EMD-matched to s2 first so that points travel to their transport
    partners (sampler_autoencoder.py:118-131): [steps + 2, M, 3]."""
    s1m = match_samples(s1[None], s2[None])[0]
    alphas = _alphas(steps, s1m)[:, None, None]
    return (1.0 - alphas) * s1m[None] + alphas * s2[None]


def critical_idx(ae: PointNetAE, x: torch.Tensor) -> torch.Tensor:
    """[B, bottleneck] int32: for every global-feature channel, the first
    input point that attains its max (sampler_autoencoder.
    get_critical_idx), from the encoder's per-point chain without pool."""
    feats = ae.encoder(x, training=False)                  # [B, N, C]
    return torch.argmax(feats, dim=1).to(torch.int32)


def _device(ae: PointNetAE) -> torch.device:
    return next(ae.parameters()).device


def reconstructions_from_sampled(ae: PointNetAE, sampled: np.ndarray,
                                 batch_size: int = 50) -> np.ndarray:
    """The AE's eval forward over sampled clouds [S, m, 3], `batch_size` at
    a time (sampler_autoencoder.get_reconstructions_from_sampled)."""
    device, outs = _device(ae), []
    with torch.no_grad():
        for s in range(0, len(sampled), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(
                sampled[s:s + batch_size], np.float32)).to(device)
            outs.append(ae(x).cpu().numpy())
    return np.concatenate(outs)


def nn_distances_per_cloud(ae: PointNetAE, clouds: np.ndarray,
                           samples: np.ndarray,
                           batch_size: int = 100) -> np.ndarray:
    """[S] per-cloud Chamfer distance between the reconstructions from
    samples and the clouds (sampler_autoencoder.get_nn_distances)."""
    device, outs = _device(ae), []
    with torch.no_grad():
        for i in range(0, len(clouds), batch_size):
            s = torch.from_numpy(np.ascontiguousarray(
                samples[i:i + batch_size], np.float32)).to(device)
            x = torch.from_numpy(np.ascontiguousarray(
                clouds[i:i + batch_size], np.float32)).to(device)
            outs.append(ae_per_cloud_chamfer(ae(s), x).cpu().numpy())
    return np.concatenate(outs)
