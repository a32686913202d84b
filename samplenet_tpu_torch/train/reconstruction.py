"""Reconstruction track: AE training, SampleNet against the frozen AE, and
the NRE evaluation.

Mirrors samplenet_tpu/train/reconstruction.py:35-268 (reconstruction/src/
{autoencoder,pointnet_ae,sampler_autoencoder,samplenet_pointnet_ae}.py).
Phase 1 trains the AE on Chamfer, approximate EMD (the fused EMD kernel
on a CUDA tensor) or the soft-assignment loss, optionally noisy -> clean.
Phase 2 trains the reconstruction variant of SampleNet (conv widths
64,128,128,256 -> 128, an FC head 256,256 without BN, soft projection
with k=16 and sigma = max(t, 1e-2)^2) against the frozen AE: L = AE loss
of the reconstruction from the soft-projected sample + alpha * the
size-scaled simplification loss + lmbda * sigma. The AE is frozen (eval
mode, requires_grad off) while the gradient crosses it into the sample;
on the sample's 64 points its encoder runs as tensor ops under autograd
(nn/layers.py::point_mlp). Evaluation reports per-cloud Chamfer of the
reconstruction from the hard-matched sample and from the full input, and
NRE = their ratio of means (sampler/evaluate_samplenet.py:145-152); the
FPS baseline samples by FPS instead.

The JAX config's TPU knobs (fused_train, fused_mode, fused_bf16) and its
EMD knobs (emd_kernel, emd_fast: the XLA scan in place of the fused EMD,
in bf16) have no counterpart: the port's train chain is the exact-BN
kernel, and its EMD the fused EMD kernel, on a CUDA tensor.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from samplenet_tpu_torch.data import iterate_batches_padded
from samplenet_tpu_torch.models.autoencoder import (
    PointNetAE,
    ae_chamfer_loss,
    ae_emd_loss,
    ae_per_cloud_chamfer,
    ae_soft_assignment_loss,
)
from samplenet_tpu_torch.models.losses import (
    reconstruction_simplification_loss,
)
from samplenet_tpu_torch.models.samplenet import SampleNet
from samplenet_tpu_torch.ops.fps import farthest_point_sample_with_points
from samplenet_tpu_torch.train.classification import freeze
from samplenet_tpu_torch.train.state import (
    TrainState,
    adam_with_schedule,
    staircase_lr,
)


@dataclass
class AEConfig:
    num_points: int = 2048
    bottleneck_size: int = 128
    loss: str = "chamfer"          # 'chamfer' | 'emd' | 'softassign'
    batch_size: int = 50           # ae_templates.py:46-56
    learning_rate: float = 5e-4
    use_fps: bool = False          # FPS front-end (pointnet_ae.py:46-56)
    n_sample_points: int = 2048


@dataclass
class SampleNetAEConfig:
    num_out_points: int = 64
    bottleneck_size: int = 128
    group_size: int = 16
    alpha: float = 0.01            # sampler/train_samplenet.py:46-51
    lmbda: float = 0.0001
    is_denoising: bool = False
    batch_size: int = 50
    learning_rate: float = 5e-4


def ae_loss_fn(loss_name: str) -> Callable:
    fns = {"chamfer": ae_chamfer_loss, "emd": ae_emd_loss,
           "softassign": ae_soft_assignment_loss}
    if loss_name not in fns:
        raise ValueError(f"unknown AE loss {loss_name!r}")
    return fns[loss_name]


def _apply(state: TrainState, loss: torch.Tensor) -> None:
    """Backward and one guarded Adam step."""
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    state.step += 1


def create_ae_state(cfg: AEConfig, *, device="cpu",
                    seed: int = 0) -> tuple[PointNetAE, TrainState]:
    model = PointNetAE(cfg.num_points, cfg.bottleneck_size,
                       generator=torch.Generator().manual_seed(seed))
    model = model.to(device)
    opt = adam_with_schedule(model.parameters(),
                             staircase_lr(cfg.learning_rate, cfg.batch_size))
    return model, TrainState(model=model, optimizer=opt)


def make_ae_train_step(model: PointNetAE, cfg: AEConfig) -> Callable:
    """step(state, x, gt=None) -> loss (0-d): reconstructs x against
    itself, or the corrupted x against the clean gt (autoencoder.py:
    121-129). Updates state in place."""
    loss_inner = ae_loss_fn(cfg.loss)

    def step(state: TrainState, x: torch.Tensor,
             gt: torch.Tensor | None = None) -> torch.Tensor:
        target = x if gt is None else gt
        if cfg.use_fps and cfg.n_sample_points < x.shape[1]:
            _, s = farthest_point_sample_with_points(cfg.n_sample_points, x)
        else:
            s = x[:, :cfg.n_sample_points]
        loss = loss_inner(model(s, training=True), target)
        _apply(state, loss)
        return loss.detach()

    return step


def make_ae_eval_step(model: PointNetAE) -> Callable:
    """step(state, x) -> [B] per-cloud Chamfer of the reconstruction."""
    def step(state: TrainState, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return ae_per_cloud_chamfer(model(x), x)

    return step


def make_recon_sampler(cfg: SampleNetAEConfig, *, device="cpu",
                       seed: int = 0) -> SampleNet:
    """The reconstruction-track sampler (src/samplers.py:22-38)."""
    return SampleNet(
        num_out_points=cfg.num_out_points,
        bottleneck_size=cfg.bottleneck_size,
        group_size=cfg.group_size,
        conv_widths=(64, 128, 128, 256),
        fc_widths=(256, 256),
        fc_bn=False,
        sigma_mode="recon",
        min_sigma=1e-2,
        generator=torch.Generator().manual_seed(seed),
    ).to(device)


def create_sampler_ae_state(cfg: SampleNetAEConfig, *, device="cpu",
                            seed: int = 0) -> tuple[SampleNet, TrainState]:
    sampler = make_recon_sampler(cfg, device=device, seed=seed)
    opt = adam_with_schedule(sampler.parameters(),
                             staircase_lr(cfg.learning_rate, cfg.batch_size))
    return sampler, TrainState(model=sampler, optimizer=opt)


def make_sampler_ae_train_step(sampler: SampleNet, ae: PointNetAE,
                               cfg: SampleNetAEConfig,
                               ae_loss: str = "chamfer") -> Callable:
    """step(state, x, gt=None) -> metrics {loss, ae, simplification,
    projection}, each 0-d. x is the (possibly corrupted) sampler input,
    gt the clean target of the AE loss; the simplification loss stays
    against x (samplenet_pointnet_ae.py:165-189)."""
    freeze(ae)
    loss_inner = ae_loss_fn(ae_loss)

    def step(state: TrainState, x: torch.Tensor,
             gt: torch.Tensor | None = None) -> dict:
        target = x if gt is None else gt
        simp, proj = sampler(x, training=True)
        loss_ae = loss_inner(ae(proj), target)
        loss_simp = reconstruction_simplification_loss(
            x, simp, cfg.num_out_points, cfg.is_denoising)
        sigma = sampler.get_projection_loss()
        loss = loss_ae + cfg.alpha * loss_simp + cfg.lmbda * sigma
        _apply(state, loss)
        return {"loss": loss.detach(), "ae": loss_ae.detach(),
                "simplification": loss_simp.detach(),
                "projection": sigma.detach()}

    return step


def make_sampler_ae_eval_step(sampler: SampleNet,
                              ae: PointNetAE) -> Callable:
    """step(state, x, gt=None) -> (per-cloud Chamfer of the reconstruction
    from the hard-matched sample, and from the full input), both against
    gt (the denoising protocol) or x."""
    freeze(ae)

    def step(state: TrainState, x: torch.Tensor,
             gt: torch.Tensor | None = None):
        target = x if gt is None else gt
        with torch.inference_mode():
            _, matched = sampler(x, training=False)
            return (ae_per_cloud_chamfer(ae(matched), target),
                    ae_per_cloud_chamfer(ae(x), target))

    return step


def make_fps_ae_eval_step(ae: PointNetAE, num_out_points: int) -> Callable:
    """The FPS baseline of `make_sampler_ae_eval_step`: reconstruct from
    `num_out_points` FPS points (the paper's NRE reference)."""
    freeze(ae)

    def step(state, x: torch.Tensor, gt: torch.Tensor | None = None):
        target = x if gt is None else gt
        with torch.inference_mode():
            _, sampled = farthest_point_sample_with_points(num_out_points, x)
            return (ae_per_cloud_chamfer(ae(sampled), target),
                    ae_per_cloud_chamfer(ae(x), target))

    return step


def evaluate_nre(eval_step, state, data: np.ndarray, batch_size: int, *,
                 device, noise_fn=None) -> dict:
    """Mean reconstruction losses and NRE over every cloud of `data` (the
    last batch padded, then cut). `noise_fn` corrupts the model input
    while the clean cloud stays the scoring target."""
    sampled_losses, full_losses = [], []
    labels = np.zeros(len(data), np.int32)
    for bx, _, real in iterate_batches_padded(data, labels, batch_size):
        clean = torch.from_numpy(np.ascontiguousarray(bx)).to(device)
        if noise_fn is None:
            ls, lf = eval_step(state, clean)
        else:
            noisy = torch.from_numpy(np.ascontiguousarray(noise_fn(bx)))
            ls, lf = eval_step(state, noisy.to(device), clean)
        sampled_losses.append(ls[:real].cpu().numpy())
        full_losses.append(lf[:real].cpu().numpy())
    sampled = np.concatenate(sampled_losses)
    full = np.concatenate(full_losses)
    return {
        "loss_sampled_mean": float(sampled.mean()),
        "loss_full_mean": float(full.mean()),
        "nre": float(sampled.mean() / max(full.mean(), 1e-12)),
    }
