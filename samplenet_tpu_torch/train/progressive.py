"""SampleNetProgressive: nested (ordered) sampling, one checkpoint for every
sample size.

Mirrors samplenet_tpu/train/progressive.py:42-275
(classification/train_samplenet_progressive.py:156-249, infer_samplenet_
progressive.py:94-255, reconstruction/src/samplenet_progressive_pointnet_
ae.py:70-110,164-194). Training: the sampler emits max_num_out_points
points once; for every prefix size 2^k in [min .. max] the frozen task
network scores the projected prefix and a simplification loss scores the
simplified prefix. The classification variant SUMS the per-size losses,
the AE variant AVERAGES them; only the sampler trains, and the gradient
crosses the frozen network on every prefix (the network runs its chain
under autograd there, nn/layers.py::point_mlp). Inference emits the
ordered outputs once (simplified, soft-projected, hard-projected through
the 1-NN snap kernel, matched with FPS completion), then scores any prefix.

A train step is built as the classification track builds its step
(train/classification.py): eval-mode frozen network, one backward, one
guarded Adam step. The sampler's conv chain is the exact-BN kernel or,
with `fused_train`, the ghost-BN kernel (nn/layers.py::resolve_fused_mode).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from samplenet_tpu_torch.data import iterate_batches_padded
from samplenet_tpu_torch.models.autoencoder import (
    PointNetAE,
    ae_chamfer_loss,
    ae_per_cloud_chamfer,
)
from samplenet_tpu_torch.models.losses import (
    reconstruction_simplification_loss,
    simplification_loss,
)
from samplenet_tpu_torch.models.pointnet_cls import classification_loss
from samplenet_tpu_torch.models.samplenet import SampleNet
from samplenet_tpu_torch.ops.matching import nn_match_from_clouds
from samplenet_tpu_torch.train.classification import _to_device, freeze
from samplenet_tpu_torch.train.reconstruction import _apply
from samplenet_tpu_torch.train.state import (
    TrainState,
    adam_with_schedule,
    staircase_lr,
)


def progressive_sizes(min_out: int, max_out: int) -> tuple[int, ...]:
    sizes, b = [], min_out
    while b <= max_out:
        sizes.append(b)
        b *= 2
    return tuple(sizes)


@dataclass
class ProgressiveConfig:
    max_num_out_points: int = 1024
    min_num_out_points: int = 8
    bottleneck_size: int = 128
    group_size: int = 7
    # progressive classification weights (train_samplenet_progressive.py:40-41)
    alpha: float = 30.0
    lmbda: float = 1.0
    gamma: float = 0.5
    delta: float = 1.0 / 30.0
    learning_rate: float = 0.01
    batch_size: int = 32
    # the conv chain's train chain (nn/layers.py::resolve_fused_mode):
    # None or False = the exact-BN chain; True = the `fused_mode` chain
    fused_train: bool | None = None
    fused_mode: str = "ghost"
    fused_bf16: bool | None = None   # None = bf16 for ghost

    @property
    def sizes(self) -> tuple[int, ...]:
        return progressive_sizes(self.min_num_out_points,
                                 self.max_num_out_points)


def create_progressive_state(cfg: ProgressiveConfig, *, device="cuda",
                             seed: int = 0) -> tuple[SampleNet, TrainState]:
    """The classification-track sampler at max_num_out_points (sigma =
    t^2) from `seed`, and its guarded Adam."""
    sampler = SampleNet(
        num_out_points=cfg.max_num_out_points,
        bottleneck_size=cfg.bottleneck_size,
        group_size=cfg.group_size,
        sigma_mode="tf",
        fused_train=cfg.fused_train,
        fused_mode=cfg.fused_mode,
        fused_bf16=cfg.fused_bf16,
        generator=torch.Generator().manual_seed(seed),
    ).to(device)
    opt = adam_with_schedule(
        sampler.parameters(),
        staircase_lr(cfg.learning_rate, cfg.batch_size, 600000.0))
    return sampler, TrainState(model=sampler, optimizer=opt)


def make_progressive_train_step(sampler: SampleNet, classifier: nn.Module,
                                cfg: ProgressiveConfig) -> Callable:
    """step(state, points [B, N, 3], labels [B]) -> metrics {loss,
    classifier, simplification, projection, acc@s per size}, each 0-d;
    updates state in place. The frozen classifier runs once per prefix of
    the projected cloud, and the per-size losses are summed."""
    freeze(classifier)
    sizes = cfg.sizes

    def step(state: TrainState, points: torch.Tensor,
             labels: torch.Tensor) -> dict:
        simp, proj = sampler(points, training=True)
        loss_cls = loss_simp = 0.0
        accs = []
        for s in sizes:
            logits, _ = classifier(proj[:, :s])
            loss_cls = loss_cls + classification_loss(logits, labels)
            loss_simp = loss_simp + simplification_loss(
                points, simp[:, :s], s, cfg.gamma, cfg.delta)
            accs.append((logits.argmax(-1) == labels).float().mean())
        sigma = sampler.get_projection_loss()
        loss = loss_cls + cfg.alpha * loss_simp + cfg.lmbda * sigma
        _apply(state, loss)
        metrics = {"loss": loss.detach(), "classifier": loss_cls.detach(),
                   "simplification": loss_simp.detach(),
                   "projection": sigma.detach()}
        metrics.update({f"acc@{s}": a for s, a in zip(sizes, accs)})
        return metrics

    return step


def make_progressive_infer_step(sampler: SampleNet,
                                num_out_points: int) -> Callable:
    """step(state, points) -> the ordered (simplified, soft, hard, matched)
    [B, m, 3] each: the four h5 dump trees of infer_samplenet_progressive,
    in one call. hard snaps each simplified point to its nearest input
    point (the nn_snap kernel); matched is the eval forward's unique +
    FPS-completed sample of num_out_points."""

    def step(state: TrainState, points: torch.Tensor):
        with torch.inference_mode():
            simp = sampler.simplify(points)
            soft, _, _ = sampler.project.project(points, simp)
            hard, _, _ = sampler.project.project(points, simp, hard=True)
            matched, _ = nn_match_from_clouds(points, simp, num_out_points)
        return simp, soft, hard, matched

    return step


def evaluate_prefixes(infer_step, state, classifier: nn.Module, data, labels,
                      sizes, batch_size: int, *, device) -> dict[int, float]:
    """Accuracy at every prefix length of the matched ordered output
    (evaluate_from_files.py:175-190), without the h5 round trip."""
    freeze(classifier)
    correct: dict[int, list] = {s: [] for s in sizes}
    for bx, by, real in iterate_batches_padded(data, labels, batch_size):
        x, y = _to_device(bx, by, device)
        _, _, _, matched = infer_step(state, x)
        with torch.inference_mode():
            for s in sizes:
                logits, _ = classifier(matched[:, :s])
                ok = logits.argmax(-1) == y
                correct[s].append(ok[:real].cpu().numpy())
    return {s: float(np.mean(np.concatenate(v))) for s, v in correct.items()}


def evaluate_ae_prefix_nre(sampler: SampleNet, state, ae: PointNetAE, data,
                           sizes, batch_size: int, *,
                           device) -> dict[int, dict[str, float]]:
    """Prefix-NRE curve of a progressive sampler against a frozen AE
    (reconstruction/sampler/evaluate_samplenet_progressive.py:92-153): one
    inference pass gives the ordered matched cloud at max(sizes); each
    prefix is reconstructed by the AE and scored as NRE(s) = CD(recon from
    the first s points) / CD(recon from the full input).

    Returns {size: {"loss_sampled", "loss_full", "nre"}}."""
    freeze(ae)
    infer = make_progressive_infer_step(sampler, max(sizes))
    labels = np.zeros(len(data), np.int32)
    per_size: dict[int, list] = {s: [] for s in sizes}
    full_losses = []
    for bx, _, real in iterate_batches_padded(data, labels, batch_size):
        x = torch.from_numpy(np.ascontiguousarray(bx)).to(device)
        _, _, _, matched = infer(state, x)
        with torch.inference_mode():
            full_losses.append(ae_per_cloud_chamfer(ae(x), x)[:real].cpu())
            for s in sizes:
                per_size[s].append(ae_per_cloud_chamfer(
                    ae(matched[:, :s]), x)[:real].cpu())
    full = float(torch.cat(full_losses).mean())
    out = {}
    for s in sizes:
        sampled = float(torch.cat(per_size[s]).mean())
        out[s] = {"loss_sampled": sampled, "loss_full": full,
                  "nre": sampled / max(full, 1e-12)}
    return out


# ------------------------------------------------------------- AE variant

@dataclass
class ProgressiveAEConfig:
    max_num_out_points: int = 2048
    min_num_out_points: int = 16
    bottleneck_size: int = 128
    group_size: int = 16
    alpha: float = 0.01
    lmbda: float = 0.0001
    is_denoising: bool = False
    learning_rate: float = 5e-4
    batch_size: int = 50

    @property
    def sizes(self) -> tuple[int, ...]:
        return progressive_sizes(self.min_num_out_points,
                                 self.max_num_out_points)


def make_progressive_ae_train_step(sampler: SampleNet, ae: PointNetAE,
                                   cfg: ProgressiveAEConfig) -> Callable:
    """step(state, x) -> metrics {loss, ae, simplification, projection},
    each 0-d: per-size losses AVERAGED (samplenet_progressive_
    pointnet_ae.py:164-194), each prefix's reconstruction scored by Chamfer
    against x. Updates state in place."""
    freeze(ae)
    sizes = cfg.sizes

    def step(state: TrainState, x: torch.Tensor) -> dict:
        simp, proj = sampler(x, training=True)
        loss_ae = loss_simp = 0.0
        for s in sizes:
            loss_ae = loss_ae + ae_chamfer_loss(ae(proj[:, :s]), x)
            loss_simp = loss_simp + reconstruction_simplification_loss(
                x, simp[:, :s], s, cfg.is_denoising)
        loss_ae = loss_ae / len(sizes)
        loss_simp = loss_simp / len(sizes)
        sigma = sampler.get_projection_loss()
        loss = loss_ae + cfg.alpha * loss_simp + cfg.lmbda * sigma
        _apply(state, loss)
        return {"loss": loss.detach(), "ae": loss_ae.detach(),
                "simplification": loss_simp.detach(),
                "projection": sigma.detach()}

    return step
