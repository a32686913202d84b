"""Registration track: PCRNet training, SampleNet against the frozen
PCRNet, and the rotation-error evaluation.

Mirrors samplenet_tpu/train/registration.py:28-293 (registration/main.py's
Action: train_1 / eval_1 / test_1). Phase 1 trains PCRNet on full clouds:
the Chamfer distance between the source and the template under the
estimate, plus the norm error of the estimated rotation against the
ground truth (`loss_type` 0) or the Chamfer distance alone (1). Phase 2
trains SampleNet against the frozen PCRNet: the sampler's train forward
on the source, then on the template (`num_sampled_clouds` 2), each
through the exact-BN conv chain (or, with `fused_train` in ghost mode,
the ghost-BN chain; nn/layers.py::resolve_fused_mode) and the soft
projection, PCRNet's loss on the projected clouds, plus alpha * the mean
simplification loss + lmbda * sigma. The two train forwards each average
their batch statistics into the running ones, the second starting from
the first's result, as the JAX step chains them. PCRNet is frozen (eval
mode, requires_grad off) while the gradient crosses it into the samples;
its feature chain has no BN and runs as matmuls (models/pcrnet.py).

A train step is a closure over TrainState, updated in place, with the
non-finite guard of train/state.py. The evaluation samples both clouds
in eval mode (hard matching, or FPS with `FPSSampler`), registers them,
and reports per-sample rotation errors in degrees, the AUC of the
precision curve over 0-180 degrees in 0.5-degree bins (main.py:461-479)
and the per-sample sampling consistency (main.py:540-555); the last
batch is padded with repeats of its last pair and the padding sliced
off, so no sample is dropped and nothing depends on the batch size.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from samplenet_tpu_torch.geometry.quaternion import qmul, qrot
from samplenet_tpu_torch.geometry.transforms import (
    QuaternionTransform,
    rad_to_deg,
)
from samplenet_tpu_torch.models.pcrnet import PCRNet
from samplenet_tpu_torch.models.samplenet import SampleNet
from samplenet_tpu_torch.ops.chamfer import chamfer_distance
from samplenet_tpu_torch.train.classification import freeze
from samplenet_tpu_torch.train.reconstruction import _apply
from samplenet_tpu_torch.train.state import (
    TrainState,
    adam_with_schedule,
    staircase_lr,
)


@dataclass
class RegistrationConfig:
    num_points: int = 1024
    num_out_points: int = 64
    bottleneck_size: int = 128     # the sampler's; PCRNet's is 1024
    group_size: int = 8
    # sputils.get_parser defaults (registration/src/sputils.py:45-61)
    alpha: float = 0.01
    lmbda: float = 0.01
    gamma: float = 1.0
    delta: float = 0.0
    loss_type: int = 0          # 0: norm_err + chamfer; 1: chamfer only
    num_sampled_clouds: int = 2  # sample source and template
    batch_size: int = 32
    learning_rate: float = 1e-3
    skip_projection: bool = False
    # refinement passes composed inside the train loss
    train_iterations: int = 1
    # the sampler's train chain (nn/layers.py::resolve_fused_mode):
    # None or False = the exact-BN chain; True = the `fused_mode` chain
    fused_train: bool | None = None
    fused_mode: str = "ghost"
    fused_bf16: bool | None = None


def pcrnet_losses(pcrnet: PCRNet, p0: torch.Tensor, p1: torch.Tensor,
                  igt_vec: torch.Tensor, loss_type: int,
                  iterations: int = 1) -> tuple[torch.Tensor, dict]:
    """(loss, info): the Chamfer alignment loss and the transform errors
    (main.py:557-598). One pass scores the rotation alone, est.rotate(p0);
    with `iterations` > 1 the loss is taken on the composed estimate,
    est.apply(p0), differentiable through every pass, and qnorm_loss is
    0. rot_err_deg and trans_err are reported, never differentiated."""
    if iterations == 1:
        twist, pre_quat = pcrnet(p0, p1)
        qnorm_loss = (((pre_quat ** 2).sum(1) - 1.0) ** 2).mean()
        est = QuaternionTransform(twist)
    else:
        est = register_iterative(pcrnet, p0, p1, iterations)
        qnorm_loss = torch.zeros((), device=p0.device, dtype=p0.dtype)
    gt = QuaternionTransform(igt_vec)
    p1_est = est.rotate(p0) if iterations == 1 else est.apply(p0)
    c01, c10 = chamfer_distance(p1, p1_est)
    chamfer = c01.mean() + c10.mean()
    rot_err, norm_err, trans_err = est.compute_errors(gt)
    loss = norm_err + chamfer if loss_type == 0 else chamfer
    info = {"chamfer_loss": chamfer, "qnorm_loss": qnorm_loss,
            "rot_err_deg": rad_to_deg(rot_err), "norm_err": norm_err,
            "trans_err": trans_err}
    return loss, {k: v.detach() for k, v in info.items()}


def sampling_consistency(p0s: torch.Tensor, p1s: torch.Tensor,
                         igt_vec: torch.Tensor) -> torch.Tensor:
    """Per-sample Chamfer [B] between the template's samples and the
    source's samples rotated back by the ground truth (mean over points
    of both directions), so the evaluation can slice off its padding."""
    p0s_est = QuaternionTransform(igt_vec).inverse().rotate(p1s)
    c0, c1 = chamfer_distance(p0s, p0s_est)
    return c0.mean(1) + c1.mean(1)


def _adam(model: torch.nn.Module, cfg: RegistrationConfig):
    return adam_with_schedule(model.parameters(),
                              staircase_lr(cfg.learning_rate, cfg.batch_size))


def create_pcrnet_state(cfg: RegistrationConfig, *, device="cuda",
                        seed: int = 0) -> tuple[PCRNet, TrainState]:
    """PCRNet at bottleneck 1024, whatever cfg.bottleneck_size (the
    sampler's) says, as the JAX package builds it, with flax-style
    initialisation from `seed`, and its guarded Adam."""
    model = PCRNet(generator=torch.Generator().manual_seed(seed)).to(device)
    return model, TrainState(model=model, optimizer=_adam(model, cfg))


def create_sampler_state(cfg: RegistrationConfig, *, device="cuda",
                         seed: int = 0) -> tuple[SampleNet, TrainState]:
    """The registration sampler: sigma = max(t^2, 1e-2) ("torch" mode)."""
    sampler = SampleNet(
        num_out_points=cfg.num_out_points,
        bottleneck_size=cfg.bottleneck_size,
        group_size=cfg.group_size,
        min_sigma=1e-2,
        sigma_mode="torch",
        skip_projection=cfg.skip_projection,
        fused_train=cfg.fused_train,
        fused_mode=cfg.fused_mode,
        fused_bf16=cfg.fused_bf16,
        generator=torch.Generator().manual_seed(seed),
    ).to(device)
    return sampler, TrainState(model=sampler, optimizer=_adam(sampler, cfg))


def make_pcrnet_train_step(model: PCRNet, cfg: RegistrationConfig
                           ) -> Callable:
    """Phase 1: step(state, p0, p1, igt_vec) -> metrics {loss,
    chamfer_loss, qnorm_loss, rot_err_deg, norm_err, trans_err}, each
    0-d; updates state in place."""

    def step(state: TrainState, p0: torch.Tensor, p1: torch.Tensor,
             igt_vec: torch.Tensor) -> dict:
        loss, info = pcrnet_losses(model, p0, p1, igt_vec, cfg.loss_type,
                                   cfg.train_iterations)
        _apply(state, loss)
        return {"loss": loss.detach(), **info}

    return step


def make_sampler_train_step(sampler: SampleNet, pcrnet: PCRNet,
                            cfg: RegistrationConfig) -> Callable:
    """Phase 2 (main.py:306-362): step(state, p0, p1, igt_vec) -> the
    phase-1 metrics and simplification_loss, projection_loss; updates
    state in place. With num_sampled_clouds 1 the template stays whole."""
    freeze(pcrnet)
    m = cfg.num_out_points

    def step(state: TrainState, p0: torch.Tensor, p1: torch.Tensor,
             igt_vec: torch.Tensor) -> dict:
        p1_simp, p1_proj = sampler(p1, training=True)
        s1 = sampler.get_simplification_loss(p1, p1_simp, m, cfg.gamma,
                                             cfg.delta)
        if cfg.num_sampled_clouds == 2:
            p0_simp, p0_proj = sampler(p0, training=True)
            s0 = sampler.get_simplification_loss(p0, p0_simp, m, cfg.gamma,
                                                 cfg.delta)
            simplification = 0.5 * (s1 + s0)
            sampled = (p0_proj, p1_proj)
        else:
            simplification = s1
            sampled = (p0, p1_proj)
        projection = sampler.get_projection_loss()
        task_loss, info = pcrnet_losses(pcrnet, *sampled, igt_vec,
                                        cfg.loss_type, cfg.train_iterations)
        loss = task_loss + cfg.alpha * simplification + cfg.lmbda * projection
        _apply(state, loss)
        return {"loss": loss.detach(), **info,
                "simplification_loss": simplification.detach(),
                "projection_loss": projection.detach()}

    return step


def register_iterative(pcrnet: PCRNet, p0: torch.Tensor, p1: torch.Tensor,
                       iterations: int = 1) -> QuaternionTransform:
    """Iteratively refined registration (the original PCRNet protocol):
    each pass registers the moved template against the source, and the
    estimates compose, q = q_est * q and t = q_est t q_est^-1 + t_est."""
    b = p0.shape[0]
    q_total = torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=p0.dtype,
                           device=p0.device).expand(b, 4)
    t_total = torch.zeros((b, 3), dtype=p0.dtype, device=p0.device)
    p0_cur = p0
    for _ in range(iterations):
        twist, _ = pcrnet(p0_cur, p1)
        est = QuaternionTransform(twist)
        p0_cur = est.apply(p0_cur)
        q_total = qmul(est.quat, q_total)
        t_total = qrot(est.quat, t_total) + est.trans
    return QuaternionTransform(torch.cat([q_total, t_total], dim=-1))


def make_eval_step(sampler: torch.nn.Module | None, pcrnet: PCRNet,
                   cfg: RegistrationConfig, *,
                   iterations: int = 1) -> Callable:
    """step(p0, p1, igt_vec) -> (per-sample rotation errors [B] in
    degrees, the batch's mean |t_est - t_gt|, per-sample consistency
    [B]): both clouds sampled in eval mode by `sampler` (SampleNet's hard
    matching, FPSSampler, or none), then registered. The reference scores
    at batch size 1 (main.py:127), so the errors stay per sample."""

    def step(p0: torch.Tensor, p1: torch.Tensor, igt_vec: torch.Tensor):
        with torch.inference_mode():
            if sampler is not None:
                _, p1s = sampler(p1, training=False)
                p0s = sampler(p0, training=False)[1] \
                    if cfg.num_sampled_clouds == 2 else p0
            else:
                p0s, p1s = p0, p1
            est = register_iterative(pcrnet, p0s, p1s, iterations)
            gt = QuaternionTransform(igt_vec)
            rot_errs = rad_to_deg(est.rotation_errors(gt))
            trans_err = torch.sqrt((est.trans - gt.trans) ** 2).mean()
            return rot_errs, trans_err, sampling_consistency(p0s, p1s,
                                                             igt_vec)

    return step


def precision_auc(rotation_errors_deg: np.ndarray
                  ) -> tuple[np.ndarray, float]:
    """Precision curve over 0..180 degrees in 0.5 steps, and its AUC
    (main.py:461-479)."""
    thresholds = np.arange(0.0, 180.0, 0.5)
    n = len(rotation_errors_deg)
    precision = np.array([np.sum(rotation_errors_deg <= t) / max(n, 1)
                          for t in thresholds])
    return precision, float(np.sum(precision) / len(thresholds))


def evaluate(eval_step: Callable, dataset, batch_size: int, *,
             device) -> dict[str, float]:
    """Per-sample metrics over every pair of `dataset`: the last batch is
    padded with repeats of its last pair, and the padding sliced off."""
    rot_errs, consistencies = [], []
    items = [dataset[i] for i in range(len(dataset))]
    for s in range(0, len(items), batch_size):
        chunk = items[s:s + batch_size]
        real = len(chunk)
        chunk += [chunk[-1]] * (batch_size - real)
        p0, p1, tw = (torch.from_numpy(np.stack([c[j] for c in chunk]))
                      .to(device) for j in range(3))
        r, _, c = eval_step(p0, p1, tw)
        rot_errs.append(r[:real].cpu().numpy())
        consistencies.append(c[:real].cpu().numpy())
    rot = np.concatenate(rot_errs) if rot_errs else np.zeros(0)
    cons = np.concatenate(consistencies) if consistencies else np.zeros(0)
    _, auc = precision_auc(rot)
    return {
        "rot_err_mean": float(rot.mean()) if len(rot) else float("nan"),
        "rot_err_std": float(rot.std()) if len(rot) else float("nan"),
        "auc": auc,
        "consistency_mean": float(np.mean(cons)),
        "consistency_std": float(np.std(cons)),
    }
