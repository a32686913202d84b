"""Classification track: the PointNet classifier's own training, and
SampleNet trained against the frozen PointNet.

The classifier half mirrors samplenet_tpu/train/classification.py:40-150
and :273-315 (classification/train_classifier.py): a train step is the
optional on-device augmentation, the classifier's train forward (flax
BN, dropout from its own generator), `pointnet_loss` (with the T-nets'
orthogonality term), backward, the scheduled BN update where asked, and
one guarded Adam step. Under `bn_schedule` the classifier's BNs run with
momentum 0 and the update averages every running statistic, the T-nets'
(momentum 0.9, models/pointnet_cls.py) included, as the JAX package does.

The sampler half mirrors classification.py:57-374
(classification/train_samplenet.py and evaluate_samplenet.py). A train
step is: on-device augmentation, the sampler's train forward (exact-BN
conv chain and soft projection, each a kernel on a CUDA tensor), the
frozen classifier on the projected cloud, L = task + alpha * simplification
(Chamfer, through the nn_direction kernel) + lmbda * projection, backward,
and one guarded Adam step. The classifier is frozen: eval mode and
requires_grad off, while the gradient still flows through it into the
projected cloud (train_samplenet.py:169-171,195-199). Eval is hard
matching (unique + FPS) then the classifier, all on the device.

The conv chain is the exact-BN kernel by default; `fused_train` with
`fused_mode` "ghost" takes the ghost-BN kernel (bf16 operands unless
`fused_bf16` is False), as the JAX config's fused_* knobs do
(nn/layers.py::resolve_fused_mode). The JAX config's other TPU knobs
(bf16, remat, conv_layout) have no counterpart: the port runs f32.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from samplenet_tpu_torch.data import (
    augment,
    iterate_batches,
    iterate_batches_padded,
)
from samplenet_tpu_torch.models.pointnet_cls import (
    PointNetClassifier,
    classification_loss,
    pointnet_loss,
)
from samplenet_tpu_torch.models.samplenet import SampleNet
from samplenet_tpu_torch.train.state import (
    TrainState,
    adam_with_schedule,
    bn_decay_schedule,
    bn_running_stats,
    scheduled_bn_update,
    staircase_lr,
)


@dataclass
class ClassifierConfig:
    num_classes: int = 10
    batch_size: int = 32
    learning_rate: float = 0.001
    decay_step: float = 200000.0
    decay_rate: float = 0.7
    use_tnets: bool = False
    augment: bool = True
    # TF-style scheduled BN decay 0.5 -> 0.99 (train_samplenet.py:124-133):
    # the BatchNorms run with momentum 0 and the EMA happens in the step
    bn_schedule: bool = False
    # bf16 compute waits for ROADMAP Queue 1 item 11; True raises
    bf16: bool = False


@dataclass
class SampleNetConfig:
    num_out_points: int = 32
    bottleneck_size: int = 128
    group_size: int = 7
    initial_temperature: float = 1.0
    min_sigma: float = 1e-2
    skip_projection: bool = False
    # loss weights (classification defaults, train_samplenet.py:39-47)
    alpha: float = 30.0
    lmbda: float = 1.0
    gamma: float = 1.0
    delta: float = 0.0
    learning_rate: float = 0.01
    decay_step: float = 600000.0
    decay_rate: float = 0.7
    batch_size: int = 32
    # TF-style scheduled BN decay 0.5 -> 0.99 (train_samplenet.py:124-133):
    # the BatchNorms run with momentum 0 and the EMA happens in the step
    bn_schedule: bool = False
    # the train chain of the conv layers (nn/layers.py::resolve_fused_mode):
    # None or False = the exact-BN chain; True = the `fused_mode` chain
    fused_train: bool | None = None
    fused_mode: str = "ghost"
    fused_bf16: bool | None = None   # None = bf16 for ghost


def create_classifier_state(cfg: ClassifierConfig, *, device="cuda",
                            seed: int = 0
                            ) -> tuple[PointNetClassifier, TrainState]:
    """The classifier (T-nets with `use_tnets`; BN momentum 0 under
    `bn_schedule`) with flax-style initialisation from `seed`, and its
    guarded Adam."""
    if cfg.bf16:
        raise ValueError("bf16 compute is not ported yet (ROADMAP Queue 1 "
                         "item 11); the classifier trains in f32")
    model = PointNetClassifier(
        cfg.num_classes, use_tnets=cfg.use_tnets,
        bn_momentum=0.0 if cfg.bn_schedule else 0.9,
        generator=torch.Generator().manual_seed(seed)).to(device)
    opt = adam_with_schedule(
        model.parameters(),
        staircase_lr(cfg.learning_rate, cfg.batch_size, cfg.decay_step,
                     cfg.decay_rate))
    return model, TrainState(model=model, optimizer=opt)


def _scheduled_bn_step(model: nn.Module, old_stats: dict, state: TrainState,
                       batch_size: int, decay_step: float) -> None:
    """Overwrites model's running statistics with the scheduled average of
    `old_stats` and the ones its forward just wrote."""
    decay = bn_decay_schedule(state.step, batch_size,
                              decay_step_samples=decay_step)
    new = scheduled_bn_update(old_stats, bn_running_stats(model), decay)
    with torch.no_grad():
        for name, value in new.items():
            model.get_buffer(name).copy_(value)


def make_classifier_train_step(model: PointNetClassifier,
                               cfg: ClassifierConfig) -> Callable:
    """step(state, points [B, N, 3], labels [B], generator,
    dropout_generator) -> (loss, acc), 0-d tensors on the points' device;
    updates state in place. `generator` draws the augmentation,
    `dropout_generator` the dropout masks."""

    def step(state: TrainState, points: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator | None = None,
             dropout_generator: torch.Generator | None = None):
        if cfg.augment:
            points = augment.augment_for_classification(generator, points)
        old_stats = bn_running_stats(model) if cfg.bn_schedule else None
        logits, end_points = model(points, training=True,
                                   generator=dropout_generator)
        loss = pointnet_loss(logits, labels, end_points)
        state.optimizer.zero_grad()
        loss.backward()
        if cfg.bn_schedule:
            _scheduled_bn_step(model, old_stats, state, cfg.batch_size,
                               cfg.decay_step)
        state.optimizer.step()
        state.step += 1
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss.detach(), acc

    return step


def make_classifier_eval_step(model: PointNetClassifier) -> Callable:
    """step(state, points, labels) -> (mean loss, [B] bool correct)."""

    def step(state: TrainState, points: torch.Tensor,
             labels: torch.Tensor):
        with torch.inference_mode():
            logits, _ = model(points)
            return (classification_loss(logits, labels),
                    logits.argmax(-1) == labels)

    return step


def evaluate_classifier(eval_step, state, test_data, batch_size: int, *,
                        device) -> float:
    """Accuracy over every test cloud: the tail batch is padded, then
    sliced, so the result does not depend on batch_size."""
    data, labels = test_data
    correct = []
    for bx, by, real in iterate_batches_padded(data, labels, batch_size):
        _, ok = eval_step(state, *_to_device(bx, by, device))
        correct.append(ok[:real].cpu().numpy())
    return float(np.mean(np.concatenate(correct)))


def train_classifier_loop(model, state, cfg: ClassifierConfig, train_data,
                          test_data, *, epochs: int, logger, device,
                          seed: int = 0, steps_per_epoch: int | None = None,
                          epoch_callback=None):
    """Epochs of shuffled train batches (RandomState(0), as in JAX), each
    followed by the test accuracy. Augmentation draws from a generator
    seeded `seed`, dropout from one seeded `seed + 1`."""
    train_step = make_classifier_train_step(model, cfg)
    eval_step = make_classifier_eval_step(model)
    data, labels = train_data
    np_rng = np.random.RandomState(0)
    generator = torch.Generator(device=device).manual_seed(seed)
    dropout_generator = torch.Generator(device=device).manual_seed(seed + 1)
    for epoch in range(epochs):
        losses, accs = [], []
        for bi, (bx, by) in enumerate(iterate_batches(
                data, labels, cfg.batch_size, rng=np_rng)):
            if steps_per_epoch is not None and bi >= steps_per_epoch:
                break
            loss, acc = train_step(state, *_to_device(bx, by, device),
                                   generator, dropout_generator)
            losses.append(loss)
            accs.append(acc)
        loss = float(torch.stack(losses).mean())
        train_acc = float(torch.stack(accs).mean())
        test_acc = evaluate_classifier(eval_step, state, test_data,
                                       cfg.batch_size, device=device)
        logger.log(f"epoch {epoch}: loss={loss:.4f} "
                   f"train_acc={train_acc:.4f} test_acc={test_acc:.4f}")
        logger.metrics(state.step, loss=loss, train_acc=train_acc,
                       test_acc=test_acc)
        if epoch_callback is not None:
            epoch_callback(epoch, state, test_acc)
    return state


def create_samplenet_state(scfg: SampleNetConfig, *, device="cuda",
                           seed: int = 0) -> tuple[SampleNet, TrainState]:
    """The classification-track sampler (sigma = t^2, no clamp) with
    flax-style initialisation from `seed`, and its guarded Adam."""
    sampler = SampleNet(
        num_out_points=scfg.num_out_points,
        bottleneck_size=scfg.bottleneck_size,
        group_size=scfg.group_size,
        initial_temperature=scfg.initial_temperature,
        min_sigma=scfg.min_sigma,
        skip_projection=scfg.skip_projection,
        sigma_mode="tf",
        bn_momentum=0.0 if scfg.bn_schedule else 0.9,
        fused_train=scfg.fused_train,
        fused_mode=scfg.fused_mode,
        fused_bf16=scfg.fused_bf16,
        generator=torch.Generator().manual_seed(seed),
    ).to(device)
    opt = adam_with_schedule(
        sampler.parameters(),
        staircase_lr(scfg.learning_rate, scfg.batch_size, scfg.decay_step,
                     scfg.decay_rate))
    return sampler, TrainState(model=sampler, optimizer=opt)


def freeze(classifier: nn.Module) -> nn.Module:
    """Eval mode and no parameter gradients; inputs still get gradients."""
    classifier.eval()
    for p in classifier.parameters():
        p.requires_grad_(False)
    return classifier


def make_samplenet_train_step(sampler: SampleNet, classifier: nn.Module,
                              scfg: SampleNetConfig,
                              augment_data: bool = True) -> Callable:
    """step(state, points [B, N, 3], labels [B], generator) -> metrics,
    each a 0-d tensor on the points' device; updates state in place."""
    freeze(classifier)

    def step(state: TrainState, points: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator | None = None) -> dict:
        if augment_data:
            points = augment.augment_for_classification(generator, points)
        old_stats = bn_running_stats(sampler) if scfg.bn_schedule else None
        simp, proj = sampler(points, training=True)
        logits, _ = classifier(proj)
        task_loss = classification_loss(logits, labels)
        simp_loss = sampler.get_simplification_loss(
            points, simp, scfg.num_out_points, scfg.gamma, scfg.delta)
        proj_loss = sampler.get_projection_loss()
        loss = task_loss + scfg.alpha * simp_loss + scfg.lmbda * proj_loss
        state.optimizer.zero_grad()
        loss.backward()
        if scfg.bn_schedule:
            _scheduled_bn_step(sampler, old_stats, state, scfg.batch_size,
                               scfg.decay_step)
        state.optimizer.step()
        state.step += 1
        acc = (logits.argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "task": task_loss.detach(),
                "simplification": simp_loss.detach(),
                "projection": proj_loss.detach(), "acc": acc}

    return step


def make_samplenet_eval_step(sampler: SampleNet,
                             classifier: nn.Module) -> Callable:
    """step(state, points, labels) -> [B] bool: hard matching, then the
    frozen classifier (evaluate_samplenet.py:99-277)."""
    freeze(classifier)

    def step(state: TrainState, points: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            _, matched = sampler(points, training=False)
            logits, _ = classifier(matched)
            return logits.argmax(-1) == labels

    return step


def _to_device(bx: np.ndarray, by: np.ndarray, device):
    return (torch.from_numpy(np.ascontiguousarray(bx)).to(device),
            torch.from_numpy(np.asarray(by, np.int64)).to(device))


def evaluate_samplenet(eval_step, state, test_data, batch_size: int, *,
                       device) -> float:
    """Accuracy over every test cloud (pad-and-slice)."""
    data, labels = test_data
    correct = []
    for bx, by, real in iterate_batches_padded(data, labels, batch_size):
        ok = eval_step(state, *_to_device(bx, by, device))
        correct.append(ok[:real].cpu().numpy())
    return float(np.mean(np.concatenate(correct)))


def per_class_accuracy(eval_step, state, test_data, batch_size: int,
                       num_classes: int, *, device) -> np.ndarray:
    """Per-class accuracy table (evaluate_samplenet.py:273-277)."""
    data, labels = test_data
    correct = np.zeros(num_classes)
    seen = np.zeros(num_classes)
    for bx, by, real in iterate_batches_padded(data, labels, batch_size):
        ok = eval_step(state, *_to_device(bx, by, device)).cpu().numpy()
        np.add.at(seen, by[:real], 1)
        np.add.at(correct, by[:real], ok[:real])
    return correct / np.maximum(seen, 1)


def train_samplenet_loop(sampler, state, scfg: SampleNetConfig, classifier,
                         train_data, test_data, *, epochs: int, logger,
                         device, seed: int = 0,
                         steps_per_epoch: int | None = None,
                         start_epoch: int = 0, epoch_callback=None):
    train_step = make_samplenet_train_step(sampler, classifier, scfg)
    eval_step = make_samplenet_eval_step(sampler, classifier)
    data, labels = train_data
    np_rng = np.random.RandomState(start_epoch)
    generator = torch.Generator(device=device).manual_seed(seed)
    for epoch in range(start_epoch, epochs):
        agg: dict[str, list] = {}
        for bi, (bx, by) in enumerate(iterate_batches(
                data, labels, scfg.batch_size, rng=np_rng)):
            if steps_per_epoch is not None and bi >= steps_per_epoch:
                break
            metrics = train_step(state, *_to_device(bx, by, device),
                                 generator)
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
        means = {k: float(torch.stack(v).mean()) for k, v in agg.items()}
        test_acc = evaluate_samplenet(eval_step, state, test_data,
                                      scfg.batch_size, device=device)
        logger.log(f"epoch {epoch}: " +
                   " ".join(f"{k}={v:.4f}" for k, v in means.items()) +
                   f" eval_acc@{scfg.num_out_points}={test_acc:.4f}")
        logger.metrics(state.step, eval_acc=test_acc, **means)
        if epoch_callback is not None:
            epoch_callback(epoch, state, test_acc)
    return state
