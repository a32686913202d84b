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

The conv chain is the exact-BN kernel by default (bf16 operands with
`fused_bf16`); `fused_train` with `fused_mode` "ghost" takes the ghost-BN
kernel (bf16 operands unless `fused_bf16` is False), as the JAX config's
fused_* knobs do (nn/layers.py::resolve_fused_mode). `bf16` in either
config is the JAX package's compute dtype (classification.py:52-54, 75,
99, 165): the model's chains and heads run in bf16 as tensor ops, no
kernel in the conv chain, parameters f32; the frozen classifier stays
f32 (train_samplenet.py:86). The JAX config's other TPU knobs (remat,
conv_layout) have no counterpart.

Data parallelism (classification.py:253-345, `mesh=`): a step run on a
state under `parallel.mesh.data_parallel` takes this rank's rows of the
global batch, draws its augmentation (and the classifier its dropout)
for the global batch, and leaves every rank with the parameters one
process computes on the global batch (global BatchNorm statistics,
gradients averaged by the guarded optimiser). Under a mesh with a model
axis the loops also shard the wide layers (parallel/mesh.py::
shard_params); the CLIs build model = 1, as the JAX CLIs do. The loops
with a `mesh`
feed each rank its rows of the same global batches, report metrics
averaged over the ranks and evaluate on shards of the test set whose
integer correct counts are summed, so the accuracy is one process's.
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
from samplenet_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    batch_rows,
    data_parallel,
    global_mean,
    shard_batch,
    shard_params,
)
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
    # bf16 compute dtype (parameters stay f32): models/pointnet_cls.py
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
    # bf16 compute dtype (parameters stay f32; no kernel in the conv chain,
    # whose fused_* knobs it overrides): models/samplenet.py
    bf16: bool = False
    # the train chain of the conv layers (nn/layers.py::resolve_fused_mode):
    # None or False = the exact-BN chain; True = the `fused_mode` chain
    fused_train: bool | None = None
    fused_mode: str = "ghost"
    fused_bf16: bool | None = None   # None = bf16 for ghost, f32 for exact


def create_classifier_state(cfg: ClassifierConfig, *, device="cuda",
                            seed: int = 0
                            ) -> tuple[PointNetClassifier, TrainState]:
    """The classifier (T-nets with `use_tnets`; BN momentum 0 under
    `bn_schedule`; bf16 compute with `bf16`) with flax-style
    initialisation from `seed`, and its guarded Adam."""
    model = PointNetClassifier(
        cfg.num_classes, use_tnets=cfg.use_tnets,
        bn_momentum=0.0 if cfg.bn_schedule else 0.9,
        dtype=torch.bfloat16 if cfg.bf16 else None,
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
    `dropout_generator` the dropout masks. Under `state.mesh`, points and
    labels are this rank's rows and loss and acc its share's."""

    def step(state: TrainState, points: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator | None = None,
             dropout_generator: torch.Generator | None = None):
        if cfg.augment:
            points = augment.augment_for_classification(generator, points,
                                                        state.mesh)
        old_stats = bn_running_stats(model) if cfg.bn_schedule else None
        logits, end_points = model(points, training=True,
                                   generator=dropout_generator)
        loss = pointnet_loss(logits, labels, end_points, mesh=state.mesh)
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


def correct_counts(ok_fn, test_data, batch_size: int, *, device,
                   mesh: Mesh | None = None, num_classes: int = 0
                   ) -> np.ndarray:
    """[correct, seen] per class (one class where num_classes is 0) over
    every test cloud: padded batches of `batch_size` (the tail's padding
    left out), each rank scoring its rows with ok_fn(points, labels) -> [b]
    bool; the integer counts are summed over the ranks."""
    data, labels = test_data
    n = max(num_classes, 1)
    counts = torch.zeros((2, n), dtype=torch.int64, device=device)
    for bx, by, real in iterate_batches_padded(data, labels, batch_size):
        rows = batch_rows(mesh, len(by))
        x, y = _to_device(bx[rows], by[rows], device)
        ok = ok_fn(x, y)
        kept = torch.arange(rows.start, rows.stop, device=device) < real
        cls = (y if num_classes else torch.zeros_like(y))[kept]
        counts[0] += torch.bincount(cls[ok[kept]], minlength=n)
        counts[1] += torch.bincount(cls, minlength=n)
    if mesh is not None:
        all_reduce_(counts, mesh)
    return counts.cpu().numpy()


def evaluate_classifier(eval_step, state, test_data, batch_size: int, *,
                        device, mesh: Mesh | None = None) -> float:
    """Accuracy over every test cloud: the tail batch is padded, then
    sliced, so the result does not depend on batch_size (nor on the
    ranks of `mesh`, each scoring its rows of every batch)."""
    correct, seen = correct_counts(
        lambda x, y: eval_step(state, x, y)[1], test_data, batch_size,
        device=device, mesh=mesh)[:, 0]
    return float(correct) / float(seen)


def _data_parallel(model, state: TrainState, mesh: Mesh | None) -> None:
    """The loops' set-up under a mesh: the state under it, every rank
    holding rank 0's parameters and buffers, and under a model axis each
    rank its blocks of the sharded ones (parallel/mesh.py::shard_params,
    the Adam moments beside them)."""
    if mesh is not None:
        data_parallel(state, mesh)
        shard_params(mesh, state)


def _epoch_means(agg: dict[str, list], mesh: Mesh | None) -> dict:
    """Each metric's mean over the epoch's steps and over the ranks."""
    means = {k: torch.stack(v).mean() for k, v in agg.items()}
    return {k: float(v) for k, v in global_mean(means, mesh).items()}


def train_classifier_loop(model, state, cfg: ClassifierConfig, train_data,
                          test_data, *, epochs: int, logger, device,
                          seed: int = 0, steps_per_epoch: int | None = None,
                          epoch_callback=None, mesh: Mesh | None = None):
    """Epochs of shuffled train batches (RandomState(0), as in JAX), each
    followed by the test accuracy. Augmentation draws from a generator
    seeded `seed`, dropout from one seeded `seed + 1`. With a `mesh`
    (cfg.batch_size the global batch) each rank trains on its rows of
    every batch; the metrics and accuracy are the global ones."""
    _data_parallel(model, state, mesh)
    train_step = make_classifier_train_step(model, cfg)
    eval_step = make_classifier_eval_step(model)
    data, labels = train_data
    np_rng = np.random.RandomState(0)
    generator = torch.Generator(device=device).manual_seed(seed)
    dropout_generator = torch.Generator(device=device).manual_seed(seed + 1)
    for epoch in range(epochs):
        agg: dict[str, list] = {"loss": [], "train_acc": []}
        for bi, (bx, by) in enumerate(iterate_batches(
                data, labels, cfg.batch_size, rng=np_rng)):
            if steps_per_epoch is not None and bi >= steps_per_epoch:
                break
            loss, acc = train_step(
                state, *_to_device(*shard_batch(mesh, (bx, by)), device),
                generator, dropout_generator)
            agg["loss"].append(loss)
            agg["train_acc"].append(acc)
        means = _epoch_means(agg, mesh)
        loss, train_acc = means["loss"], means["train_acc"]
        test_acc = evaluate_classifier(eval_step, state, test_data,
                                       cfg.batch_size, device=device,
                                       mesh=mesh)
        logger.log(f"epoch {epoch}: loss={loss:.4f} "
                   f"train_acc={train_acc:.4f} test_acc={test_acc:.4f}")
        logger.metrics(state.step, loss=loss, train_acc=train_acc,
                       test_acc=test_acc)
        if epoch_callback is not None:
            epoch_callback(epoch, state, test_acc)
    return state


def create_samplenet_state(scfg: SampleNetConfig, *, device="cuda",
                           seed: int = 0) -> tuple[SampleNet, TrainState]:
    """The classification-track sampler (sigma = t^2, no clamp; bf16
    compute with `bf16`) with flax-style initialisation from `seed`, and
    its guarded Adam."""
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
        dtype=torch.bfloat16 if scfg.bf16 else None,
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
    each a 0-d tensor on the points' device; updates state in place. Under
    `state.mesh`, points and labels are this rank's rows and the metrics
    its share's."""
    freeze(classifier)

    def step(state: TrainState, points: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator | None = None) -> dict:
        if augment_data:
            points = augment.augment_for_classification(generator, points,
                                                        state.mesh)
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
                       device, mesh: Mesh | None = None) -> float:
    """Accuracy over every test cloud (pad-and-slice; under `mesh` each
    rank scores its rows of every batch)."""
    correct, seen = correct_counts(
        lambda x, y: eval_step(state, x, y), test_data, batch_size,
        device=device, mesh=mesh)[:, 0]
    return float(correct) / float(seen)


def per_class_accuracy(eval_step, state, test_data, batch_size: int,
                       num_classes: int, *, device,
                       mesh: Mesh | None = None) -> np.ndarray:
    """Per-class accuracy table (evaluate_samplenet.py:273-277)."""
    correct, seen = correct_counts(
        lambda x, y: eval_step(state, x, y), test_data, batch_size,
        device=device, mesh=mesh, num_classes=num_classes)
    return correct / np.maximum(seen, 1)


def train_samplenet_loop(sampler, state, scfg: SampleNetConfig, classifier,
                         train_data, test_data, *, epochs: int, logger,
                         device, seed: int = 0,
                         steps_per_epoch: int | None = None,
                         start_epoch: int = 0, epoch_callback=None,
                         mesh: Mesh | None = None):
    """Epochs of shuffled train batches (RandomState(start_epoch)), each
    followed by the eval accuracy; with a `mesh` (scfg.batch_size the
    global batch) as train_classifier_loop runs it."""
    _data_parallel(sampler, state, mesh)
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
            metrics = train_step(
                state, *_to_device(*shard_batch(mesh, (bx, by)), device),
                generator)
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
        means = _epoch_means(agg, mesh)
        test_acc = evaluate_samplenet(eval_step, state, test_data,
                                      scfg.batch_size, device=device,
                                      mesh=mesh)
        logger.log(f"epoch {epoch}: " +
                   " ".join(f"{k}={v:.4f}" for k, v in means.items()) +
                   f" eval_acc@{scfg.num_out_points}={test_acc:.4f}")
        logger.metrics(state.step, eval_acc=test_acc, **means)
        if epoch_callback is not None:
            epoch_callback(epoch, state, test_acc)
    return state
