"""Train state and optimiser assembly.

Mirrors samplenet_tpu/train/state.py:
  * `staircase_lr`: exponential staircase decay counted in samples, with a
    1e-5 floor (classification/train_samplenet.py:113-122);
  * `adam_with_schedule`: optax.adam's rule as torch.optim.Adam (b1 0.9,
    b2 0.999, eps 1e-8), the lr set before each step from the schedule
    at the optimiser's own count of applied steps, which is what optax's
    count is under apply_if_finite;
  * `with_nonfinite_guard`: a step whose gradients hold a NaN or inf is
    skipped (no update, the count does not move); the 5th in a row raises.
    Under a data-parallel mesh (parallel/mesh.py::data_parallel) it first
    averages the gradients over the ranks, so every rank reads the same
    gradients and makes the same decision;
  * `bn_decay_schedule` / `scheduled_bn_update`: the TF-style BN decay,
    applied to running statistics that the model computed with momentum 0;
  * `TrainState`: the step, the model and its optimiser. The step counts
    every train step, skipped or not, as the JAX TrainState's does; its
    `mesh` is the optimiser's.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterable
from dataclasses import dataclass

import torch
from torch import nn

from samplenet_tpu_torch.parallel.mesh import average_gradients

Schedule = Callable[[int], float]


def staircase_lr(base_lr: float, batch_size: int,
                 decay_step_samples: float = 200000.0,
                 decay_rate: float = 0.7, floor: float = 1e-5) -> Schedule:
    """lr(count) = max(base_lr * decay_rate ** (count // steps_per_decay),
    floor), steps_per_decay = decay_step_samples / batch_size."""
    steps_per_decay = max(int(decay_step_samples / batch_size), 1)
    return lambda count: max(
        base_lr * decay_rate ** (count // steps_per_decay), floor)


class ScheduledAdam:
    """torch.optim.Adam whose lr before each step is schedule(count), with
    count the number of steps applied so far."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule):
        self.schedule = schedule
        self.count = 0
        self.params = [p for p in params if p.requires_grad]
        self.optimizer = torch.optim.Adam(
            self.params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.count)
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adam": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        self.optimizer.load_state_dict(sd["adam"])


class NonFiniteGuard:
    """Skips a step whose gradients are not all finite; raises
    FloatingPointError at the `max_consecutive_errors`-th in a row."""

    def __init__(self, inner: ScheduledAdam, max_consecutive_errors: int = 5):
        self.inner = inner
        self.max_consecutive_errors = max_consecutive_errors
        self.notfinite_count = 0
        self.total_notfinite = 0
        self.mesh = None

    @property
    def params(self) -> list[torch.Tensor]:
        return self.inner.params

    @property
    def count(self) -> int:
        return self.inner.count

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    def step(self) -> bool:
        """True where the update was applied. Reads one flag from the
        device. Under a mesh the gradients are first averaged over the
        ranks."""
        if self.mesh is not None:
            average_gradients(self.params, self.mesh)
        grads = [p.grad for p in self.params if p.grad is not None]
        finite = bool(torch.stack(
            [torch.isfinite(g).all() for g in grads]).all()) if grads else True
        if finite:
            self.notfinite_count = 0
            self.inner.step()
            return True
        self.notfinite_count += 1
        self.total_notfinite += 1
        if self.notfinite_count >= self.max_consecutive_errors:
            raise FloatingPointError(
                f"{self.notfinite_count} train steps in a row had non-finite "
                f"gradients")
        return False

    def state_dict(self) -> dict:
        return {**self.inner.state_dict(),
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd)
        self.notfinite_count = int(sd["notfinite_count"])
        self.total_notfinite = int(sd["total_notfinite"])


def with_nonfinite_guard(optimizer: ScheduledAdam,
                         max_consecutive_errors: int = 5) -> NonFiniteGuard:
    return NonFiniteGuard(optimizer, max_consecutive_errors)


def adam_with_schedule(params: Iterable[torch.Tensor],
                       schedule: Schedule) -> NonFiniteGuard:
    """Adam on `params` (those with requires_grad) under `schedule`,
    guarded against non-finite gradients, as every trainer of the JAX
    package runs it."""
    return with_nonfinite_guard(ScheduledAdam(params, schedule))


def bn_decay_schedule(step: int, batch_size: int, *,
                      init_decay: float = 0.5, decay_rate: float = 0.5,
                      decay_step_samples: float = 200000.0,
                      clip: float = 0.99) -> float:
    """The reference's BN decay (classification/train_samplenet.py:124-133):
    min(clip, 1 - init_decay * decay_rate ** floor(samples / decay_step))."""
    staircase = math.floor(step * batch_size / decay_step_samples)
    return min(clip, 1.0 - init_decay * decay_rate ** staircase)


def bn_running_stats(model: nn.Module) -> dict[str, torch.Tensor]:
    """Copies of every running_mean / running_var buffer of `model`."""
    return {k: v.detach().clone() for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def scheduled_bn_update(old_stats: dict[str, torch.Tensor],
                        batch_stats: dict[str, torch.Tensor],
                        decay: float) -> dict[str, torch.Tensor]:
    """decay * old + (1 - decay) * batch, per statistic: the running
    average with a step-dependent decay, for a model whose BatchNorms ran
    with momentum 0 (so their buffers hold the batch statistics)."""
    return {k: decay * old_stats[k] + (1.0 - decay) * batch_stats[k]
            for k in old_stats}


@dataclass
class TrainState:
    model: nn.Module
    optimizer: NonFiniteGuard
    step: int = 0

    @property
    def mesh(self):
        """The data-parallel mesh the state trains under, or None."""
        return self.optimizer.mesh
