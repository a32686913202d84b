"""The port's optimiser, schedules, data and augmentation against the JAX
package on the CPU.

`staircase_lr` against optax's schedule at several counts; Adam against
optax.adam on identical gradients for 3 steps; the non-finite guard (a
NaN step is skipped and does not advance the schedule's count, the 5th
in a row raises); `bn_decay_schedule` and `scheduled_bn_update`; the
procedural dataset and the batch iterators bit for bit; the on-device
augmentation's invariants.

Tolerances: the schedules rtol 1e-6 (optax computes them in f32, the
port in f64); Adam's parameters rtol 1e-6 / atol 1e-7 (one rounding of
the update rule apart).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from samplenet_tpu.data import iterate_batches as jax_iterate_batches
from samplenet_tpu.data import (
    iterate_batches_padded as jax_iterate_batches_padded,
)
from samplenet_tpu.data import make_dataset as jax_make_dataset
from samplenet_tpu.train import state as jax_state
from samplenet_tpu_torch.data import (
    iterate_batches,
    iterate_batches_padded,
    make_dataset,
)
from samplenet_tpu_torch.data.augment import (
    augment_for_classification,
    jitter,
    rotate_y,
)
from samplenet_tpu_torch.train import state

torch.set_num_threads(1)


@pytest.mark.parametrize("count", [0, 1, 37, 38, 39, 500, 10_000])
def test_staircase_lr_matches_optax(count):
    want = jax_state.staircase_lr(0.01, 32, decay_step_samples=1200.0,
                                  decay_rate=0.7)(jnp.asarray(count))
    got = state.staircase_lr(0.01, 32, decay_step_samples=1200.0,
                             decay_rate=0.7)(count)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)


def test_adam_matches_optax_for_three_steps():
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 4).astype(np.float32)
    grads = [rng.randn(5, 4).astype(np.float32) for _ in range(3)]
    sched = state.staircase_lr(0.01, 8, decay_step_samples=16.0,
                               decay_rate=0.5)
    tx = jax_state.adam_with_schedule(jax_state.staircase_lr(
        0.01, 8, decay_step_samples=16.0, decay_rate=0.5))
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = state.adam_with_schedule([w], sched)
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        w.grad = torch.from_numpy(g.copy())
        assert opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)
    assert opt.count == 3


def test_nonfinite_guard_skips_and_then_raises():
    w = torch.nn.Parameter(torch.ones(3))
    opt = state.adam_with_schedule([w], lambda count: 0.1 * (count + 1))
    w.grad = torch.tensor([1.0, 1.0, 1.0])
    assert opt.step() and opt.count == 1
    before = w.detach().clone()
    for i in range(4):
        w.grad = torch.tensor([1.0, float("nan"), 1.0])
        assert not opt.step()                      # skipped
        assert torch.equal(w.detach(), before) and opt.count == 1
    w.grad = torch.tensor([1.0, 1.0, 1.0])
    assert opt.step() and opt.count == 2           # the streak resets
    # lr of the 2nd applied step is schedule(1) = 0.2: count moved once
    for i in range(4):
        w.grad = torch.tensor([float("inf"), 0.0, 0.0])
        assert not opt.step()
    w.grad = torch.tensor([float("inf"), 0.0, 0.0])
    with pytest.raises(FloatingPointError):
        opt.step()
    sd = opt.state_dict()
    assert sd["count"] == 2 and sd["total_notfinite"] == 9


@pytest.mark.parametrize("step", [0, 1, 6250, 6251, 20000, 10 ** 6])
def test_bn_decay_schedule_matches_jax(step):
    want = jax_state.bn_decay_schedule(jnp.asarray(step, jnp.int32), 32)
    np.testing.assert_allclose(state.bn_decay_schedule(step, 32),
                               float(want), rtol=1e-6)


def test_scheduled_bn_update_matches_jax():
    rng = np.random.RandomState(1)
    old = {"bn1.running_mean": rng.randn(4).astype(np.float32),
           "bn1.running_var": rng.rand(4).astype(np.float32)}
    new = {k: rng.randn(4).astype(np.float32) for k in old}
    want = jax_state.scheduled_bn_update(old, new, jnp.float32(0.75))
    got = state.scheduled_bn_update(
        {k: torch.from_numpy(v) for k, v in old.items()},
        {k: torch.from_numpy(v) for k, v in new.items()}, 0.75)
    for k in old:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    net = torch.nn.BatchNorm1d(3)
    assert set(state.bn_running_stats(net)) == {"running_mean",
                                                "running_var"}


def test_procedural_dataset_and_batches_match_jax_bit_for_bit():
    data, labels = make_dataset(30, 64, seed=3)
    jdata, jlabels = jax_make_dataset(30, 64, seed=3)
    assert data.dtype == np.float32 and labels.dtype == np.int32
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(labels, jlabels)
    for got, want in zip(
            iterate_batches(data, labels, 8,
                            rng=np.random.RandomState(2)),
            jax_iterate_batches(jdata, jlabels, 8,
                                rng=np.random.RandomState(2)), strict=True):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for got, want in zip(iterate_batches_padded(data, labels, 8),
                         jax_iterate_batches_padded(jdata, jlabels, 8),
                         strict=True):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_rotation_keeps_up_axis_and_norms():
    x = torch.from_numpy(np.random.RandomState(4).randn(6, 50, 3)
                         .astype(np.float32))
    r = rotate_y(torch.Generator().manual_seed(0), x)
    np.testing.assert_array_equal(r[..., 1].numpy(), x[..., 1].numpy())
    np.testing.assert_allclose(r.norm(dim=-1).numpy(),
                               x.norm(dim=-1).numpy(), rtol=1e-5)
    assert not torch.allclose(r, x)


def test_jitter_is_clipped_and_augment_is_seeded():
    x = torch.zeros(4, 2000, 3)
    noise = jitter(torch.Generator().manual_seed(1), x, sigma=0.05)
    clip = torch.tensor(0.05)                      # f32
    assert bool(noise.abs().max() <= clip)
    assert float((noise.abs() == clip).float().mean()) > 0.2  # clipped
    a = augment_for_classification(torch.Generator().manual_seed(7), x + 1)
    b = augment_for_classification(torch.Generator().manual_seed(7), x + 1)
    assert torch.equal(a, b)
    assert float((a - (x + 1)).abs().max()) > 0.05
