"""The port's approximate EMD (ops/matching.py, ops/cuda/emd_kernel.py)
against the JAX package's fused kernel in interpret mode, its XLA path and
the float64 oracle of the reference CPU op (tests/oracles.py).

On the CPU the port's `approx_emd_cost` runs the EMD kernel's plain
version: the TPU kernel's passes, d2 in broadcast-difference form. The
shapes are those of tests/test_emd_kernel.py:61-62.

Tolerances, and why:
  * cost: rtol 2e-4 against the f64 oracle, the JAX kernel's own bound
    (test_emd_kernel.py:68); against the interpreted kernel, which does
    the same arithmetic in another summation order, rtol 1e-5.
  * gradients: no further from the oracle's analytic MatchCostGrad than
    the JAX XLA path's autodiff is, or 5e-4 of the gradient's scale where
    both are that close; and no further than 1.5x the interpreted JAX
    kernel's own distance (test_emd_kernel.py:87-105). Not elementwise
    against the interpreted kernel: where the steep levels flip a
    near-tie, two f32 paths that sum in other orders drift from the f64
    match apart (by 1.5e-2 of scale at 256 x 256).
  * approx_match + match_cost (the tests' reference pair): the cost at
    rtol 2e-4 of the oracle, as the fused EMD's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.ops.matching import approx_match as jax_approx_match
from samplenet_tpu.ops.matching import match_cost as jax_match_cost
from samplenet_tpu.ops.pallas.emd_kernel import emd_cost_pallas
from samplenet_tpu_torch.ops.cuda.emd_kernel import emd_cost
from samplenet_tpu_torch.ops.matching import (
    approx_emd_cost,
    approx_match,
    emd_loss,
    match_cost,
)
from tests.oracles import approx_match_np, match_cost_np

torch.set_num_threads(1)

SHAPES = [(256, 256), (96, 160), (128, 64), (64, 128)]


def _clouds(b, n, m, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, 3).astype(np.float32),
            rng.randn(b, m, 3).astype(np.float32))


def _oracle(x1, x2):
    """(cost, g1, g2) in f64 from the oracle match."""
    x1d, x2d = x1.astype(np.float64), x2.astype(np.float64)
    match = approx_match_np(x1d, x2d)
    diff = x1d[:, :, None, :] - x2d[:, None, :, :]
    d = np.maximum(np.sqrt((diff ** 2).sum(-1)), 1e-20)
    u = match / d
    return (match_cost_np(x1d, x2d, match), (u[..., None] * diff).sum(2),
            -(u[..., None] * diff).sum(1))


@pytest.mark.parametrize("n,m", SHAPES)
def test_cost_matches_oracle_and_jax_kernel(n, m):
    x1, x2 = _clouds(2, n, m)
    oracle, _, _ = _oracle(x1, x2)
    got = approx_emd_cost(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-4)
    jk = np.asarray(emd_cost_pallas(jnp.asarray(x1), jnp.asarray(x2),
                                    with_grads=False, interpret=True)[0])
    np.testing.assert_allclose(got, jk, rtol=1e-5)


@pytest.mark.parametrize("n,m", SHAPES)
def test_gradients_at_least_as_close_to_oracle_as_xla(n, m):
    x1, x2 = _clouds(2, n, m, seed=7)
    _, ref_g1, ref_g2 = _oracle(x1, x2)
    _, g1, g2 = emd_cost(torch.from_numpy(x1), torch.from_numpy(x2))
    ad_g1, ad_g2 = jax.jit(jax.grad(
        lambda a, b: jnp.sum(jax_match_cost(a, b, jax_approx_match(a, b))),
        argnums=(0, 1)))(jnp.asarray(x1), jnp.asarray(x2))
    _, jk1, jk2 = emd_cost_pallas(jnp.asarray(x1), jnp.asarray(x2),
                                  with_grads=True, interpret=True)
    for got, ad, jk, ref in ((g1, ad_g1, jk1, ref_g1),
                             (g2, ad_g2, jk2, ref_g2)):
        scale = float(np.abs(ref).max())
        err = float(np.abs(got.numpy() - ref).max())
        xla_err = float(np.abs(np.asarray(ad) - ref).max())
        jk_err = float(np.abs(np.asarray(jk) - ref).max())
        assert err <= max(xla_err, 5e-4 * scale), (err, xla_err, scale)
        assert err <= max(1.5 * jk_err, 5e-4 * scale), (err, jk_err, scale)


def test_without_grads_the_gradients_are_zero_and_the_cost_the_same():
    x1, x2 = (torch.from_numpy(a) for a in _clouds(2, 128, 128, seed=3))
    c0, z1, z2 = emd_cost(x1, x2, with_grads=False)
    c1, g1, g2 = emd_cost(x1, x2, with_grads=True)
    assert not z1.any() and not z2.any()
    assert g1.abs().max() > 0 and g2.abs().max() > 0
    assert torch.equal(c0, c1)
    assert z1.shape == x1.shape and z2.shape == x2.shape


def test_coincident_points_stay_finite():
    pts = np.random.RandomState(11).randn(1, 64, 3).astype(np.float32)
    cost, g1, g2 = emd_cost(torch.from_numpy(pts), torch.from_numpy(pts))
    assert all(bool(torch.isfinite(t).all()) for t in (cost, g1, g2))
    assert float(cost[0]) < 1e-3 * 64      # identical clouds: ~0 transport


def test_autograd_gradient_is_the_kernel_gradient_times_the_cotangent():
    x1, x2 = (torch.from_numpy(a) for a in _clouds(2, 96, 96, seed=13))
    a, b = x1.clone().requires_grad_(True), x2.clone().requires_grad_(True)
    emd_loss(a, b).backward()                  # mean: cotangent 1/B = 0.5
    _, g1, g2 = emd_cost(x1, x2)
    assert torch.equal(a.grad, 0.5 * g1) and torch.equal(b.grad, 0.5 * g2)
    # only the cloud that needs one gets a gradient
    c = x1.clone().requires_grad_(True)
    approx_emd_cost(c, x2).sum().backward()
    assert torch.equal(c.grad, g1)


@pytest.mark.parametrize("n,m", [(96, 160), (128, 64)])
def test_approx_match_and_match_cost(n, m):
    """The reference pair: approx_match's row and column sums saturate as
    the reference's do, its cost is the oracle's, and it is also the JAX
    XLA path's up to that path's d2 identity (rtol 5e-3,
    test_emd_kernel.py:69-72)."""
    x1, x2 = _clouds(2, n, m, seed=5)
    oracle, _, _ = _oracle(x1, x2)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    match = approx_match(t1, t2)
    ref = approx_match_np(x1.astype(np.float64), x2.astype(np.float64))
    np.testing.assert_allclose(match.sum(2).numpy(), ref.sum(2), rtol=1e-3,
                               atol=1e-4)
    got = match_cost(t1, t2, match).numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-4)
    jx = np.asarray(jax_match_cost(jnp.asarray(x1), jnp.asarray(x2),
                                   jax_approx_match(jnp.asarray(x1),
                                                    jnp.asarray(x2))))
    np.testing.assert_allclose(got, jx, rtol=5e-3)


def test_match_cost_gradient_is_the_fused_gradient():
    """Autograd through match_cost with approx_match's weights gives the
    analytic MatchCostGrad that the fused EMD returns. Both run in f64, so
    the matches agree to round-off; the cost at rtol 1e-9, the gradients,
    which the fused EMD sums level by level and autograd over the summed
    match, at an atol of 1e-8 of their scale (cancellation among the
    sums' terms leaves a few entries 2e-10 apart)."""
    x1, x2 = (torch.from_numpy(a).double()
              for a in _clouds(2, 96, 64, seed=17))
    a, b = x1.clone().requires_grad_(True), x2.clone().requires_grad_(True)
    match_cost(a, b, approx_match(a, b)).sum().backward()
    cost, g1, g2 = emd_cost(x1, x2)
    np.testing.assert_allclose(
        match_cost(x1, x2, approx_match(x1, x2)).numpy(), cost.numpy(),
        rtol=1e-9)
    for got, want in ((a.grad, g1), (b.grad, g2)):
        np.testing.assert_allclose(
            got.numpy(), want.numpy(), rtol=0,
            atol=1e-8 * float(want.abs().max()))
