"""The order the EMD kernel takes its clouds in (ops/cuda/emd_kernel.py):
each cloud sorted by Morton code, the gradients put back in the callers'
order. It runs around the kernel on every CUDA call; here it runs around
the kernel's plain version, on the CPU.

Tolerances, on the inputs of tests/test_torch_port_recon_emd.py (seed 0
for the cost, 7 for the gradients) and as there: the cost through the
order against the plain version without it (the same arithmetic, summed
in another order) and against the JAX package's fused kernel in
interpret mode at rtol 1e-5, against the f64 oracle at rtol 2e-4; the
gradients as the card tests hold the kernel (see the test). The steep
levels turn summation order
into other near-tie matches: on other seeds any two f32 orders, the
plain version and the interpreted JAX kernel among them, land up to
4e-4 apart in the cost (256 x 256, seed 512), so two f32 paths are never
held to each other elementwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.ops.pallas.emd_kernel import emd_cost_pallas
from samplenet_tpu_torch.ops.cuda import emd_kernel as ek
from tests.oracles import approx_match_np, match_cost_np

torch.set_num_threads(1)

# the shapes and inputs of tests/test_torch_port_recon_emd.py
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


def test_spread_bits_puts_each_bit_three_apart():
    v = torch.arange(1 << ek.MORTON_BITS)
    want = sum(((v >> i) & 1) << (3 * i) for i in range(ek.MORTON_BITS))
    assert torch.equal(ek._spread_bits(v), want)


@pytest.mark.parametrize("b,n", [(1, 1), (2, 37), (3, 256), (2, 2048)])
def test_morton_order_is_a_stable_bijection(b, n):
    x = torch.from_numpy(_clouds(b, n, 1, seed=n)[0])
    # every point twice, the copies far apart in index: equal codes
    x = torch.cat([x, x], dim=1)
    order = ek.morton_order(x)
    assert order.dtype == torch.int64 and order.shape == (b, 2 * n)
    assert torch.equal(order.sort(dim=1).values,
                       torch.arange(2 * n).expand(b, -1))
    codes = torch.gather(ek.morton_codes(x), 1, order)
    assert bool((codes[:, 1:] >= codes[:, :-1]).all())
    tie = codes[:, 1:] == codes[:, :-1]
    assert bool((order[:, 1:] > order[:, :-1])[tie].all())  # index order


def test_morton_order_keeps_octants_together():
    """The top bits of a code are the point's octant of the bounding
    cube, so the order runs through the octants one at a time."""
    rng = np.random.RandomState(3)
    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)], dtype=np.float32)
    which = rng.randint(0, 8, size=400)
    x = corners[which] + 0.1 * rng.rand(400, 3).astype(np.float32)
    order = ek.morton_order(torch.from_numpy(x)[None])[0].numpy()
    runs = np.count_nonzero(np.diff(which[order])) + 1
    assert runs == 8
    assert list(dict.fromkeys(which[order])) == [0, 1, 2, 3, 4, 5, 6, 7]


def test_morton_codes_take_non_finite_points():
    x = torch.from_numpy(_clouds(1, 20, 1, seed=1)[0])
    x[0, 3, 1] = float("nan")
    x[0, 7, 0] = float("inf")
    order = ek.morton_order(x)
    assert torch.equal(order.sort(dim=1).values, torch.arange(20)[None])


@pytest.mark.parametrize("b,n", [(1, 5), (3, 130)])
def test_put_rows_inverts_take_rows(b, n):
    x = torch.from_numpy(_clouds(b, n, 1, seed=b + n)[0])
    order = ek.morton_order(x)
    taken = ek.take_rows(x, order)
    assert not torch.equal(taken, x)
    assert torch.equal(ek.put_rows(taken, order), x)
    assert torch.equal(ek.take_rows(ek.put_rows(x, order), order), x)


@pytest.mark.parametrize("n,m", SHAPES)
def test_cost_through_the_order_matches_plain_and_jax_kernel(n, m):
    x1, x2 = _clouds(2, n, m)
    oracle, _, _ = _oracle(x1, x2)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    cost, _, _ = ek.in_morton_order(ek.emd_cost_plain, t1, t2, False)
    plain, _, _ = ek.emd_cost_plain(t1, t2, False)
    np.testing.assert_allclose(cost.numpy(), plain.numpy(), rtol=1e-5)
    np.testing.assert_allclose(cost.numpy(), oracle, rtol=2e-4)
    jk = np.asarray(emd_cost_pallas(jnp.asarray(x1), jnp.asarray(x2),
                                    with_grads=False, interpret=True)[0])
    np.testing.assert_allclose(cost.numpy(), jk, rtol=1e-5)


def _ulp_moves(x, rng):
    """x with each element moved by at most one ulp, at random."""
    step = rng.integers(-1, 2, x.shape)
    return np.where(step > 0, np.nextafter(x, np.float32(np.inf)),
                    np.where(step < 0, np.nextafter(x, np.float32(-np.inf)),
                             x)).astype(np.float32)


@pytest.mark.parametrize("n,m", SHAPES)
def test_gradients_through_the_order_as_close_as_plain_and_jax_kernel(n, m):
    """As tests/test_torch_port_cuda.py holds the kernel: over the input
    and three copies moved by one ulp, each path against the oracle on
    that input, the worst largest-entry error (a share of the oracle's
    scale) and norm-wise error through the order at most 1.5x the plain
    version's worst without it and 1.5x the interpreted JAX kernel's, or
    5e-4: one ulp moves a near-tie, and which f32 order lands further
    from f64 on one input is chance."""
    x1, x2 = _clouds(2, n, m, seed=7)
    rng = np.random.default_rng(n + m)
    worst = np.zeros((3, 2, 2))  # [path][gradient] = (largest, norm-wise)
    for moved in range(4):
        a, c = (x1, x2) if moved == 0 else (_ulp_moves(x1, rng),
                                            _ulp_moves(x2, rng))
        _, r1, r2 = _oracle(a, c)
        ta, tc = torch.from_numpy(a), torch.from_numpy(c)
        paths = (ek.in_morton_order(ek.emd_cost_plain, ta, tc)[1:],
                 ek.emd_cost_plain(ta, tc)[1:],
                 emd_cost_pallas(jnp.asarray(a), jnp.asarray(c),
                                 with_grads=True, interpret=True)[1:])
        for i, grads in enumerate(paths):
            for j, (h, r) in enumerate(zip(grads, (r1, r2))):
                d = np.asarray(h, dtype=np.float64) - r
                worst[i, j] = np.maximum(worst[i, j], (
                    np.abs(d).max() / np.abs(r).max(),
                    np.linalg.norm(d) / np.linalg.norm(r)))
    assert (worst[0] <= np.maximum(1.5 * worst[1], 5e-4)).all(), worst
    assert (worst[0] <= np.maximum(1.5 * worst[2], 5e-4)).all(), worst


def test_the_order_moves_the_gradients_with_their_points():
    """A permutation of the inputs permutes the gradients the same way:
    the order is computed from the points, not their indices."""
    x1, x2 = (torch.from_numpy(a) for a in _clouds(1, 80, 60, seed=9))
    p1, p2 = torch.randperm(80), torch.randperm(60)
    c, g1, g2 = ek.in_morton_order(ek.emd_cost_plain, x1, x2)
    cp, h1, h2 = ek.in_morton_order(ek.emd_cost_plain, x1[:, p1], x2[:, p2])
    assert torch.equal(c, cp)
    assert torch.equal(h1, g1[:, p1]) and torch.equal(h2, g2[:, p2])


def test_without_grads_the_order_gives_zeros_and_the_same_cost():
    x1, x2 = (torch.from_numpy(a) for a in _clouds(2, 70, 90, seed=4))
    c0, z1, z2 = ek.in_morton_order(ek.emd_cost_plain, x1, x2, False)
    c1, g1, g2 = ek.in_morton_order(ek.emd_cost_plain, x1, x2, True)
    assert torch.equal(c0, c1)
    assert not z1.any() and not z2.any()
    assert z1.shape == x1.shape and z2.shape == x2.shape
    assert g1.abs().max() > 0 and g2.abs().max() > 0

