"""The port's Chamfer distance, sampling losses and frozen classifier
against the JAX package on the CPU.

`nn_distance` (both NN directions through `nn_direction`'s plain version,
distances recomputed through the gather) against JAX's `nn_distance`:
values, indices and the VJP for seeded cotangents; `simplification_loss`
and its gradient; the vanilla `PointNetClassifier`'s eval logits on
weights carried over by `pointnet_state_dict_from_jax`.

The pairwise primitives (|x|^2 + |y|^2 - 2xy, chunked NN and k-NN)
against JAX's, at atol 1e-5 (the expansion cancels to that), indices
exact where the sorted distances are > 1e-4 relative apart.

Tolerances: distances rtol 1e-5 / atol 1e-6 and indices exact (no near
ties at these sizes: each cloud's 1st and 2nd NN distances are checked
to differ by > 1e-4 relative); gradients rtol 1e-5 / atol 1e-6; logits
rtol 1e-4 / atol 1e-5 (a 1024-wide chain, matmuls in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.models import losses as jax_losses
from samplenet_tpu.models.pointnet_cls import (
    PointNetClassifier as JaxPointNetClassifier,
)
from samplenet_tpu.models.pointnet_cls import (
    classification_loss as jax_classification_loss,
)
from samplenet_tpu.ops.chamfer import chamfer_loss as jax_chamfer_loss
from samplenet_tpu.ops import pairwise as jax_pairwise
from samplenet_tpu.ops.chamfer import nn_distance as jax_nn_distance
from samplenet_tpu_torch.interop import pointnet_state_dict_from_jax
from samplenet_tpu_torch.models import PointNetClassifier
from samplenet_tpu_torch.models.losses import (
    projection_loss,
    simplification_loss,
)
from samplenet_tpu_torch.models.pointnet_cls import (
    classification_loss,
    pointnet_loss,
)
from samplenet_tpu_torch.ops import pairwise
from samplenet_tpu_torch.ops.chamfer import chamfer_loss, nn_distance

torch.set_num_threads(1)


def _clouds(seed, b=3, n=150, m=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, m, 3).astype(np.float32),
            rng.randn(b, n, 3).astype(np.float32))


def _no_near_ties(x, y):
    d = np.sort(((x[:, :, None] - y[:, None]) ** 2).sum(-1).astype(
        np.float64), -1)
    return bool(((d[..., 1] - d[..., 0]) > 1e-4 * d[..., 1]).all())


def test_nn_distance_values_and_vjp_match_jax():
    x, y = _clouds(0)
    assert _no_near_ties(x, y) and _no_near_ties(y, x)
    rng = np.random.RandomState(1)
    g1 = rng.randn(*x.shape[:2]).astype(np.float32)
    g2 = rng.randn(*y.shape[:2]).astype(np.float32)
    want = jax_nn_distance(jnp.asarray(x), jnp.asarray(y))

    def f(a, b):
        d1, _, d2, _ = jax_nn_distance(a, b)
        return jnp.sum(d1 * g1) + jnp.sum(d2 * g2)

    jgx, jgy = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    d1, i1, d2, i2 = nn_distance(xt, yt)
    for got, w in ((d1, want[0]), (d2, want[2])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    for got, w in ((i1, want[1]), (i2, want[3])):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    ((d1 * torch.from_numpy(g1)).sum()
     + (d2 * torch.from_numpy(g2)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jgy), rtol=1e-5,
                               atol=1e-6)


def test_non_finite_cloud_gives_non_finite_distance():
    x, y = _clouds(2)
    x[1, 3] = np.nan
    d1, _, d2, _ = nn_distance(torch.from_numpy(x), torch.from_numpy(y))
    assert not bool(torch.isfinite(d1[1]).all())
    assert bool(torch.isfinite(d1[0]).all() and torch.isfinite(d1[2]).all())


@pytest.mark.parametrize("gamma,delta", [(1.0, 0.0), (0.5, 1.0 / 30)])
def test_simplification_loss_and_gradient_match_jax(gamma, delta):
    samp, ref = _clouds(3)
    want, jg = jax.value_and_grad(
        lambda s: jax_losses.simplification_loss(jnp.asarray(ref), s, 16,
                                                 gamma, delta))(
        jnp.asarray(samp))
    st = torch.tensor(samp, requires_grad=True)
    got = simplification_loss(torch.from_numpy(ref), st, 16, gamma, delta)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    s = torch.tensor(0.25, requires_grad=True)
    assert projection_loss(s) is s


def test_chamfer_loss_matches_jax():
    x, y = _clouds(4)
    np.testing.assert_allclose(
        float(chamfer_loss(torch.from_numpy(x), torch.from_numpy(y))),
        float(jax_chamfer_loss(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)


@pytest.fixture(scope="module")
def classifier():
    rng = np.random.RandomState(5)
    x = rng.randn(4, 32, 3).astype(np.float32)
    net = JaxPointNetClassifier(num_classes=10)
    v = net.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)
    v = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape)
                     .astype(np.float32), v)
    v["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5,
                                    v["batch_stats"])
    return net, v, x


def test_classifier_logits_match_jax(classifier):
    net, v, x = classifier
    want, ends = net.apply(v, jnp.asarray(x), training=False)
    port = PointNetClassifier(10)
    port.load_state_dict({k: torch.tensor(np.array(a)) for k, a in
                          pointnet_state_dict_from_jax(v).items()})
    port.eval()
    with torch.no_grad():
        got, tends = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tends["GFV"].numpy(), np.asarray(ends["GFV"]),
                               rtol=1e-4, atol=1e-5)
    labels = np.array([0, 3, 9, 1])
    np.testing.assert_allclose(
        float(classification_loss(got, torch.from_numpy(labels))),
        float(jax_classification_loss(want, jnp.asarray(labels))),
        rtol=1e-5)
    assert float(pointnet_loss(got, torch.from_numpy(labels), tends)) == \
        float(classification_loss(got, torch.from_numpy(labels)))


def test_classifier_key_surface(classifier):
    _, v, _ = classifier
    sd = pointnet_state_dict_from_jax(v)
    assert set(sd) == set(PointNetClassifier(10).state_dict())
    assert sd["conv5.weight"].shape == (1024, 128, 1)
    assert sd["fc3.weight"].shape == (10, 256)


@pytest.mark.parametrize("chunk", [16, 512])
def test_pairwise_primitives_match_jax(chunk):
    x, y = _clouds(6, n=90, m=40)
    np.testing.assert_allclose(
        pairwise.pairwise_sqdist(torch.from_numpy(x),
                                 torch.from_numpy(y)).numpy(),
        np.asarray(jax_pairwise.pairwise_sqdist(jnp.asarray(x),
                                                jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)
    d = np.sort(((x[:, :, None] - y[:, None]) ** 2).sum(-1).astype(
        np.float64), -1)[..., :6]
    clear = ((np.diff(d, axis=-1) > 1e-4 * d[..., 1:]).all(-1))
    assert clear.mean() > 0.8
    got = pairwise.chunked_min_argmin(torch.from_numpy(x),
                                      torch.from_numpy(y), chunk=chunk)
    want = jax_pairwise.chunked_min_argmin(jnp.asarray(x), jnp.asarray(y),
                                           chunk=chunk)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy()[clear],
                                  np.asarray(want[1])[clear])
    got = pairwise.chunked_topk_neg(torch.from_numpy(x), torch.from_numpy(y),
                                    5, chunk=chunk)
    want = jax_pairwise.chunked_topk_neg(jnp.asarray(x), jnp.asarray(y), 5,
                                         chunk=chunk)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy()[clear],
                                  np.asarray(want[1])[clear])
