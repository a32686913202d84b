"""The port's soft projection against the JAX package on the CPU.

`soft_project` (its plain version on a CPU tensor) against the Pallas
kernel `fused_soft_projection` in interpret mode and against JAX's XLA
`SoftProjection.project`, for k in {1, 7, 16}; its gradients to the
points, the queries and sigma^2 against JAX's VJP of `soft_project`.

Indices are compared as sets, and only on queries whose k-th and
(k+1)-th distances lie more than 1e-4 (relative) apart: XLA:CPU contracts
the distances into FMAs and the XLA path takes them as |x|^2 + |y|^2 -
2xy, so a nearer tie may resolve either way. Outputs: rtol 1e-5 /
atol 1e-6 on those queries. Gradients: rtol 1e-4 / atol 1e-5 (the sums
over k and, for sigma^2, over every query run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.models.soft_projection import (
    SoftProjection as JaxSoftProjection,
)
from samplenet_tpu.ops.pallas.soft_projection_kernel import (
    fused_soft_projection,
)
from samplenet_tpu.ops.pallas.soft_projection_kernel import (
    soft_project as jax_soft_project,
)
from samplenet_tpu_torch.models import SoftProjection
from samplenet_tpu_torch.ops.cuda import soft_project

torch.set_num_threads(1)

GAP = 1e-4


def _clouds(seed, b=3, n=200, m=21):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, 3).astype(np.float32),
            rng.randn(b, m, 3).astype(np.float32))


def _clear(points, queries, k):
    """[B, M] bool: the k-th and (k+1)-th distances are > GAP apart."""
    d = ((queries[:, :, None, :] - points[:, None, :, :]) ** 2).sum(-1)
    d = np.sort(d.astype(np.float64), axis=-1)
    return (d[..., k] - d[..., k - 1]) > GAP * np.maximum(d[..., k], 1e-12)


@pytest.mark.parametrize("k", [1, 7, 16])
def test_forward_matches_interpreted_kernel_and_xla(k):
    pts, qs = _clouds(k)
    sigma = np.float32(0.5)
    out, idx = soft_project(torch.from_numpy(pts), torch.from_numpy(qs),
                            torch.tensor(sigma), k)
    j_out, j_idx = fused_soft_projection(
        jnp.asarray(pts), jnp.asarray(qs), jnp.asarray(sigma), group_size=k,
        interpret=True)
    proj = JaxSoftProjection(group_size=k, sigma_mode="tf",
                             initial_temperature=float(np.sqrt(sigma)),
                             use_pallas=False)
    v = proj.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(qs))
    x_out, _, _ = proj.apply(v, jnp.asarray(pts), jnp.asarray(qs),
                             method=JaxSoftProjection.project)
    clear = _clear(pts, qs, k)
    assert clear.mean() > 0.9
    assert idx.dtype == torch.int32 and idx.shape == (3, 21, k)
    for bi, mi in zip(*np.nonzero(clear)):
        assert set(idx[bi, mi].tolist()) == set(np.asarray(j_idx)[bi, mi])
    # ascending order, ties to the lowest index
    d = ((torch.from_numpy(qs)[:, :, None] - torch.from_numpy(pts)[:, None])
         ** 2).sum(-1)
    dk = torch.gather(d, 2, idx.long())
    assert bool((dk[..., 1:] >= dk[..., :-1]).all())
    for want in (j_out, x_out):
        np.testing.assert_allclose(out.numpy()[clear],
                                   np.asarray(want)[clear], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("k", [1, 7, 16])
def test_gradients_match_jax_vjp(k):
    pts, qs = _clouds(10 + k)
    sigma = np.float32(0.3)
    cot = np.random.RandomState(20 + k).randn(*qs.shape).astype(np.float32)

    def f(p, q, s):
        return jnp.sum(jax_soft_project(p, q, s, k, 128, True) * cot)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(pts), jnp.asarray(qs),
                                          jnp.asarray(sigma))
    p = torch.tensor(pts, requires_grad=True)
    q = torch.tensor(qs, requires_grad=True)
    s = torch.tensor(sigma, requires_grad=True)
    out, _ = soft_project(p, q, s, k)
    (out * torch.from_numpy(cot)).sum().backward()
    for got, w in zip((p.grad, q.grad, s.grad), want):
        assert got.shape == np.asarray(w).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_low_sigma_approaches_nn():
    """At sigma^2 = 1e-4 the unshifted weights would underflow; the d_0
    shift keeps the output the nearest point."""
    rng = np.random.RandomState(2)      # test_pallas_kernels.py:54-63
    pts = rng.randn(1, 32, 3).astype(np.float32)
    qs = rng.randn(1, 16, 3).astype(np.float32)
    out, idx = soft_project(torch.from_numpy(pts), torch.from_numpy(qs),
                            torch.tensor(1e-4), 4)
    assert bool(torch.isfinite(out).all())
    nn = np.take_along_axis(pts, idx[..., 0].long().numpy()[..., None], 1)
    np.testing.assert_allclose(out.numpy(), nn, atol=1e-3)


def test_module_project_and_group_weights_match_jax():
    pts, qs = _clouds(40, m=9)
    proj = JaxSoftProjection(group_size=5, sigma_mode="tf",
                             initial_temperature=0.8, use_pallas=False)
    v = proj.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(qs))
    want, _, _ = proj.apply(v, jnp.asarray(pts), jnp.asarray(qs),
                            method=JaxSoftProjection.project)
    port = SoftProjection(5, initial_temperature=0.8, sigma_mode="tf")
    got, w_none, d_none = port.project(torch.from_numpy(pts),
                                       torch.from_numpy(qs))
    assert w_none is None and d_none is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    got.sum().backward()        # the temperature trains through it
    assert port._temperature.grad is not None

    def group_weights(mod, p, q):
        g, _ = mod._group(p, q)
        return (g, *mod._weights(g, q))

    jg, jw, jd = proj.apply(v, jnp.asarray(pts), jnp.asarray(qs),
                            method=group_weights)
    tg, tw, td = group_weights(port, torch.from_numpy(pts),
                               torch.from_numpy(qs))
    for got, want in ((tg, jg), (tw, jw), (td, jd)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_refuses_bad_arguments():
    pts, qs = map(torch.from_numpy, _clouds(60, n=5))
    with pytest.raises(ValueError, match="group size"):
        soft_project(pts, qs, torch.tensor(1.0), 6)
    with pytest.raises(TypeError, match="float32"):
        soft_project(pts.double(), qs, torch.tensor(1.0), 2)
    # the plain version also runs in f64, as a reference
    out, _ = soft_project(pts.double(), qs.double(),
                          torch.tensor(1.0, dtype=torch.float64), 2)
    assert out.dtype == torch.float64
    with pytest.raises(ValueError, match="cpu or cuda"):
        soft_project(pts.to("meta"), qs.to("meta"),
                     torch.tensor(1.0, device="meta"), 2)
