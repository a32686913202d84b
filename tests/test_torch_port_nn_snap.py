"""The port's 1-NN snap (hard projection) against the JAX package on the CPU.

`nn_snap_plain` against JAX's `nn_snap(..., interpret=True)` (as
tests/test_pallas_kernels.py:118-172 runs the Pallas kernel off-TPU), the
port's `SoftProjection.project(hard=True)` against JAX's XLA hard
projection (k-NN by |x|^2 + |y|^2 - 2xy, then the argmax of the softmax
weights, models/soft_projection.py:122-130), and `nn_distance_pallas`.

Tolerances, and why: distances to rtol 3e-7, about one ulp: XLA:CPU
contracts the interpreted kernel's dx*dx + dy*dy + dz*dz into FMAs, while
torch adds left to right (ROADMAP, parity rules). Indices exactly, on the
queries whose best and second-best distances are more than 1e-6 apart
relative (1e-4 against the XLA path, whose |x|^2 + |y|^2 - 2xy form loses
more); every snapped point equals the database point at its own index bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.models.soft_projection import (
    SoftProjection as JaxSoftProjection,
)
from samplenet_tpu.ops.pallas import nn_snap as jax_nn_snap
from samplenet_tpu.ops.pallas.chamfer_kernel import (
    nn_distance_pallas as jax_nn_distance_pallas,
)
from samplenet_tpu_torch.models.soft_projection import SoftProjection
from samplenet_tpu_torch.ops.cuda import chamfer_kernel
from samplenet_tpu_torch.ops.cuda.chamfer_kernel import (
    nn_distance_pallas,
    nn_snap,
    nn_snap_plain,
)

torch.set_num_threads(1)


def _clouds(seed, b, n1, n2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n1, 3).astype(np.float32),
            rng.randn(b, n2, 3).astype(np.float32))


def _clear(x, y, gap):
    """[B, N1] mask of queries whose two nearest points differ by more than
    `gap` relative."""
    d = ((x[:, :, None, :].astype(np.float64)
          - y[:, None, :, :].astype(np.float64)) ** 2).sum(-1)
    if d.shape[2] < 2:
        return np.ones(d.shape[:2], bool)
    two = np.sort(d, axis=2)[:, :, :2]
    return (two[..., 1] - two[..., 0]) > gap * np.maximum(two[..., 1], 1e-30)


def _gather(y, idx):
    return np.take_along_axis(y, idx[..., None].astype(np.int64), axis=1)


@pytest.mark.parametrize("b,n1,n2", [
    (2, 40, 100),
    (3, 300, 200),     # Pallas pads the queries (tile 512 > 300)
    (2, 33, 1100),     # three Pallas database chunks, ragged tail
    (1, 1, 1),
])
def test_plain_matches_interpreted_kernel(b, n1, n2):
    x, y = _clouds(n1 + n2, b, n1, n2)
    jd, ji, js = (np.asarray(a) for a in jax_nn_snap(
        jnp.asarray(x), jnp.asarray(y), interpret=True))
    d, i, s = (t.numpy() for t in nn_snap_plain(torch.from_numpy(x),
                                                torch.from_numpy(y)))
    assert d.dtype == np.float32 and i.dtype == np.int32
    assert s.shape == (b, n1, 3)
    np.testing.assert_allclose(d, jd, rtol=3e-7, atol=0)
    clear = _clear(x, y, 1e-6)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(i[clear], ji[clear])
    np.testing.assert_array_equal(s, _gather(y, i))          # bit for bit
    np.testing.assert_array_equal(js, _gather(y, ji))
    np.testing.assert_array_equal(s[clear], js[clear])


def test_cpu_tensor_takes_the_plain_version():
    x, y = _clouds(1, 2, 50, 70)
    got = nn_snap(torch.from_numpy(x), torch.from_numpy(y))
    want = nn_snap_plain(torch.from_numpy(x), torch.from_numpy(y))
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_ties_go_to_the_lowest_index_and_nan_counts_as_inf():
    rng = np.random.RandomState(2)
    base = rng.randn(1, 20, 3).astype(np.float32)
    y = np.concatenate([base, base], axis=1)          # every point twice
    y[0, 0] = np.nan                                  # a NaN database point
    x = base[:, 1:].copy()
    d, i, s = nn_snap_plain(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(i.numpy()[0], np.arange(1, 20))
    assert float(d.max()) == 0.0
    np.testing.assert_array_equal(s.numpy(), x)
    q = np.full((1, 2, 3), np.nan, np.float32)        # NaN queries: all +inf
    d, i, s = nn_snap_plain(torch.from_numpy(q), torch.from_numpy(y))
    assert np.isinf(d.numpy()).all() and not i.numpy().any()
    assert np.isnan(s.numpy()).all()                  # y[0] is the NaN point


def test_wrapper_does_not_fall_back(monkeypatch):
    monkeypatch.setattr(chamfer_kernel, "use_kernel", lambda t: True)
    x = torch.zeros(2, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        nn_snap(x, x)


def test_hard_projection_matches_jax_xla_path():
    x, y = _clouds(13, 2, 64, 256)            # queries, input points
    jproj = JaxSoftProjection(group_size=7, use_pallas=False)
    v = jproj.init(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(x))
    hard_xla = np.asarray(jproj.apply(
        v, jnp.asarray(y), jnp.asarray(x),
        method=lambda m, a, b: m.project(a, b, hard=True)[0]))
    proj = SoftProjection(group_size=7)
    with torch.no_grad():
        hard, w, d = proj.project(torch.from_numpy(y), torch.from_numpy(x),
                                  hard=True)
    assert w is None and d is None
    hard = hard.numpy()
    clear = _clear(x, y, 1e-4)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(hard[clear], hard_xla[clear])
    # every hard-projected point is an input point
    _, idx = chamfer_kernel.nn_direction_plain(torch.from_numpy(x),
                                               torch.from_numpy(y))
    np.testing.assert_array_equal(hard, _gather(y, idx.numpy()))


def test_nn_distance_pallas_matches_jax():
    x, y = _clouds(5, 2, 300, 200)
    got = nn_distance_pallas(torch.from_numpy(x), torch.from_numpy(y))
    want = jax_nn_distance_pallas(jnp.asarray(x), jnp.asarray(y),
                                  interpret=True)
    for a, c in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=3e-7)
    for (a, c), (p, q) in (((got[1], want[1]), (x, y)),
                           ((got[3], want[3]), (y, x))):
        clear = _clear(p, q, 1e-6)
        np.testing.assert_array_equal(a.numpy()[clear], np.asarray(c)[clear])
