"""The rest of the public ops library against the JAX package on the CPU,
the samplenet:: op registry, the utils package, and the public surface.

  * query_ball_point, select_top_k and non_sampled: exactly, including
    query_ball_point's chunked query axis and its zero-in-ball fallback
    (a query with a point within 1e-5 relative of the radius would be a
    tie, and the data is checked to have none);
  * prob_sample's inverse-CDF step on the JAX package's own uniform draws,
    and RandomSampler's top-k rule on shared keys: exactly;
  * utils.pointcloud on a shared RandomState: exactly;
  * each samplenet:: op on CPU tensors: bit for bit its plain version,
    with torch.library.opcheck on its schema, fake and autograd
    registrations; the registered gradients of nn_direction and fps equal
    the plain versions' autograd gradients (no ties in the data);
  * every name that samplenet_tpu/__init__.py, ops/__init__.py and
    models/__init__.py import has a counterpart the port's matching
    __init__ imports.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.ops import fps as jax_fps
from samplenet_tpu.ops import knn as jax_knn
from samplenet_tpu.utils import pointcloud as jax_pc
from samplenet_tpu_torch.models import RandomSampler
from samplenet_tpu_torch.models.samplenet import random_subset_indices
from samplenet_tpu_torch.ops import fps as port_fps
from samplenet_tpu_torch.ops import knn as port_knn
from samplenet_tpu_torch.ops.cuda import chamfer_kernel, fps_kernel
from samplenet_tpu_torch.ops.cuda import point_mlp_kernel as pmk
from samplenet_tpu_torch.utils import pointcloud as port_pc
from samplenet_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("m,chunk,radius,nsample", [
    (10, 512, 0.8, 5),          # one chunk
    (37, 8, 0.8, 5),            # chunked, ragged last chunk
    (37, 8, 0.15, 4),           # most queries with no point in the ball
    (12, 5, 3.0, 6),            # every query full
])
def test_query_ball_point_matches_jax(m, chunk, radius, nsample):
    xyz, new_xyz = _rand(0, 2, 40, 3), _rand(1, 2, m, 3)
    d2 = ((new_xyz[:, :, None].astype(np.float64)
           - xyz[:, None].astype(np.float64)) ** 2).sum(-1)
    assert (np.abs(d2 - radius ** 2) > 1e-5 * radius ** 2).all()
    idx, cnt = port_knn.query_ball_point(radius, nsample,
                                         torch.from_numpy(xyz),
                                         torch.from_numpy(new_xyz),
                                         chunk=chunk)
    jidx, jcnt = jax_knn.query_ball_point(radius, nsample, jnp.asarray(xyz),
                                          jnp.asarray(new_xyz), chunk=chunk)
    assert idx.dtype == cnt.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    empty = cnt.numpy() == 0
    assert (idx.numpy()[empty] == 0).all()
    if radius < 0.2:
        assert empty.any()


@pytest.mark.parametrize("ties", [False, True])
def test_select_top_k_matches_jax(ties):
    dist = _rand(2, 2, 6, 20)
    if ties:                       # many equal entries: lowest index first
        dist = np.round(dist * 2).astype(np.float32)
    vals, idx = port_knn.select_top_k(7, torch.from_numpy(dist))
    jvals, jidx = jax_knn.select_top_k(7, jnp.asarray(dist))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_non_sampled_matches_jax():
    rng = np.random.RandomState(3)
    idx = np.stack([rng.permutation(50)[:12] for _ in range(4)]).astype(
        np.int32)
    got = port_fps.non_sampled(50, torch.from_numpy(idx))
    want = np.asarray(jax_fps.non_sampled(50, jnp.asarray(idx)))
    assert got.dtype == torch.int32 and got.shape == (4, 38)
    np.testing.assert_array_equal(got.numpy(), want)
    for row, taken in zip(got.numpy(), idx):
        assert sorted(set(row) | set(taken)) == list(range(50))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prob_sample_inverse_cdf_matches_jax(seed):
    weights = np.abs(_rand(10 + seed, 3, 30))
    weights[:, ::7] = 0.0                  # zero-weight points are never hit
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_fps.prob_sample(key, jnp.asarray(weights), 64))
    u = np.asarray(jax.random.uniform(key, (3, 64)))  # prob_sample's draws
    got = port_fps.inverse_cdf_indices(torch.from_numpy(weights),
                                       torch.from_numpy(np.array(u)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = port_fps.prob_sample(torch.from_numpy(weights), 500,
                                 generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 500)
    assert (weights[np.arange(3)[:, None], drawn.numpy()] > 0).all()


def test_random_subset_rule_matches_jax_top_k():
    keys = np.array(jax.random.uniform(jax.random.PRNGKey(5), (4, 64)))
    _, want = jax.lax.top_k(jnp.asarray(keys), 16)
    got = random_subset_indices(torch.from_numpy(keys), 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_sampler_draws_without_replacement():
    sampler = RandomSampler(16)
    x = torch.from_numpy(_rand(6, 3, 64, 3))
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(200):
        y, y2 = sampler(x, generator=g)
        assert y is y2 and y.shape == (3, 16, 3)
        for b in range(3):
            rows = [int(np.flatnonzero((x[b].numpy() == p).all(-1))[0])
                    for p in y[b].numpy()]
            assert len(set(rows)) == 16
            seen.add(tuple(sorted(rows)))
    assert len(seen) > 590                   # the draws do differ
    assert float(sampler.get_simplification_loss(x)) == 0.0
    assert float(sampler.get_projection_loss()) == 0.0
    bcn = RandomSampler(16, input_shape="bcn", output_shape="bcn")
    y, _ = bcn(x.transpose(1, 2), generator=torch.Generator().manual_seed(0))
    want, _ = sampler(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, want.transpose(1, 2))
    with pytest.raises(ValueError, match="Generator"):
        sampler(x)


def test_pointcloud_utils_match_jax():
    batch = _rand(7, 4, 32, 3)
    for name, call in [
        ("rand_rotation_matrix", lambda m, rs: m.rand_rotation_matrix(rs)),
        ("rotate_z", lambda m, rs: m.rotate_z(batch, rs)),
        ("rotate_z angle", lambda m, rs: m.rotate_z(batch, rs, angle=0.3)),
        ("add_gaussian_noise", lambda m, rs: m.add_gaussian_noise(
            batch, 0.1, 0.05, rs)),
        ("apply_augmentations", lambda m, rs: m.apply_augmentations(
            batch, z_rotate=True, gauss_augment={"sigma": 0.01}, rng=rs)),
    ]:
        got = call(port_pc, np.random.RandomState(8))
        want = call(jax_pc, np.random.RandomState(8))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(
        port_pc.complementary_points_idx(10, [1, 4, 7]),
        jax_pc.complementary_points_idx(10, [1, 4, 7]))
    assert list(port_pc.iterate_in_chunks(list(range(7)), 3)) == list(
        jax_pc.iterate_in_chunks(list(range(7)), 3))


def _mlp(seed, widths):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.3)
            for cin, cout in zip(widths[:-1], widths[1:])
            for shape in ((cin, cout), (cout,))]


@pytest.mark.parametrize("op,args,plain", [
    (torch.ops.samplenet.nn_direction,
     (torch.from_numpy(_rand(0, 2, 9, 3)),
      torch.from_numpy(_rand(1, 2, 13, 3))),
     chamfer_kernel.nn_direction_plain),
    (torch.ops.samplenet.fps,
     (torch.from_numpy(_rand(2, 2, 30, 3)),
      torch.tensor([[4, 0, 0, 0, 0, 0], [7, 7, 2, 0, 0, 0]],
                   dtype=torch.int32),
      torch.tensor([1, 3], dtype=torch.int32), 6),
     fps_kernel.fps_plain),
])
def test_op_equals_plain_and_passes_opcheck(op, args, plain):
    got, want = op(*args), plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("bf16", [False, True])
def test_point_mlp_max_op_equals_plain_and_passes_opcheck(bf16):
    widths = [3, 16, 24]
    wbs = _mlp(3, widths)
    x = torch.from_numpy(_rand(4, 2, 20, 3))
    params = pmk._flat_params(pmk._pairs(wbs))
    got = torch.ops.samplenet.point_mlp_max(x, params, widths, bf16)
    assert torch.equal(got, pmk.point_mlp_max_plain(x, wbs, bf16))
    assert torch.equal(got, pmk.point_mlp_max(x, wbs, bf16=bf16))
    torch.library.opcheck(torch.ops.samplenet.point_mlp_max,
                          (x, params, widths, bf16))


def test_registered_gradients_equal_the_plain_versions():
    x = torch.from_numpy(_rand(5, 2, 9, 3)).requires_grad_()
    y = torch.from_numpy(_rand(6, 2, 13, 3)).requires_grad_()
    g = torch.from_numpy(_rand(7, 2, 9))
    dist, _ = chamfer_kernel.nn_direction(x, y)
    got = torch.autograd.grad(dist, (x, y), g)
    dist, _ = chamfer_kernel.nn_direction_plain(x, y)
    want = torch.autograd.grad(dist, (x, y), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    pts = torch.from_numpy(_rand(8, 2, 30, 3)).requires_grad_()
    given = torch.zeros((2, 6), dtype=torch.int32)
    count = torch.ones((2,), dtype=torch.int32)
    gx = torch.from_numpy(_rand(9, 2, 6, 3))
    _, xyz = fps_kernel.fps(pts, given, count, 6)
    (got,) = torch.autograd.grad(xyz, pts, gx)
    _, xyz = fps_kernel.fps_plain(pts, given, count, 6)
    (want,) = torch.autograd.grad(xyz, pts, gx)
    assert torch.equal(got, want)


def test_profiling_surface(tmp_path):
    timer = profiling.StepTimer()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("step"):
            out = torch.ones(4) * 2
        assert profiling.force_sync(out) == 8.0
        assert timer.mark(out) >= 0 and timer.ema_ms is not None
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "step" in names


def _imported_names(path: Path) -> set[str]:
    """The names a package __init__ imports from its modules."""
    tree = ast.parse(path.read_text())
    return {alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom)
            for alias in node.names}


@pytest.mark.parametrize("init", ["__init__.py", "ops/__init__.py",
                                  "models/__init__.py"])
def test_public_surface_covers_the_jax_package(init):
    """ROADMAP's "Nothing to port" names none of these exports."""
    import importlib

    jax_names = _imported_names(ROOT / "samplenet_tpu" / init)
    port_names = _imported_names(ROOT / "samplenet_tpu_torch" / init)
    assert sorted(jax_names - port_names) == []
    module = importlib.import_module(
        "samplenet_tpu_torch" + ("." + init.split("/")[0] if "/" in init
                                 else ""))
    assert all(hasattr(module, name) for name in jax_names)
