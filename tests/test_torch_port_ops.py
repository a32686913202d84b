"""The port's ops against the JAX package on the CPU.

The plain PyTorch versions of the CUDA kernels (what a CPU tensor runs) are
held against the Pallas kernels run in interpret mode, as
tests/test_pallas_kernels.py runs them, and the matching helpers against
the JAX functions and tests/oracles.py. Inputs come from a numpy seed and
both sides get the same arrays.

Tolerances: XLA:CPU contracts the Pallas kernels' sum of squares into
FMAs, while torch on the CPU adds the rounded products left to right, so a
distance may differ in its last bit (observed <= 1.1e-7 relative): dist is
compared at rtol 3e-7, and an index only where its best and second-best
candidates differ by more than 1e-6 relative, where one ulp cannot swap
them. The test counts those queries and requires >= 90% to be compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.ops import matching as jax_matching
from samplenet_tpu.ops.pallas.chamfer_kernel import nn_direction as jax_nn
from samplenet_tpu.ops.pallas.fps_kernel import (
    farthest_point_sample_pallas,
    farthest_point_sample_pallas_with_points,
    fps_from_given_pallas_with_points,
)
from samplenet_tpu_torch.ops import fps as port_fps
from samplenet_tpu_torch.ops import matching as port_matching
from samplenet_tpu_torch.ops.cuda import nn_direction
from tests.oracles import nn_matching_np, unique_np

torch.set_num_threads(1)

GAP = 1e-6  # relative gap above which one ulp cannot reorder two candidates


def _nn_clear(x, y):
    """[B, N1] bool: the query's two nearest candidates are GAP apart."""
    d = ((x[:, :, None].astype(np.float64) - y[:, None]) ** 2).sum(-1)
    two = np.sort(d, axis=-1)[..., :2]
    return two[..., 1] - two[..., 0] > GAP * two[..., 1]


def _fps_clear(points, idx, count):
    """[B] bool: every argmax step of the FPS run that chose `idx` had its
    two largest min-distances GAP apart (replayed in float64)."""
    pts = points.astype(np.float64)
    ok = np.ones(len(pts), bool)
    for b in range(len(pts)):
        dist = np.full(pts.shape[1], np.inf)
        for t, sel in enumerate(idx[b]):
            if t >= count[b] and np.isfinite(dist).all():
                two = np.sort(dist)[-2:]
                ok[b] &= two[1] - two[0] > GAP * two[1]
            dist = np.minimum(dist, ((pts[b] - pts[b, sel]) ** 2).sum(-1))
    return ok


@pytest.mark.parametrize("b,n1,n2", [(2, 50, 200), (3, 33, 257)])
def test_nn_direction_plain_matches_pallas(b, n1, n2):
    rng = np.random.RandomState(0)
    x = rng.randn(b, n1, 3).astype(np.float32)
    y = rng.randn(b, n2, 3).astype(np.float32)
    # tile_x=16 and chunk=64 leave ragged tails on both axes of the kernel
    jd, ji = jax_nn(jnp.asarray(x), jnp.asarray(y), tile_x=16, chunk=64,
                    interpret=True)
    td, ti = nn_direction(torch.from_numpy(x), torch.from_numpy(y))
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=3e-7, atol=0)
    clear = _nn_clear(x, y)
    assert clear.mean() >= 0.9
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])


def test_seeded_fps_plain_matches_pallas():
    rng = np.random.RandomState(1)
    b, n, k = 4, 150, 12
    pts = rng.randn(b, n, 3).astype(np.float32)
    given = rng.randint(0, n, (b, k)).astype(np.int32)
    count = np.array([1, 4, 12, 7], np.int32)
    ji, jx = fps_from_given_pallas_with_points(
        k, jnp.asarray(pts), jnp.asarray(given), jnp.asarray(count),
        block_b=4, interpret=True)
    ti, tx = port_fps.fps_from_given_with_points(
        k, torch.from_numpy(pts), torch.from_numpy(given),
        torch.from_numpy(count))
    # the emitted points are the input's rows, bit for bit
    np.testing.assert_array_equal(
        tx.numpy(), np.take_along_axis(pts, ti.numpy()[..., None], 1))
    clear = _fps_clear(pts, ti.numpy(), count)
    assert clear.mean() >= 0.9
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])
    np.testing.assert_array_equal(tx.numpy()[clear], np.asarray(jx)[clear])
    np.testing.assert_array_equal(
        port_fps.fps_from_given(k, torch.from_numpy(pts),
                                torch.from_numpy(given),
                                torch.from_numpy(count)).numpy(), ti.numpy())


@pytest.mark.parametrize("start", [0, [5, 17, 99]])
def test_plain_fps_matches_pallas(start):
    rng = np.random.RandomState(2)
    pts = rng.randn(3, 100, 3).astype(np.float32)
    jstart = start if isinstance(start, int) else jnp.asarray(start, jnp.int32)
    tstart = start if isinstance(start, int) else torch.tensor(start)
    ji = farthest_point_sample_pallas(8, jnp.asarray(pts), start_idx=jstart,
                                      interpret=True)
    ji2, jx = farthest_point_sample_pallas_with_points(
        8, jnp.asarray(pts), start_idx=jstart, interpret=True)
    ti = port_fps.farthest_point_sample(8, torch.from_numpy(pts),
                                        start_idx=tstart)
    ti2, tx = port_fps.farthest_point_sample_with_points(
        8, torch.from_numpy(pts), start_idx=tstart)
    clear = _fps_clear(pts, ti.numpy(), np.ones(3, np.int32))
    assert clear.all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti2.numpy(), np.asarray(ji2))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_first_occurrence_and_compaction_match_jax_and_oracle():
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 10, (4, 16)).astype(np.int32)   # many duplicates
    occ_j = jax_matching.first_occurrence_mask(jnp.asarray(idx))
    occ_t = port_matching.first_occurrence_mask(torch.from_numpy(idx))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    comp_j = jax_matching._compact_indices(jnp.asarray(idx), occ_j, 16)
    comp_t = port_matching._compact_indices(torch.from_numpy(idx), occ_t, 16)
    np.testing.assert_array_equal(comp_t.numpy(), np.asarray(comp_j))
    for row, comp, n_unique in zip(idx, comp_t.numpy(), occ_t.sum(1).numpy()):
        np.testing.assert_array_equal(comp[:n_unique], unique_np(row))


@pytest.mark.parametrize("complete_fps", [True, False])
def test_nn_match_from_clouds_matches_jax_and_oracle(complete_fps):
    rng = np.random.RandomState(4)
    b, n, m = 4, 200, 16
    full = rng.randn(b, n, 3).astype(np.float32)
    # simplified points near input points, half of them twice: duplicates
    # leave room for the FPS completion
    near = rng.randint(0, n, (b, m // 2))
    near = np.concatenate([near, near], axis=1)
    simp = (np.take_along_axis(full, near[..., None], 1)
            + 0.01 * rng.randn(b, m, 3)).astype(np.float32)
    jp, ji = jax_matching.nn_match_from_clouds(
        jnp.asarray(full), jnp.asarray(simp), m, complete_fps=complete_fps)
    tp, ti = port_matching.nn_match_from_clouds(
        torch.from_numpy(full), torch.from_numpy(simp), m,
        complete_fps=complete_fps)
    # the JAX CPU path takes the NN by |x|^2+|y|^2-2xy (ops/pairwise.py),
    # so compare clouds whose NN and FPS steps have no near-tie
    nn_idx = nn_direction(torch.from_numpy(simp),
                          torch.from_numpy(full))[1].numpy()
    counts = np.array([len(unique_np(r)) for r in nn_idx])
    clear = _nn_clear(simp, full).all(1)
    if complete_fps:
        clear &= _fps_clear(full, ti.numpy(), counts)
        assert (counts < m).all()
    assert clear.all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(
        tp.numpy(), np.take_along_axis(full, ti.numpy()[..., None], 1))
    oracle = nn_matching_np(full, nn_idx, m, complete_fps=complete_fps)
    np.testing.assert_allclose(tp.numpy(), oracle, rtol=0, atol=0)
    np.testing.assert_array_equal(
        port_matching.nn_matching(torch.from_numpy(full),
                                  torch.from_numpy(nn_idx), m,
                                  complete_fps=complete_fps).numpy(),
        tp.numpy())
    np.testing.assert_array_equal(
        port_matching.nn_match_indices(torch.from_numpy(full),
                                       torch.from_numpy(nn_idx), m,
                                       complete_fps=complete_fps).numpy(),
        ti.numpy())
