"""Seeded FPS and the 1-NN ops on NaN input, against the JAX package, on
the CPU; the FPS kernel's step order, emulated; its launch plan.

NaN, FPS: the JAX package's XLA path (`fps_from_given`,
`farthest_point_sample`) and its Pallas kernel run in interpret mode keep
the running distance with jnp.minimum and pick with jnp.argmax, so NaN
propagates and ranks first: a cloud with a NaN coordinate in point 5,
start 0, k=6 gives [0, 5, 0, 0, 0, 0] (point 5 is picked, then every
distance is NaN and argmax takes index 0). The port's `fps_plain` (and
`fps` on a CPU tensor) gives the same indices.

NaN, 1-NN: the JAX package's path off the TPU, `chunked_min_argmin`
(which `nn_distance` and `nn_match_from_clouds` run there), returns dist
NaN and the first NaN index; a NaN query gets index 0. The port's
`nn_direction_plain` and `nn_snap_plain` agree. The interpreted Pallas
`nn_direction` drops the whole chunk that holds the NaN (ROADMAP Queue 3,
a fault of the reference, recorded and not followed).

The kernel (csrc/fps.cu): one block a cloud, thread t holding points t,
t + T, ... (T threads, R a thread) with their running distances, points
past N as padding at the origin with distance +0; the given prefix folded
into one min pass; each completion step a thread's first maximum by the
distance's bits (min.NaN's canonical NaN 0x7fffffff above +inf), the
warps' maximum bits and least index among them, the same across warps;
no update after the last pick. `_kernel_fps` follows that in numpy on
float32 arithmetic in the kernel's order and is held to `fps_plain`.

Tolerances: indices exactly; xyz bit for bit (compared as int32 views,
since NaN != NaN); 1-NN distances by their NaN positions and, where
finite, against the XLA path's |x|^2 + |y|^2 - 2xy form to rtol 1e-4 on
queries away from near-ties (indices exactly there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.models.soft_projection import (
    SoftProjection as JaxSoftProjection,
)
from samplenet_tpu.ops.fps import farthest_point_sample as jax_fps
from samplenet_tpu.ops.fps import fps_from_given as jax_fps_from_given
from samplenet_tpu.ops.matching import (
    nn_match_from_clouds as jax_nn_match_from_clouds,
)
from samplenet_tpu.ops.pairwise import chunked_min_argmin
from samplenet_tpu.ops.pallas import fps_from_given_pallas
from samplenet_tpu.ops.pallas import nn_direction as jax_nn_direction_pallas
from samplenet_tpu_torch.models.soft_projection import SoftProjection
from samplenet_tpu_torch.ops.cuda import fps_plan as fp
from samplenet_tpu_torch.ops.cuda.chamfer_kernel import (
    nn_direction,
    nn_direction_plain,
    nn_snap_plain,
)
from samplenet_tpu_torch.ops.cuda.fps_kernel import fps, fps_plain
from samplenet_tpu_torch.ops.fps import farthest_point_sample
from samplenet_tpu_torch.ops.matching import nn_match_from_clouds

torch.set_num_threads(1)

NAN_POINT = 5


def _cloud(seed=0, b=1, n=16, axis=1, point=NAN_POINT):
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, n, 3).astype(np.float32)
    if axis is not None:
        pts[:, point, axis] = np.nan
    return pts


def _port_fps(pts, given, count, k):
    idx, xyz = fps_plain(torch.from_numpy(pts), torch.from_numpy(given),
                         torch.from_numpy(count), k)
    return idx.numpy(), xyz.numpy()


def _jax_fps(pts, given, count, k):
    args = (k, jnp.asarray(pts), jnp.asarray(given), jnp.asarray(count))
    return (np.asarray(jax_fps_from_given(*args)),
            np.asarray(fps_from_given_pallas(*args, interpret=True)))


def _bits_equal(a, b):
    return np.array_equal(np.asarray(a, np.float32).view(np.int32),
                          np.asarray(b, np.float32).view(np.int32))


# ---------------------------------------------------------------- FPS, NaN

def test_the_probe_cloud_gives_0_5_0_0_0_0():
    pts = _cloud(0)
    given, count = np.zeros((1, 6), np.int32), np.ones(1, np.int32)
    want = [[0, 5, 0, 0, 0, 0]]
    xla, pallas = _jax_fps(pts, given, count, 6)
    idx, xyz = _port_fps(pts, given, count, 6)
    assert xla.tolist() == want and pallas.tolist() == want
    assert idx.tolist() == want
    got, _ = fps(torch.from_numpy(pts), torch.from_numpy(given),
                 torch.from_numpy(count), 6)
    assert got.tolist() == want
    assert _bits_equal(xyz, pts[0][idx[0]][None])


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("where", ["completion", "given", "given_later"])
def test_fps_nan_follows_the_jax_package(axis, where):
    """NaN in x, y or z of a point that a completion step picks (start 0,
    count 1), that is the first given point, or that is a later given
    point (count 3); 40 points, k = 9, two clouds."""
    pts = _cloud(axis + 3, b=2, n=40, axis=axis, point=NAN_POINT)
    rng = np.random.RandomState(axis)
    given = rng.randint(0, 40, (2, 9)).astype(np.int32)
    given[given == NAN_POINT] = 7
    count = np.ones(2, np.int32)
    if where == "completion":
        given[:, 0] = 0
    elif where == "given":
        given[:, 0] = NAN_POINT
    else:
        given[:, 2] = NAN_POINT
        count[:] = 3
    xla, pallas = _jax_fps(pts, given, count, 9)
    idx, xyz = _port_fps(pts, given, count, 9)
    np.testing.assert_array_equal(idx, xla)
    np.testing.assert_array_equal(idx, pallas)
    assert (idx == NAN_POINT).any(axis=1).all()
    assert _bits_equal(xyz, np.take_along_axis(pts, idx[..., None], 1))


@pytest.mark.parametrize("start", [0, 9])
def test_plain_fps_with_nan_and_inf_follows_xla(start):
    pts = _cloud(4, b=3, n=50, axis=2, point=11)
    pts[1, 20, 0] = np.inf
    pts[2, 30, 1] = -np.inf
    pts[2, 31] = np.nan
    want = np.asarray(jax_fps(12, jnp.asarray(pts), start_idx=start))
    got = farthest_point_sample(12, torch.from_numpy(pts), start_idx=start)
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------- 1-NN, NaN

def _xla_nn(x, y, chunk=512):
    d, i = chunked_min_argmin(jnp.asarray(x), jnp.asarray(y), chunk=chunk)
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("chunk", [512, 4])   # one matmul; the scan path
def test_nn_nan_database_point_follows_chunked_min_argmin(chunk):
    """A NaN y in database point 5: every query's distance is NaN and its
    index 5, on the XLA path and on the port's plain versions."""
    y = _cloud(0)
    x = np.random.RandomState(1).randn(1, 10, 3).astype(np.float32)
    wd, wi = _xla_nn(x, y, chunk)
    assert np.isnan(wd).all() and (wi == NAN_POINT).all()
    for d, i in (nn_direction_plain(torch.from_numpy(x), torch.from_numpy(y)),
                 nn_snap_plain(torch.from_numpy(x), torch.from_numpy(y))[:2],
                 nn_direction(torch.from_numpy(x), torch.from_numpy(y))):
        np.testing.assert_array_equal(np.isnan(d.numpy()), np.isnan(wd))
        np.testing.assert_array_equal(i.numpy(), wi)
    snapped = nn_snap_plain(torch.from_numpy(x), torch.from_numpy(y))[2]
    assert _bits_equal(snapped.numpy(),
                       np.broadcast_to(y[:, NAN_POINT], snapped.shape))


def test_nn_nan_query_takes_index_0_and_the_rest_are_unchanged():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, 3).astype(np.float32)
    y = rng.randn(2, 30, 3).astype(np.float32)
    x[1, 4, 2] = np.nan
    wd, wi = _xla_nn(x, y)
    d, i = (t.numpy() for t in nn_direction_plain(torch.from_numpy(x),
                                                   torch.from_numpy(y)))
    assert np.isnan(wd[1, 4]) and wi[1, 4] == 0
    assert np.isnan(d[1, 4]) and i[1, 4] == 0
    np.testing.assert_array_equal(np.isnan(d), np.isnan(wd))
    np.testing.assert_array_equal(i, wi)
    finite = ~np.isnan(wd)
    np.testing.assert_allclose(d[finite], wd[finite], rtol=1e-4, atol=1e-6)


def test_interpreted_pallas_nn_direction_drops_the_nan_chunk():
    """The reference fault the port does not follow: in the interpreted
    Pallas kernel a chunk's NaN minimum fails `c_min < best_d`, so every
    point of that chunk is hidden. One chunk of 16: dist +inf and index 0
    for every query, where the XLA path gives NaN and 5."""
    y = _cloud(0)
    x = np.random.RandomState(1).randn(1, 4, 3).astype(np.float32)
    d, i = (np.asarray(a) for a in jax_nn_direction_pallas(
        jnp.asarray(x), jnp.asarray(y), interpret=True))
    assert np.isinf(d).all() and (i == 0).all()
    pd, pi = nn_direction_plain(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.isnan(pd).all() and (pi == NAN_POINT).all()


def test_nn_match_from_clouds_with_a_nan_point_follows_jax():
    """An input cloud with a NaN point: every simplified point's 1-NN is
    the NaN point, and FPS completes the set from it with index 0."""
    full = _cloud(6, b=2, n=64, axis=0, point=NAN_POINT)
    full[1, NAN_POINT] = full[1, 9]          # cloud 1 is finite
    simp = np.random.RandomState(7).randn(2, 12, 3).astype(np.float32)
    _, want = jax_nn_match_from_clouds(jnp.asarray(full), jnp.asarray(simp),
                                       8)
    pts, got = nn_match_from_clouds(torch.from_numpy(full),
                                    torch.from_numpy(simp), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].tolist() == [NAN_POINT] + [0] * 7
    assert _bits_equal(pts.numpy(),
                       np.take_along_axis(full, got.numpy()[..., None], 1))


def test_hard_projection_on_a_nan_point_snaps_to_it():
    """A deviation the port records: the hard projection snaps with
    nn_snap, which follows chunked_min_argmin, so every query lands on the
    NaN point; the JAX package's XLA hard projection takes its neighbours
    from knn_point, which counts NaN as +inf, and lands on a finite
    point."""
    y = _cloud(0)
    x = np.random.RandomState(1).randn(1, 4, 3).astype(np.float32)
    jproj = JaxSoftProjection(group_size=3, use_pallas=False)
    v = jproj.init(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(x))
    xla = np.asarray(jproj.apply(
        v, jnp.asarray(y), jnp.asarray(x),
        method=lambda m, a, b: m.project(a, b, hard=True)[0]))
    with torch.no_grad():
        hard = SoftProjection(group_size=3).project(
            torch.from_numpy(y), torch.from_numpy(x), hard=True)[0].numpy()
    assert np.isfinite(xla).all()
    assert _bits_equal(hard, np.broadcast_to(y[:, NAN_POINT], hard.shape))


# ------------------------------------------------- the kernel, emulated

CANONICAL_NAN = np.uint32(0x7FFFFFFF)
NO_INDEX = np.uint32(0xFFFFFFFF)


def _keys(pd):
    """The kernel's keys: the distance's bits, NaN as min.NaN leaves it."""
    k = pd.view(np.uint32).copy()
    k[np.isnan(pd)] = CANONICAL_NAN
    return k


def _update(pd, xyz, s):
    """min.NaN(pd, (dx*dx + dy*dy) + dz*dz), float32 rounded op by op."""
    dx, dy, dz = (xyz[..., c] - s[c] for c in range(3))
    d = (dx * dx + dy * dy) + dz * dz
    return np.minimum(pd, d)                # propagates NaN


def _kernel_fps(pts, given, count, k, plan):
    """csrc/fps.cu's steps for every cloud, in numpy."""
    b, n, _ = pts.shape
    t_, r = plan.threads, plan.points
    p = np.arange(t_)[None, :] + np.arange(r)[:, None] * t_     # [R, T]
    real = p < n
    idx = np.zeros((b, k), np.int32)
    for c in range(b):
        cloud = pts[c]
        if plan.shared:                     # xyz reread at min(p, n - 1)
            xyz = cloud[np.minimum(p, n - 1)]
        else:                               # padding at the origin
            xyz = np.where(real[..., None], cloud[np.minimum(p, n - 1)],
                           np.float32(0))
        pd = np.where(real, np.float32(np.inf), np.float32(0))
        cnt = min(max(int(count[c]), 0), k)
        picks = [int(g) for g in given[c, :cnt]]
        for g in picks:                     # the folded prefix
            s = cloud[g] if 0 <= g < n else np.zeros(3, np.float32)
            pd = _update(pd, xyz, s)
        for t in range(cnt, k):
            keys = _keys(pd)
            bj = np.argmax(keys, axis=0)    # a thread's first maximum
            best = keys[bj, np.arange(t_)]
            own = (np.arange(t_) + bj * t_).astype(np.uint32)
            best, own = best.reshape(-1, 32), own.reshape(-1, 32)
            hi = best.max(axis=1)           # redux.sync max, then min
            lo = np.where(best == hi[:, None], own, NO_INDEX).min(axis=1)
            far = int(np.where(hi == hi.max(), lo, NO_INDEX).min())
            assert far < n
            picks.append(far)
            if t + 1 < k:
                pd = _update(pd, xyz, cloud[far])
        idx[c] = picks
    return idx


def _grid(b):
    g = np.arange(6, dtype=np.float32)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return np.repeat(grid[None], b, axis=0)              # 216 points


def _emulation_input(kind, b, n, seed):
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, n, 3).astype(np.float32)
    if kind == "grid":
        pts = _grid(b)[:, :n].copy()
    elif kind == "nan":
        pts[0, n // 3, 1] = np.nan
        pts[-1, n - 1] = np.nan
    elif kind == "inf":
        pts[0, n // 2, 0] = np.inf
        pts[-1, 1, 2] = -np.inf
        pts[-1, 2, 2] = -np.inf
    return pts


COUNTS = ("one", "random", "all")


def _given(b, n, k, counts, seed):
    rng = np.random.RandomState(seed)
    given = rng.randint(0, n, (b, k)).astype(np.int32)
    count = {"one": np.ones(b), "all": np.full(b, k),
             "random": rng.randint(1, k + 1, b)}[counts].astype(np.int32)
    return given, count


@pytest.mark.parametrize("kind", ["randn", "grid", "nan", "inf"])
@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("b,n,k", [(3, 7, 7), (2, 70, 12), (2, 200, 16)])
def test_kernel_emulation_matches_plain(kind, counts, b, n, k):
    """Under the plan's choice and every other plan the kernel takes."""
    pts = _emulation_input(kind, b, n, n + k)
    given, count = _given(b, n, k, counts, n)
    want, want_xyz = _port_fps(pts, given, count, k)
    plans = {fp.plan_fps(b, n, k, sms=132, smem_limit=232448)}
    plans |= set(fp.candidates(n)[:4])
    for plan in sorted(plans, key=repr):
        np.testing.assert_array_equal(
            _kernel_fps(pts, given, count, k, plan), want, err_msg=repr(plan))
    assert _bits_equal(want_xyz, np.take_along_axis(pts, want[..., None], 1))


def _redux(keys, owns):
    """(max bits, least index among them) along the last axis: redux.sync
    max, then min over the lanes that hold the max."""
    hi = keys.max(axis=-1)
    lo = np.where(keys == hi[..., None], owns, NO_INDEX).min(axis=-1)
    return hi, lo


def _exchange_fps(pts, given, count, k, c, threads, r):
    """csrc/fps.cu's cluster variant for every cloud, exchange included,
    in numpy: C blocks of `threads` threads, block j's slice the points
    j S .. j S + S - 1 (S = threads R, padding at distance 0), thread t
    its points j S + t + i threads; a thread's first maximum by bits, its
    warp's (bits, least index), the block's over its warps' slots; with
    C > 1 each block's (bits, index, xyz) posted into every block's slot
    of its rank, and in each block the slots' maximum, least index, xyz
    from the first slot that holds both (with C = 1 the block's own, xyz
    from its slice). Returns (idx, xyz)."""
    b, n, _ = pts.shape
    size = threads * r
    p = (np.arange(c)[:, None, None] * size + np.arange(threads)[None, None]
         + np.arange(r)[None, :, None] * threads)           # [C, R, T]
    real = p < n
    lanes = np.arange(threads)
    idx = np.zeros((b, k), np.int32)
    xyz_out = np.zeros((b, k, 3), np.float32)
    for bi in range(b):
        cloud = pts[bi]
        xyz = cloud[np.minimum(p, n - 1)]
        pd = np.where(real, np.float32(np.inf), np.float32(0))
        cnt = min(max(int(count[bi]), 0), k)
        for t in range(cnt):
            g = int(given[bi, t])
            s = cloud[g] if 0 <= g < n else np.zeros(3, np.float32)
            pd = np.where(real, _update(pd, xyz, s), pd)
            idx[bi, t], xyz_out[bi, t] = g, s
        for t in range(cnt, k):
            keys = _keys(pd)                                 # [C, R, T]
            j = np.argmax(keys, axis=1)                      # first maximum
            best = np.take_along_axis(keys, j[:, None], 1)[:, 0]   # [C, T]
            own = (p[np.arange(c)[:, None], j, lanes[None]]
                   .astype(np.uint32))
            warp = _redux(best.reshape(c, -1, 32), own.reshape(c, -1, 32))
            hi_b, lo_b = _redux(*warp)                       # [C] posts
            post = np.where((lo_b < n)[:, None],
                            cloud[np.minimum(lo_b, n - 1)], np.float32(0))
            hi, lo = _redux(hi_b, lo_b)
            src = int(np.flatnonzero((hi_b == hi) & (lo_b == lo))[0])
            far, s = int(lo), post[src]
            assert far < n and _bits_equal(s, cloud[far])
            idx[bi, t], xyz_out[bi, t] = far, s
            pd = np.where(real, _update(pd, xyz, s), pd)
    return idx, xyz_out


@pytest.mark.parametrize("kind", ["randn", "inf", "grid", "nan", "all_nan"])
@pytest.mark.parametrize("counts", ["one", "random"])
@pytest.mark.parametrize("c,threads,r", [(1, 64, 8), (1, 32, 16),
                                         (2, 32, 8), (2, 64, 4),
                                         (4, 32, 4), (4, 64, 2),
                                         (8, 32, 2), (8, 64, 1)])
def test_cluster_exchange_emulation_matches_plain(kind, counts, c, threads,
                                                  r):
    """The cluster variant's pick at every C (the warps, the block's slots
    and the C blocks' posted slots) gives fps_plain's idx and xyz bit for
    bit: lowest index on ties across every level, NaN above every
    number, a NaN pick making the next pick index 0."""
    b, n, k = 3, 300, 24
    pts = _emulation_input(kind if kind in ("inf", "nan") else "randn", b,
                           n, c + r)
    if kind == "grid":
        g = np.arange(7, dtype=np.float32)
        grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1)
        pts = np.repeat(grid.reshape(1, -1, 3)[:, :n], b, axis=0).copy()
    elif kind == "all_nan":
        pts[1] = np.nan
    given, count = _given(b, n, k, counts, c * threads + r)
    assert c * threads * r >= n
    want, want_xyz = _port_fps(pts, given, count, k)
    idx, xyz = _exchange_fps(pts, given, count, k, c, threads, r)
    np.testing.assert_array_equal(idx, want)
    assert _bits_equal(xyz, want_xyz)


def test_kernel_emulation_in_the_shared_variant():
    pts = _emulation_input("nan", 1, 300, 3)
    given, count = _given(1, 300, 10, "one", 3)
    want, _ = _port_fps(pts, given, count, 10)
    plan = fp.FpsPlan(fp.MAX_WARPS, fp.SHARED_POINTS, True)
    np.testing.assert_array_equal(_kernel_fps(pts, given, count, 10, plan),
                                  want)


def test_padding_never_wins_on_an_all_nan_cloud():
    """Every distance NaN after the first pick: padding keys tie with the
    real points' and lose by index."""
    pts = np.full((1, 5, 3), np.nan, np.float32)
    given, count = np.zeros((1, 4), np.int32), np.ones(1, np.int32)
    want, _ = _port_fps(pts, given, count, 4)
    assert want.tolist() == [[0, 0, 0, 0]]
    np.testing.assert_array_equal(
        _kernel_fps(pts, given, count, 4, fp.FpsPlan(1, 1, False)), want)


# -------------------------------------------------------------- the plan

H100 = dict(sms=132, smem_limit=232448)


@pytest.mark.parametrize("b,n,k,warps,points", [
    (1024, 1024, 32, 2, 16),     # the eval forward
    (50, 2048, 64, 8, 8),        # the FPS baseline and front end
    (3, 1000, 33, 8, 4),
    (3, 5000, 64, 8, 32),        # 62 KB of shared memory
    (2, 7, 7, 1, 1),
    (32, 1024, 1024, 8, 4),      # the progressive infer step
])
def test_plan_at_the_paths_shapes(b, n, k, warps, points):
    plan = fp.plan_fps(b, n, k, **H100)
    assert (plan.warps, plan.points, plan.shared) == (warps, points, False)
    assert fp.valid(plan, n)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 2048, 5000, 8192, 8193,
                               14000, 16384])
@pytest.mark.parametrize("b", [1, 50, 1024])
def test_every_plan_holds_the_cloud(b, n):
    plan = fp.plan_fps(b, n, 8, **H100)
    assert fp.valid(plan, n)
    assert plan.shared == (n > 8192)
    assert plan.warps <= min(fp.PLAN_WARPS, -(-n // 32)) or plan.shared
    assert all(fp.valid(c, n) for c in fp.candidates(n))


def test_plan_refuses_what_the_kernel_cannot_take():
    """The shapes the block kernel cannot hold (its shared memory, its
    16,384 points a cloud) are planned on the cluster variant; only
    non-positive sizes and int32 indexing are refused."""
    for b, n, k, limit in ((1, 20000, 4, H100["smem_limit"]),
                           (1, 16385, 4, 10**6)):
        plan = fp.plan_fps(b, n, k, sms=132, smem_limit=limit)
        assert plan.cluster and fp.valid(plan, n)
    with pytest.raises(ValueError, match="positive"):
        fp.plan_fps(0, 10, 4, **H100)
    with pytest.raises(ValueError, match="int32"):
        fp.plan_fps(1, 2**31, 4, **H100)


CAPS_FPS = {(50, 32768, 64): (2, 16), (2, 100003, 1024): (8, 16),
            (1, 2**20, 256): (16, 0), (2, 8192, 8192): (1, 8)}


@pytest.mark.parametrize("shape", list(CAPS_FPS))
def test_cluster_size_at_the_caps_shapes(shape):
    """chip_smoke.py's CAPS_FPS: C = 2 holds 50 clouds of 32,768 points in
    one wave (R = 16, 192 KB of slice), C = 1 takes k = N = 8192 with no
    cluster barrier, 100,003 points need C = 8, 2^20 stream at C = 16."""
    b, n, k = shape
    plan = fp.plan_fps(b, n, k, **H100)
    assert (plan.cluster, plan.points) == CAPS_FPS[shape]
    assert fp.valid(plan, n)
    if plan.points:
        at_once = fp.default_active(plan.cluster, plan.points, 132)
        assert -(-b // at_once) == 1


@pytest.mark.parametrize("n", [8193, 16385, 32768, 65536, 100003, 131072,
                               131073, 2**20])
def test_cluster_size_over_batches(n):
    """At B = 1 .. 4096 (k = N where a block's registers would hold the
    cloud): every plan holds the cloud; no C that holds it
    runs in fewer waves of what the card holds at once; on a tie the
    smallest C; streamed only where no build's slices hold the cloud."""
    cands = fp.cluster_candidates(n, smem_limit=H100["smem_limit"])
    k = n if n <= 16384 else 8     # k = N: the picks beyond one block
    for b in range(1, 4097):
        plan = fp.plan_fps(b, n, k, **H100)
        assert plan.cluster and fp.valid(plan, n), b
        assert plan.capacity >= n
        if not cands:
            assert plan.stream and plan.cluster == fp.STREAM_CLUSTER
            continue

        def waves(q):
            return -(-b // fp.default_active(q.cluster, q.points, 132))

        assert plan in cands, b
        assert all(waves(plan) < waves(q) or (waves(plan) == waves(q)
                                              and plan.cluster <= q.cluster)
                   for q in cands), b


def test_shared_memory_counts_the_kernels_layout():
    # 512 bytes of slots, the cloud padded to 16 bytes, 20 bytes a pick
    assert fp.fps_smem(1024, 32) == 512 + 12288 + 640
    assert fp.fps_smem(7, 7) == 512 + 96 + 140
