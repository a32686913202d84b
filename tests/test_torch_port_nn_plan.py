"""The 1-NN kernel's launch plan and partition, on the CPU.

The kernel (csrc/nn_direction.cu) serves each query with L lanes: lane l
scans the database points p = l, l + L, ... chunk by chunk in ascending
order, keeps its running minimum with min.NaN (canonical NaN 0x7fffffff)
and its index where the minimum's bits change, and a shuffle-down tree of
log2 L rounds merges a group's lanes, NaN first, then the smaller
distance, then the lower index. A block of 32 * warps threads holds
tiles of 32 * warps / L * Q queries of one cloud, query j of group g at
g + j * groups; a group past the tile's end computes a copy of its last
query and writes nothing. `_kernel_nn` follows all of that in numpy, on
float32 distances in the kernel's order, for every L, every Q and small
chunks, and is held to the port's `nn_direction_plain` bit for bit (NaN
distances by place), on exact ties that straddle lanes and chunks,
duplicated points, NaN and +-inf coordinates, rows of +inf distances,
databases smaller than L and tiles that end mid-block.

Against the JAX package: the plain version and the emulation on random
clouds against the Pallas `nn_direction` run in interpret mode, and on
NaN clouds against `pairwise.py::chunked_min_argmin` (the path off the
TPU; the interpreted Pallas kernel drops a chunk that holds a NaN, a
fault of the reference that test_torch_port_fps.py records). Tolerances
as in test_torch_port_ops.py and test_torch_port_fps.py: XLA:CPU contracts
the Pallas kernel's sum of squares into FMAs, so its dist is held at
rtol 3e-7 and its idx where the two nearest candidates are 1e-6 apart
(relative); `chunked_min_argmin` computes |x|^2 + |y|^2 - 2xy, so its dist
is held at rtol 1e-4 / atol 1e-6 where finite and its idx where the two
nearest are 1e-3 apart; at least 90% of the queries compared either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.ops.pairwise import chunked_min_argmin
from samplenet_tpu.ops.pallas import nn_direction as jax_nn_direction
from samplenet_tpu_torch.ops.cuda import nn_plan as npl
from samplenet_tpu_torch.ops.cuda.chamfer_kernel import (
    nn_direction,
    nn_direction_plain,
    nn_snap,
)

torch.set_num_threads(1)

SMS = 132                       # an H100 SXM
CANONICAL_NAN = 0x7FFFFFFF      # what min.NaN returns
SMALL_CHUNKS = (32, 64)


# -------------------------------------------------------------- emulation

def _dist32(x, y):
    """[B, N1, N2] float32 ((dx*dx + dy*dy) + dz*dz), rounded op by op."""
    with np.errstate(over="ignore", invalid="ignore"):
        d = x[:, :, None, :] - y[:, None, :, :]
        sq = d * d
        return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _min_nan(a, b):
    out = np.minimum(a, b)
    out.view(np.uint32)[np.isnan(out)] = CANONICAL_NAN
    return out


def _lane_scan(d, lane, lanes, chunk):
    """(best, index) of one lane over every query: points c0 + p, p = lane,
    lane + lanes, ... < cn, chunk by chunk."""
    n2 = d.shape[-1]
    best = np.full(d.shape[:-1], np.inf, np.float32)
    bi = np.zeros(d.shape[:-1], np.int32)
    for c0 in range(0, n2, chunk):
        for p in range(lane, min(chunk, n2 - c0), lanes):
            m = _min_nan(best, d[..., c0 + p])
            bi = np.where(m.view(np.uint32) != best.view(np.uint32), c0 + p, bi)
            best = m
    return best, bi


def _before(od, oi, d, i):
    """nn_merge_before, elementwise."""
    return np.where(np.isnan(od), ~np.isnan(d) | (oi < i),
                    (od < d) | ((od == d) & (oi < i)))


def _merge(ds, idxs):
    """The shuffle-down tree of a group's lanes (width L): in each round,
    lane l takes lane l + off's value where that comes first; lane 0 ends
    with the group's."""
    lanes, off = len(ds), len(ds) // 2
    while off:
        nd, ni = list(ds), list(idxs)
        for lane in range(lanes - off):
            take = _before(ds[lane + off], idxs[lane + off], ds[lane],
                           idxs[lane])
            nd[lane] = np.where(take, ds[lane + off], ds[lane])
            ni[lane] = np.where(take, idxs[lane + off], idxs[lane])
        ds, idxs, off = nd, ni, off // 2
    return ds[0], idxs[0]


def _kernel_nn(x, y, plan):
    """(dist, idx) as the kernel computes and writes them under `plan`;
    checks that the flat grid writes every query once."""
    b, n1, _ = x.shape
    d = _dist32(x, y)
    scans = [_lane_scan(d, lane, plan.lanes, plan.chunk)
             for lane in range(plan.lanes)]
    qd, qi = _merge([s[0] for s in scans], [s[1] for s in scans])
    dist = np.zeros((b, n1), np.float32)
    idx = np.full((b, n1), -1, np.int32)
    written = np.zeros(n1, int)
    groups = plan.threads // plan.lanes
    for t in range(plan.tiles(n1)):           # one block a tile, any cloud
        q0 = t * plan.tile
        nq = min(plan.tile, n1 - q0)
        for g in range(groups):
            for j in range(plan.queries):
                q = g + j * groups
                if q < nq:
                    written[q0 + q] += 1
                    dist[:, q0 + q], idx[:, q0 + q] = qd[:, q0 + q], \
                        qi[:, q0 + q]
    assert (written == 1).all()
    assert plan.grid(b, n1) == b * plan.tiles(n1)
    return dist, idx


def _same(dist, idx, ref_d, ref_i):
    """idx equal, dist bit-equal with NaN at the same places."""
    nan = np.isnan(ref_d)
    return (np.array_equal(idx, ref_i) and np.array_equal(np.isnan(dist), nan)
            and np.array_equal(dist[~nan].view(np.int32),
                               ref_d[~nan].view(np.int32)))


# ------------------------------------------------------------------ inputs

def _case(kind, seed):
    """(x, y) float32 of one edge case."""
    rng = np.random.default_rng(seed)
    if kind == "grid_ties":        # integer lattice, half-integer queries
        y = rng.integers(-2, 3, (2, 97, 3)).astype(np.float32)
        x = (rng.integers(-4, 5, (2, 45, 3)) / 2).astype(np.float32)
        return x, y
    if kind == "duplicates":       # each point 3 times, 37 apart (odd)
        base = rng.standard_normal((2, 37, 3)).astype(np.float32)
        y = np.concatenate([base, base, base], 1)
        x = np.concatenate([base[:, ::3], rng.standard_normal(
            (2, 20, 3)).astype(np.float32)], 1)
        return x, y
    x = rng.standard_normal((3, 41, 3)).astype(np.float32)
    y = rng.standard_normal((3, 130, 3)).astype(np.float32)
    if kind == "nan":              # NaN points in two lanes and chunks
        y[0, 37, 1] = np.nan
        y[0, 100, 0] = np.nan
        y[1, 65, 2] = np.nan
        x[2, 5] = np.nan
        x[1, 40, 0] = np.nan
    elif kind == "inf":
        y[0, 7, 0] = np.inf
        y[1, 70] = -np.inf
        x[2, 3, 1] = np.inf
        x[0, 11] = -np.inf
    elif kind == "all_inf_rows":   # every distance overflows to +inf
        x[0] = 1e20
        y[0] = -1e20
        x[1, :5] = 3e19
    elif kind == "few_points":     # N2 < L for most plans
        y = y[:, :3]
    elif kind != "randn":
        raise ValueError(kind)
    return x, y


KINDS = ("randn", "grid_ties", "duplicates", "nan", "inf", "all_inf_rows",
         "few_points")


@pytest.mark.parametrize("lanes", npl.LANES)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_emulation_matches_plain(kind, lanes):
    """Every Q and two small chunks at this L: the emulated kernel gives the
    plain version's bits."""
    x, y = _case(kind, KINDS.index(kind))
    ref_d, ref_i = (t.numpy() for t in nn_direction_plain(
        torch.from_numpy(x), torch.from_numpy(y)))
    b, n1, _ = x.shape
    for q in npl.QUERIES:
        for chunk in SMALL_CHUNKS:
            base = npl.make(n1, y.shape[1], lanes, q)
            plan = npl.NnPlan(lanes, q, base.warps, chunk)
            assert npl.valid(plan, b, n1, y.shape[1])
            d, i = _kernel_nn(x, y, plan)
            assert _same(d, i, ref_d, ref_i), plan


@pytest.mark.parametrize("warps", [1, 3, 8])
def test_tiles_that_end_mid_block(warps):
    """A ragged N1 (not a multiple of any tile) with other block widths:
    every query written once, with the plain version's bits."""
    x, y = _case("randn", 9)
    x = np.concatenate([x, x[:, :6]], 1)          # 47 queries
    ref_d, ref_i = (t.numpy() for t in nn_direction_plain(
        torch.from_numpy(x), torch.from_numpy(y)))
    for lanes in (1, 4, 32):
        for q in (1, 8):
            d, i = _kernel_nn(x, y, npl.NnPlan(lanes, q, warps, 32))
            assert _same(d, i, ref_d, ref_i)


def test_a_lane_without_points_never_wins_a_finite_row():
    """N2 = 1 under L = 32: 31 lanes hold (+inf, 0) and lose to the one
    point; a query at +inf distance from it gets index 0, as argmin."""
    x = np.array([[[0, 0, 0], [1e20, 0, 0]]], np.float32)
    y = np.array([[[-1e20, 0, 0]]], np.float32)
    d, i = _kernel_nn(x, y, npl.NnPlan(32, 1, 1, 32))
    assert np.isinf(d).all() and (i == 0).all()
    y = np.array([[[1.0, 2.0, 2.0]]], np.float32)
    d, i = _kernel_nn(x[:, :1], y, npl.NnPlan(32, 1, 1, 32))
    assert d[0, 0] == 9.0 and i[0, 0] == 0


# ---------------------------------------------------- against JAX

def _clear(x, y, gap):
    """[B, N1] bool: the two nearest candidates are `gap` apart, relative."""
    d = ((x[:, :, None].astype(np.float64) - y[:, None]) ** 2).sum(-1)
    two = np.sort(d, axis=-1)[..., :2]
    return two[..., 1] - two[..., 0] > gap * two[..., 1]


@pytest.mark.parametrize("b,n1,n2", [(2, 45, 130), (3, 33, 257), (1, 70, 9)])
def test_plain_and_emulation_match_pallas(b, n1, n2):
    rng = np.random.default_rng(n1 + n2)
    x = rng.standard_normal((b, n1, 3)).astype(np.float32)
    y = rng.standard_normal((b, n2, 3)).astype(np.float32)
    jd, ji = (np.asarray(a) for a in jax_nn_direction(
        jnp.asarray(x), jnp.asarray(y), tile_x=16, chunk=64, interpret=True))
    clear = _clear(x, y, 1e-6)
    assert clear.mean() >= 0.9
    pd, pi = (t.numpy() for t in nn_direction_plain(torch.from_numpy(x),
                                                    torch.from_numpy(y)))
    for lanes, q in ((1, 4), (8, 1), (32, 2)):
        d, i = _kernel_nn(x, y, npl.make(n1, n2, lanes, q))
        assert _same(d, i, pd, pi)
        np.testing.assert_allclose(d, jd, rtol=3e-7, atol=0)
        np.testing.assert_array_equal(i[clear], ji[clear])


@pytest.mark.parametrize("seed", [0, 1])
def test_nan_clouds_follow_chunked_min_argmin(seed):
    x, y = _case("nan", 10 + seed)
    wd, wi = (np.asarray(a) for a in chunked_min_argmin(jnp.asarray(x),
                                                        jnp.asarray(y)))
    assert np.isnan(wd).any()
    clear = _clear(x, y, 1e-3) | np.isnan(wd)
    assert clear.mean() >= 0.9
    for plan in (npl.make(41, 130, 1, 4), npl.make(41, 130, 16, 1)):
        d, i = _kernel_nn(x, y, plan)
        np.testing.assert_array_equal(np.isnan(d), np.isnan(wd))
        np.testing.assert_array_equal(i[clear], wi[clear])
        finite = ~np.isnan(wd)
        np.testing.assert_allclose(d[finite], wd[finite], rtol=1e-4,
                                   atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers return the plain version's bits (no plan and
    no kernel: the tensor lies on the CPU)."""
    x, y = (torch.from_numpy(a) for a in _case("duplicates", 3))
    d, i = nn_direction(x, y)
    pd, pi = nn_direction_plain(x, y)
    assert torch.equal(d, pd) and torch.equal(i, pi)
    sd, si, sp = nn_snap(x, y)
    assert torch.equal(sd, pd) and torch.equal(si, pi)
    assert torch.equal(sp, torch.gather(y, 1, pi.long()[..., None]
                                        .expand(-1, -1, 3)))


# ------------------------------------------------------------ the plan

def test_direction_2_takes_one_lane_a_query():
    """1024 queries over 32 points at B=1024: the queries fill the card, so
    a thread owns its queries and merges nothing."""
    p = npl.plan(1024, 1024, 32, SMS)
    assert (p.lanes, p.queries) == (1, npl.PLAN_QUERIES)
    assert 1024 * 1024 // p.queries >= SMS * npl.THREADS_PER_SM


def test_the_eval_shape_shares_lanes_until_the_card_is_full():
    """32 queries over 1024 points at B=1024 (the eval forward and the
    Chamfer loss's first direction): lanes shared by a query give 131072
    threads, 97% of THREADS_PER_SM an SM; one more doubling would leave a
    lane fewer than POINTS_PER_LANE points."""
    p = npl.plan(1024, 32, 1024, SMS)
    threads = 1024 * 32 * p.lanes // p.queries
    assert p.lanes > 1 and threads >= 0.9 * SMS * npl.THREADS_PER_SM
    assert 1024 < 2 * p.lanes * npl.POINTS_PER_LANE


PATH_SHAPES = [(1024, 32, 1024), (1024, 1024, 32), (50, 64, 2048),
               (50, 2048, 64), (32, 8, 1024), (32, 1024, 8), (32, 256, 1024),
               (32, 1024, 256), (32, 1024, 1024), (50, 16, 2048),
               (50, 2048, 16), (50, 2048, 2048)]


@pytest.mark.parametrize("b,n1,n2", PATH_SHAPES)
def test_plan_rules_at_the_paths_shapes(b, n1, n2):
    """Lanes double only while the card is short and each lane keeps
    POINTS_PER_LANE points; queries a thread halve only while fewer than
    MIN_THREADS_PER_SM threads an SM run."""
    p = npl.plan(b, n1, n2, SMS)
    threads = b * n1 * p.lanes // p.queries
    target = SMS * npl.THREADS_PER_SM
    if p.lanes > 1:
        assert b * n1 * (p.lanes // 2) // p.queries < target
        assert n2 >= p.lanes * npl.POINTS_PER_LANE
    assert (p.lanes == npl.LANES[-1] or threads >= target
            or n2 < 2 * p.lanes * npl.POINTS_PER_LANE)
    if p.queries < npl.PLAN_QUERIES:
        assert b * n1 * p.lanes // (2 * p.queries) < SMS * \
            npl.MIN_THREADS_PER_SM
    assert p.warps == min(npl.MAX_WARPS, -(-(-(-n1 // p.queries) * p.lanes)
                                          // 32))


@pytest.mark.parametrize("b", [1, 3, 50, 1024, 65536])
@pytest.mark.parametrize("n1", [1, 31, 1000, 2048, 2_097_121])
@pytest.mark.parametrize("n2", [1, 7, 33, 2048, 16384])
def test_plan_takes_any_shape(b, n1, n2):
    p = npl.plan(b, n1, n2, SMS)
    assert npl.valid(p, b, n1, n2)
    assert p.tiles(n1) * p.tile >= n1 and p.grid(b, n1) <= npl.MAX_GRID
    assert p.lanes <= max(1, n2)
    assert p.chunk == npl.nn_chunk(n2) and p.chunk % 32 == 0
    assert p.tile <= max(n1, p.threads // p.lanes * p.queries)


@pytest.mark.parametrize("n1,n2", [(1, 1), (32, 1024), (1024, 32),
                                   (2048, 2048), (5, 16384)])
def test_shared_memory_within_the_static_limit(n1, n2):
    """Every plan fits the 48 KB a block gets without opting in (the kernel
    opts into nothing): one chunk of float4, or two where the database
    takes several."""
    for p in npl.candidates(7, n1, n2):
        chunks = -(-n2 // p.chunk)
        assert p.smem(n2) == min(chunks, 2) * p.chunk * 16 <= 48 * 1024


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        npl.plan(0, 10, 10, SMS)
    with pytest.raises(ValueError):
        npl.plan(2**30, 100_000, 10, SMS)       # more than 2**31 - 1 blocks
    assert not npl.valid(npl.NnPlan(3, 4, 8, 1024), 1, 10, 10)
    assert not npl.valid(npl.NnPlan(4, 3, 8, 1024), 1, 10, 10)
    assert not npl.valid(npl.NnPlan(4, 4, 9, 1024), 1, 10, 10)
    assert not npl.valid(npl.NnPlan(4, 4, 8, 4096), 1, 10, 10)
    assert not npl.valid(npl.NnPlan(4, 4, 8, 100), 1, 10, 10)


def test_the_grid_of_the_largest_card_test_is_flat():
    """N1 = 32 * 65535 + 1 queries over 8 points at B=1: more query tiles
    than the 65535 a second grid axis could hold, one flat axis here."""
    n1 = 32 * 65535 + 1
    p = npl.plan(1, n1, 8, SMS)
    assert p.grid(1, n1) == p.tiles(n1) and p.tiles(n1) * p.tile >= n1
    for q in npl.candidates(1, n1, 8):
        assert q.grid(1, n1) <= npl.MAX_GRID
