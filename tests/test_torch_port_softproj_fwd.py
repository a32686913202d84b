"""The soft-projection forward on the CPU: its NaN semantics against the
JAX package, the selection its kernel runs (emulated lane by lane), and
the kernel's launch plan.

NaN: a NaN distance counts as +inf in the port (plain version and
kernel), so a point with a NaN coordinate is never chosen ahead of a
finite one, and a NaN query takes points 0..k-1. The JAX package's XLA
path (`knn_point`, the soft projection with use_pallas=False, which a GPU
runs) agrees on idx and out; its Pallas kernel, run in interpret mode,
picks the NaN point first and returns NaN (ROADMAP Queue 3, deviations).

Selection: csrc/soft_projection.cu serves a query with `slices` lanes in
two passes over G groups of ceil(n / G) consecutive points (G = 16 for
k <= 8, 32 above). The first keeps the least distance of each group; the
k-th smallest of those G minima bounds the k-th neighbour's distance from
above, and only the groups whose minimum is at or below it can hold a
point that is. The second rescans those groups, the query's lanes taking
every slices-th point; each lane buffers every point whose (d, index)
comes before (bound, INT_MAX), 32 at most, and inserts the buffer into
its sorted list of k when it is full (the full list's k-th entry then
becomes its bound) and at the end; the lanes' lists then merge by a
butterfly. `_kernel_topk` follows it step by step in numpy, on the
kernel's f32 distances, and is held to the plain version's stable sort
bit for bit, with inputs that fill a buffer (a cluster in one group).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.models.soft_projection import (
    SoftProjection as JaxSoftProjection,
)
from samplenet_tpu.ops.knn import knn_point
from samplenet_tpu.ops.pallas.soft_projection_kernel import (
    fused_soft_projection,
)
from samplenet_tpu_torch.ops.cuda import soft_project
from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp
from samplenet_tpu_torch.ops.cuda.soft_projection_kernel import (
    soft_project_fwd_plain,
)

torch.set_num_threads(1)

NAN_POINT = 5


def _nan_cloud(seed=0, n=16, m=4):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((1, n, 3)).astype(np.float32)
    qs = rng.standard_normal((1, m, 3)).astype(np.float32)
    pts[0, NAN_POINT, 1] = np.nan
    return pts, qs


def _xla_project(pts, qs, k, sigma):
    proj = JaxSoftProjection(group_size=k, sigma_mode="tf",
                             initial_temperature=float(np.sqrt(sigma)),
                             use_pallas=False)
    v = proj.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(qs))
    out, _, _ = proj.apply(v, jnp.asarray(pts), jnp.asarray(qs),
                           method=JaxSoftProjection.project)
    return np.asarray(out)


@pytest.mark.parametrize("seed,k", [(0, 3), (1, 3), (2, 7)])
def test_nan_point_follows_the_xla_path(seed, k):
    pts, qs = _nan_cloud(seed)
    sigma = np.float32(0.5)
    out, idx = soft_project(torch.from_numpy(pts), torch.from_numpy(qs),
                            torch.tensor(sigma), k)
    _, want_idx = knn_point(k, jnp.asarray(pts), jnp.asarray(qs))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert not (idx.numpy() == NAN_POINT).any()
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), _xla_project(pts, qs, k, sigma),
                               rtol=1e-5, atol=1e-6)


def test_nan_point_comes_first_in_the_interpreted_pallas_kernel():
    """The deviation the port records: the TPU kernel's argmin returns the
    NaN first (seed 0, k=3: idx [5, 14, 2] for query 0, where the XLA path
    and the port give [14, 2, 6]), and its output is NaN."""
    pts, qs = _nan_cloud(0)
    out, idx = fused_soft_projection(
        jnp.asarray(pts), jnp.asarray(qs), jnp.asarray(np.float32(0.5)),
        group_size=3, interpret=True)
    idx = np.asarray(idx)
    assert (idx[..., 0] == NAN_POINT).all()
    assert idx[0, 0].tolist() == [5, 14, 2]
    assert np.isnan(np.asarray(out)).all()
    _, port_idx = soft_project(torch.from_numpy(pts), torch.from_numpy(qs),
                               torch.tensor(0.5), 3)
    assert port_idx[0, 0].tolist() == [14, 2, 6]


@pytest.mark.parametrize("k", [1, 7, 16])
def test_nan_query_takes_the_lowest_indices(k):
    rng = np.random.default_rng(k)
    pts = torch.from_numpy(rng.standard_normal((2, 40, 3)).astype(np.float32))
    qs = torch.from_numpy(rng.standard_normal((2, 5, 3)).astype(np.float32))
    qs[1, 2, 0] = float("nan")
    out, idx = soft_project(pts, qs, torch.tensor(0.5), k)
    assert idx[1, 2].tolist() == list(range(k))
    clean = torch.ones(2, 5, dtype=torch.bool)
    clean[1, 2] = False
    assert bool(torch.isfinite(out[clean]).all())


# ---------------------------------------------- the kernel's selection

INF = np.float32(np.inf)
IMAX = np.iinfo(np.int32).max


def _before(d, i, bd, bi):
    return (d < bd) | ((d == bd) & (i < bi))


def _insert(ld, li, d, i):
    """The kernel's insert<K>: (d, i) into the sorted list, if it comes
    before the last entry."""
    k = len(ld)
    if not _before(d, i, ld[k - 1], li[k - 1]):
        return
    for j in range(k - 1, 0, -1):
        if _before(d, i, ld[j - 1], li[j - 1]):
            ld[j], li[j] = ld[j - 1], li[j - 1]
        elif _before(d, i, ld[j], li[j]):
            ld[j], li[j] = d, i
    if _before(d, i, ld[0], li[0]):
        ld[0], li[0] = d, i


def _kernel_topk(dist, k, chunk, slices):
    """One query's idx as the kernel's lanes select it, from its f32
    distances (NaN where the kernel's sqdist gives NaN), the cloud staged
    `chunk` points at a time; and how often a lane's buffer filled."""
    n, groups = len(dist), 16 if k <= 8 else 32
    size = -(-n // groups)                 # group g: [g, g + 1) * size
    gmin = np.full(groups, INF)            # pass 1: fminf, a NaN never wins
    for p, d in enumerate(dist):
        gmin[p // size] = np.fmin(gmin[p // size], d)
    tau = np.sort(gmin)[k - 1]
    near = [g for g in range(groups) if gmin[g] <= tau]
    order = [[] for _ in range(slices)]    # each lane's points, in order
    for c0 in range(0, n, chunk):
        end = min(c0 + chunk, n)
        for g in near:
            lo, hi = max(g * size, c0), min(g * size + size, end)
            for s in range(slices):
                order[s] += range(lo + s, hi, slices)
    lists, fills = [], 0
    for s in range(slices):                # pass 2, lane by lane
        ld, li, td, ti, buf = [INF] * k, [IMAX] * k, tau, IMAX, []
        for p in order[s]:
            d = np.fmin(dist[p], INF)      # NaN as +inf
            if not _before(d, p, td, ti):
                continue
            if len(buf) == 32:
                for e in buf:
                    _insert(ld, li, *e)
                buf, fills = [], fills + 1
                if li[k - 1] != IMAX:
                    td, ti = ld[k - 1], li[k - 1]
            buf.append((d, p))
        for e in buf:
            _insert(ld, li, *e)
        lists.append((ld, li))
    off = 1
    while off < slices:                    # the butterfly
        old = [(list(ld), list(li)) for ld, li in lists]
        for s, (ld, li) in enumerate(lists):
            for e in zip(*old[s ^ off]):
                _insert(ld, li, *e)
        off *= 2
    return np.asarray(lists[0][1]), fills


def _selection_inputs(kind, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((1, n, 3)).astype(np.float32)
    qs = rng.standard_normal((1, 3, 3)).astype(np.float32)
    if kind == "nan points":
        pts[0, rng.integers(0, n, size=max(1, n // 4))] = np.nan
    elif kind == "nan query":
        qs[0, 1] = np.nan
    elif kind == "triples":      # every point three times, on a grid
        grid = rng.integers(-2, 3, size=(-(-n // 3), 3)).astype(np.float32)
        pts[0] = np.repeat(grid, 3, axis=0)[:n]
        qs[0] = rng.integers(-2, 3, size=(3, 3)) + np.array([0, 0.5, 0.5])[
            :, None]
    elif kind == "overflow":     # d = +inf for half the cloud
        pts[0, :n // 2] = 1e30
    elif kind == "cluster":
        # the first 64 points, the kernel's group 0 here, next to the first
        # query: each of its candidates lies in that one group
        pts[0, :64] = qs[0, 0] + 1e-3 * rng.standard_normal(
            (64, 3)).astype(np.float32)
    return pts, qs


@pytest.mark.parametrize("kind,n,k,chunk,slices", [
    ("randn", 1024, 7, 1024, 4),
    ("randn", 300, 16, 320, 1),
    ("randn", 20, 16, 32, 8),    # n < 32
    ("randn", 100, 16, 32, 2),   # several chunks
    ("nan points", 257, 7, 288, 8),
    ("nan points", 31, 1, 32, 1),
    ("nan query", 130, 16, 64, 4),
    ("triples", 96, 7, 96, 2),
    ("triples", 200, 16, 64, 8),
    ("overflow", 70, 16, 96, 4),
    ("cluster", 2048, 16, 2048, 1),  # 64 candidates: the buffer fills
    ("cluster", 1024, 7, 512, 2),
])
def test_kernel_selection_matches_the_stable_sort(kind, n, k, chunk, slices):
    pts, qs = _selection_inputs(kind, n, seed=n + k)
    pts_t, qs_t = torch.from_numpy(pts), torch.from_numpy(qs)
    _, want = soft_project_fwd_plain(pts_t, qs_t, torch.tensor([0.5]), k)
    d = qs_t[0, :, None, :] - pts_t[0, None, :, :]
    dist = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
            + d[..., 2] * d[..., 2]).numpy()
    fills = 0
    for qi in range(qs.shape[1]):
        got, full = _kernel_topk(dist[qi], k, chunk, slices)
        np.testing.assert_array_equal(got, want[0, qi].numpy())
        fills += full
    if kind == "cluster":        # a buffer filled and was sorted early
        assert fills > 0
    if kind == "randn":
        assert fills == 0


# ------------------------------------------------------- the launch plan

# (B, N, M): the classification train step, the reconstruction sampler
# step, the progressive classification step and the progressive AE step
PATH_SHAPES = [(1024, 1024, 32), (50, 2048, 64), (32, 1024, 1024),
               (50, 2048, 2048)]


@pytest.mark.parametrize("b,n,m", PATH_SHAPES + [(3, 1000, 33), (2, 5000, 40),
                                                 (1, 1, 1), (7, 20, 200)])
@pytest.mark.parametrize("sms", [1, 132])
def test_plan_covers_every_query(b, n, m, sms):
    plan = spp.plan_fwd(b, n, m, sms=sms)
    assert plan.grid[0] == b
    assert (plan.grid[1] - 1) * plan.tile < m <= plan.grid[1] * plan.tile
    assert 1 <= plan.warps <= spp.MAX_WARPS
    assert plan.slices in (1, 2, 4, 8)
    assert plan.warps == min(spp.MAX_WARPS, -(-m * plan.slices // 32))
    assert plan.chunk % 32 == 0 and 32 <= plan.chunk <= spp.MAX_CHUNK
    assert plan.chunk >= min(n, spp.MAX_CHUNK)
    assert plan.smem == plan.chunk * 16 <= 64 * 1024


def test_plan_at_the_paths_shapes():
    plans = [spp.plan_fwd(*shape, sms=132) for shape in PATH_SHAPES]
    # 32768 queries: four lanes each give 30 warps an SM; a block a cloud
    assert (plans[0].slices, plans[0].warps, plans[0].grid) == (4, 4,
                                                                (1024, 1))
    # 3200 queries: eight lanes each, the most; 100 blocks of 8 warps
    assert (plans[1].slices, plans[1].warps, plans[1].grid) == (8, 8,
                                                                (50, 2))
    assert (plans[2].slices, plans[2].warps, plans[2].grid) == (4, 8,
                                                                (32, 16))
    # 102400 queries: two lanes each
    assert (plans[3].slices, plans[3].warps, plans[3].grid) == (2, 8,
                                                                (50, 16))


def test_plan_stages_long_clouds_in_chunks():
    plan = spp.plan_fwd(4, 10000, 64, sms=132)
    assert plan.chunk == spp.MAX_CHUNK
    assert spp.fwd_chunk(33) == 64 and spp.fwd_chunk(4096) == 4096
    assert spp.fwd_smem(2048) == 32768


def test_plan_refuses_what_the_kernel_cannot_launch():
    with pytest.raises(ValueError, match="positive"):
        spp.plan_fwd(1, 0, 4, sms=132)
    with pytest.raises(ValueError, match="positive"):
        spp.plan_fwd(1, 64, 4, sms=0)
    with pytest.raises(ValueError, match="grid"):
        spp.plan_fwd(1, 64, 256 * 70000, sms=132)
