"""The wide soft-projection backward (k > 16) on the CPU: its launch plan,
its two kernels emulated step by step in numpy, and the emulation against
the plain backward and the JAX package's VJP.

The first kernel (csrc/soft_projection.cu, soft_project_bwd_entries_warp)
serves a query with a group of G lanes (8 up to k = 64, else 32): lane l
of the group holds ranks j = G * J * bt + G * i + l (J = 4 or 8 a lane by
k, batches bt above 256 ranks), adds its terms of the weights' total and
the weighted points, then of d queries and d sigma^2, in that order in
float64, and the group's G partials meet in a butterfly (xor G/2, ..., 2,
1). `_emulate_entries` follows it; the butterfly leaves every lane the
same bits. The second (soft_project_bwd_points_wide) takes a cloud's
entries in windows, counts those on its block's points, scans the counts,
places each such entry in its point's segment in an order the atomics
choose (emulated here by shuffles), sorts each segment and adds the
contributions from +0.0f; where a block holds a cloud, a fused kernel
does both, its window the whole cloud: `_emulate_points` must visit each
point's entries in the order of a stable argsort of idx under every plan
and every placement order. The emulated outputs are held to the plain
backward (f32) and to `jax.vjp` of `_soft_project_ref` in float64 at rtol
1e-4 / atol 1e-5, the card tests' rule for the kernels.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.ops.pallas.soft_projection_kernel import _soft_project_ref
from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp
from samplenet_tpu_torch.ops.cuda.soft_projection_kernel import (
    soft_project_bwd_plain,
)
from tests.test_torch_port_softproj_bwd import _entries, _stable_groups

torch.set_num_threads(1)

H100_SMS = 132
H100_SMEM = 232448
# (B, N, M, k) of the paths that run the wide backward: the classification
# step at --group-size 32, B=4 at k=256, the reconstruction CLI's sampler at
# 32,768 points, and edge shapes
WIDE_PATH_SHAPES = [(1024, 1024, 32, 32), (4, 1024, 64, 256),
                    (4, 32768, 64, 32), (1, 256, 2**26, 32),
                    (2, 50, 300, 17), (65536, 40, 2, 17), (3, 1000, 33, 17),
                    (1, 17, 1, 17), (200, 2048, 64, 1024)]


@pytest.mark.parametrize("b,n,m,k", WIDE_PATH_SHAPES)
@pytest.mark.parametrize("sms", [1, 132])
def test_wide_plan_rules(b, n, m, k, sms):
    plan = spp.plan_bwd_wide(b, n, m, k, sms=sms)
    assert plan == spp.plan_bwd_wide(b, n, m, k, sms=sms)
    # k moves only the choice of the fused kernel
    assert replace(plan, fused=False) == replace(
        spp.plan_bwd_wide(b, n, m, 17, sms=sms), fused=False)
    assert plan.fused == spp.takes_fused(b, n, m, k, sms=sms)
    if plan.fused:
        assert b >= sms and m * k <= spp.FUSED_ENTRIES
        assert n <= spp.WIDE_POINTS_PER * plan.threads
        assert plan.threads == spp.FUSED_THREADS <= 32 * spp.WIDE_BWD_WARPS
        assert spp.fused_bwd_smem(n, m, k) + 256 * 8 + 32 * 4 <= H100_SMEM
        assert plan.grids(b, n, m, k) == (b, 0)
        plan = replace(plan, fused=False)
    assert 1 <= plan.warps <= spp.WIDE_BWD_WARPS
    assert plan.threads in (256, spp.WIDE_POINT_THREADS)
    assert spp.MIN_WIDE_SPAN <= plan.span <= spp.WIDE_SPAN
    assert plan.span <= spp.WIDE_POINTS_PER * plan.threads
    assert plan.span & (plan.span - 1) == 0
    assert plan.smem == spp.wide_bwd_smem(plan.threads, plan.span)
    assert plan.smem + 256 * 8 + 32 * 4 <= H100_SMEM
    for kk in (17, 64, 65, 1024):
        first, points = plan.grids(b, n, m, kk)
        per_warp = 32 // spp.wide_group(kk)
        assert first == -(-b * m // (plan.warps * per_warp)) <= spp.MAX_GRID_X
        assert points == b * -(-n // plan.span) <= spp.MAX_GRID_X
    # every SM gets a block of each kernel where the shape allows it (a
    # warp a query)
    if plan.warps > 1:
        assert -(-b * m // plan.warps) >= sms
    if plan.span > spp.MIN_WIDE_SPAN:
        assert b * -(-n // plan.span) >= sms
    assert (plan.threads == 256) == (b >= sms)


def test_wide_plan_at_the_caps_shapes():
    assert spp.plan_bwd_wide(1024, 1024, 32, 32, sms=132) == \
        spp.WideBwdPlan(warps=8, threads=256, span=1024, fused=True)
    assert spp.plan_bwd_wide(4, 1024, 64, 256, sms=132) == \
        spp.WideBwdPlan(warps=1, threads=1024, span=32)
    assert spp.plan_bwd_wide(4, 32768, 64, 32, sms=132) == \
        spp.WideBwdPlan(warps=1, threads=1024, span=512)


def test_wide_plan_refuses_what_the_grids_do_not_hold():
    with pytest.raises(ValueError, match="positive"):
        spp.plan_bwd_wide(1, 0, 4, 17, sms=132)
    with pytest.raises(ValueError, match="positive"):
        spp.plan_bwd_wide(1, 64, 4, 17, sms=0)
    with pytest.raises(ValueError, match="grids"):
        spp.plan_bwd_wide(2**31, 1024, 64, 32, sms=132)
    with pytest.raises(ValueError, match="grids"):
        spp.plan_bwd_wide(1, 64, 2**34, 65, sms=132)     # a warp a query
    spp.plan_bwd_wide(1, 64, 2**34, 64, sms=132)         # four a warp
    spp.plan_bwd_wide(2**31 // 2 - 1, 32, 1, 17, sms=132)


# ------------------------------------------------ the first kernel

def _ranks(k: int) -> tuple[int, np.ndarray]:
    """G (lanes a query) and order [G, positions]: the ranks lane l of a
    group adds, in its order (-1 past k)."""
    g = spp.wide_group(k)
    j = 4 if k <= 4 * g else spp.WIDE_RANKS
    batches = -(-k // (g * j))
    order = np.array([[bt * g * j + g * i + lane
                       for bt in range(batches) for i in range(j)]
                      for lane in range(g)])
    return g, np.where(order < k, order, -1)


def _butterfly(v: np.ndarray) -> np.ndarray:
    """The group's shuffle tree over the last axis (G lanes): each level
    adds the partner's value (lane ^ off) to the lane's own."""
    g = v.shape[-1]
    off = g // 2
    while off:
        v = v + v[..., np.arange(g) ^ off]
        off //= 2
    return v


def _lane_sums(terms: np.ndarray, order: np.ndarray) -> np.ndarray:
    """terms [..., k] in float64, added a lane at a time in the lane's rank
    order from 0.0, then the butterfly: [..., G] (all lanes alike)."""
    acc = np.zeros(terms.shape[:-1] + (order.shape[0],))
    for pos in range(order.shape[1]):
        j = order[:, pos]
        acc = acc + np.where(j >= 0, terms[..., np.maximum(j, 0)], 0.0)
    return _butterfly(acc)


def _emulate_entries(pts, qs, sigma, cot, idx):
    """The first kernel on one set of clouds: contributions [B, M, k, 3]
    (f32), d queries [B, M, 3] (f32) and each query's d sigma^2 term
    [B, M] (f64)."""
    _, order = _ranks(idx.shape[-1])
    g = np.take_along_axis(pts[:, None], idx[..., None].astype(np.int64),
                           axis=2)                           # [B, M, k, 3]
    delta = g - qs[:, :, None]
    d = (delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1]) \
        + delta[..., 2] * delta[..., 2]                      # f32
    dd = (d - d[..., :1]).astype(np.float32)
    term = np.exp(-dd / np.float32(sigma)).astype(np.float32)
    t64 = term.astype(np.float64)
    den = _lane_sums(t64, order)
    assert (den == den[..., :1]).all()                      # every lane
    inv = 1.0 / den[..., :1]
    g64, q64, c64 = g.astype(np.float64), qs.astype(np.float64), \
        cot.astype(np.float64)
    tp = np.stack([_lane_sums(t64 * g64[..., a], order)[..., 0]
                   for a in range(3)], -1)                  # [B, M, 3]
    ubar = (c64[..., 0:1] * tp[..., 0:1] + c64[..., 1:2] * tp[..., 1:2]
            + c64[..., 2:3] * tp[..., 2:3]) * inv
    w = t64 * inv
    u = (c64[:, :, None, 0] * g64[..., 0] + c64[:, :, None, 1] * g64[..., 1]
         + c64[:, :, None, 2] * g64[..., 2])
    e = w * (u - ubar)
    two_dd = e * (-2.0 / np.float64(np.float32(sigma)))
    ex = g64 - q64[:, :, None]
    contrib = (w[..., None] * c64[:, :, None] + two_dd[..., None] * ex
               ).astype(np.float32)
    dq = np.stack([_lane_sums(-two_dd * ex[..., a], order)[..., 0]
                   for a in range(3)], -1).astype(np.float32)
    ds = _lane_sums(e * dd.astype(np.float64), order)[..., 0]
    return contrib, dq, ds


@pytest.mark.parametrize("k", [17, 32, 33, 64, 65, 128, 200, 256, 257,
                               600])
def test_a_lane_holds_its_ranks_once_in_order(k):
    g, order = _ranks(k)
    assert g == (8 if k <= 64 else 32)
    held = np.sort(order[order >= 0])
    np.testing.assert_array_equal(held, np.arange(k))
    assert order.shape[1] <= spp.WIDE_RANKS * -(-k // (g * spp.WIDE_RANKS))
    for lane in range(g):
        mine = order[lane][order[lane] >= 0]
        assert (np.diff(mine) > 0).all() and (mine % g == lane).all()


@pytest.mark.parametrize("g", [8, 32])
def test_the_butterfly_gives_every_lane_the_same_bits(g):
    rng = np.random.default_rng(7)
    v = rng.standard_normal((500, g)) * 10.0 ** rng.integers(-8, 8, (500, g))
    out = _butterfly(v)
    assert (out == out[:, :1]).all()
    np.testing.assert_allclose(out[:, 0], v.sum(-1), rtol=1e-12, atol=0)


# ------------------------------------------------ the point kernel

def _emulate_points(flat: np.ndarray, n: int, plan: spp.WideBwdPlan,
                    rng) -> list[list[int]]:
    """The entries each point of one cloud adds, in the order the point
    kernel adds them; flat is idx[b] as [M * k]. Each block takes its
    span's entries window by window: counts, an exclusive scan, places in
    its point's segment in an order of the atomics' choosing (shuffled),
    then the segment sorted."""
    # fused: one block a cloud, every entry in one window
    window = flat.size if plan.fused else spp.WINDOW_PER * plan.threads
    span = n if plan.fused else plan.span
    visits: list[list[int]] = [[] for _ in range(n)]
    for p0 in range(0, n, span):
        np_ = min(span, n - p0)
        for w0 in range(0, flat.size, window):
            # thread t's kWindowPer loads: entries w0 + u * threads + t
            es = np.arange(w0, min(w0 + window, flat.size))
            p = flat[es] - p0
            mine = (p >= 0) & (p < np_)
            counts = np.bincount(p[mine], minlength=np_)
            off = np.concatenate([[0], np.cumsum(counts)])
            cur = off[:-1].copy()
            lst = np.full(window, -1)
            for e in rng.permutation(es[mine]):     # the atomics' order
                lst[cur[flat[e] - p0]] = e - w0
                cur[flat[e] - p0] += 1
            assert (cur == off[1:]).all() and off[-1] == mine.sum()
            for pp in range(np_):
                seg = np.sort(lst[off[pp]:off[pp + 1]])
                visits[p0 + pp] += (seg + w0).tolist()
    return visits


WIDE_PLANS = [spp.WideBwdPlan(1, 32, 1), spp.WideBwdPlan(8, 32, 32),
              spp.WideBwdPlan(2, 128, 100), spp.WideBwdPlan(4, 256, 1024),
              spp.WideBwdPlan(1, 64, 77),
              spp.WideBwdPlan(8, 256, 1024, fused=True)]


@pytest.mark.parametrize("plan", WIDE_PLANS,
                         ids=lambda p: f"t{p.threads}s{p.span}f{p.fused:d}")
@pytest.mark.parametrize("kind,b,n,m,k", [("knn", 2, 150, 21, 17),
                                          ("collision", 1, 40, 37, 20),
                                          ("few", 1, 300, 40, 33),
                                          ("dups", 2, 70, 290, 17)])
def test_point_order_is_the_stable_sort(plan, kind, b, n, m, k):
    pts, qs, sigma, cot, idx = _entries(b, n, m, k, kind, seed=n + m + k)
    rng = np.random.default_rng(k)
    for bi in range(b):
        flat = idx[bi].reshape(-1)
        assert _emulate_points(flat, n, plan, rng) == _stable_groups(flat, n)


def _emulate_dsigma(ds: np.ndarray, sigma) -> np.float32:
    """d sigma^2 of one cloud as its last point block sums it, in float64:
    stripe s adds the terms of queries s, s + 256, ..., then a tree."""
    red = np.zeros(spp.STRIPES)
    for s in range(min(ds.size, spp.STRIPES)):
        for q in range(s, ds.size, spp.STRIPES):
            red[s] = red[s] + ds[q]
    half = spp.STRIPES // 2
    while half:
        red[:half] = red[:half] + red[half:2 * half]
        half //= 2
    s64 = np.float64(np.float32(sigma))
    return np.float32(red[0] / (s64 * s64))


def _emulate_wide(pts, qs, sigma, cot, idx, plan):
    b, n, _ = pts.shape
    contrib, dq, ds = _emulate_entries(pts, qs, sigma, cot, idx)
    dp = np.zeros((b, n, 3), dtype=np.float32)
    rng = np.random.default_rng(3)
    total = np.float32(0.0)
    for bi in range(b):
        flat = idx[bi].reshape(-1)
        cf = contrib[bi].reshape(-1, 3)
        for p, ents in enumerate(_emulate_points(flat, n, plan, rng)):
            for ent in ents:
                dp[bi, p] = dp[bi, p] + cf[ent]
        total = np.float32(total + _emulate_dsigma(ds[bi], sigma))
    return dp, dq, total


@pytest.mark.parametrize("kind,b,n,m,k", [
    ("knn", 2, 300, 20, 17),
    ("knn", 2, 200, 9, 40),
    ("knn", 1, 400, 6, 300),       # J = 8 in two batches
    ("knn", 3, 77, 5, 77),         # k = N
    ("collision", 1, 50, 30, 24),  # one point takes every entry
    ("dups", 2, 64, 12, 33),       # repeats within a query
])
def test_emulated_wide_backward_matches_plain_and_jax(kind, b, n, m, k):
    pts, qs, sigma, cot, idx = _entries(b, n, m, k, kind, seed=5 * n + k)
    dp, dq, ds = _emulate_wide(pts, qs, sigma, cot, idx,
                               spp.plan_bwd_wide(b, n, m, k, sms=132))
    plain = soft_project_bwd_plain(
        *(torch.from_numpy(a) for a in (pts, qs, np.array([sigma]), idx,
                                        cot)))
    with jax.enable_x64(True):
        _, vjp = jax.vjp(lambda p, q, s: _soft_project_ref(p, q, s, idx),
                         *(jnp.asarray(a, jnp.float64)
                           for a in (pts, qs, sigma)))
        ref = [np.asarray(w) for w in vjp(jnp.asarray(cot, jnp.float64))]
    for got, want, r in zip((dp, dq, np.array([ds])), plain, ref):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, r.reshape(got.shape), rtol=1e-4,
                                   atol=1e-5)
    # the sums in entry order: the same bits under other plans, the fused
    # kernel's among them
    for other in (spp.WideBwdPlan(1, 32, 7),
                  spp.WideBwdPlan(8, 256, 1024, fused=True)):
        again = _emulate_wide(pts, qs, sigma, cot, idx, other)
        for a, c in zip((dp, dq, ds), again):
            np.testing.assert_array_equal(a, c)
