"""The soft-projection backward on the CPU: its launch plan, the order in
which its kernels sum each point's entries (emulated step by step in
numpy), and the plain backward against the JAX package's VJP.

The kernels (csrc/soft_projection.cu): the first writes, for every entry
e = (query, rank) of a cloud, its contribution to d points; the second
gives each block `span` consecutive points of one cloud. A block streams
the cloud's M*k entries in rounds, lane `lane` of warp w taking entries
r0 + 32 * (UNROLL * w + u) + lane; each warp keeps those on the block's
points at its place in the round's list (the warps before it, then
popc of the ballots before, then popc(ballot & lanes below)); the list is
then taken `threads` entries a slice, each warp groups its 32 lanes by
point (match_any), the lowest lane of a group writes the group's lanes
into a [warps, span] table of masks and sets the warp's bit in the
point's flag word, and the thread that owns a point reads its flags, then
those masks warp by warp, lane by lane, adds those entries and clears its
flags. `_emulate_points` follows those steps and must visit each point's
entries in the order of a stable argsort of idx, under every plan; its
f32 sums in that order, and d sigma^2 summed as the last block of a cloud
sums it (256 query stripes, then a tree), are held to the plain backward
at rtol 1e-4 / atol 1e-5, the card tests' rule for the kernels (a point
that takes all 592 entries sums them serially, the plain version's bmm in
blocks).

The plain backward against `jax.vjp` of `_soft_project_ref` (the JAX
VJP's own recomputation from saved indices), run in float64, at rtol 1e-4
/ atol 1e-5, as tests/test_torch_port_train_softproj.py holds it against
the f32 VJP. float64, because in f32 the JAX VJP loses d sigma^2 to
cancellation where a query's k distances are large and equal: where every
entry lies on one point its exact value is 0, which the plain version
gives and the f32 VJP misses by 2.4e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.ops.pallas.soft_projection_kernel import _soft_project_ref
from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp
from samplenet_tpu_torch.ops.cuda.soft_projection_kernel import (
    soft_project_bwd_plain,
    soft_project_fwd_plain,
)

torch.set_num_threads(1)

# (B, N, M, k): the classification train step, the reconstruction sampler
# step, the progressive classification step and the progressive AE step
PATH_SHAPES = [(1024, 1024, 32, 7), (50, 2048, 64, 16), (32, 1024, 1024, 7),
               (50, 2048, 2048, 16)]
EDGE_SHAPES = [(1, 1, 1, 1),            # N = 1
               (2, 16, 5, 16),          # k = N
               (5, 300, 77, 7),         # M not a multiple of the tile
               (3, 1000, 33, 16),       # ragged
               (2, 16384, 64, 16),      # above the old shared-memory cap
               (1, 16384, 8, 16),
               (65536, 32, 1, 1),       # above a 16-bit grid dimension
               (70000, 300, 2, 2)]


def _per(plan: spp.BwdPlan) -> int:
    """Points a thread of the point kernel."""
    return plan.span // plan.threads


def _round(plan: spp.BwdPlan) -> int:
    """Entries a point block streams a round."""
    return 32 * spp.UNROLL * (plan.threads // 32)


def _is_pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


@pytest.mark.parametrize("b,n,m,k", PATH_SHAPES + EDGE_SHAPES)
@pytest.mark.parametrize("sms", [1, 132])
def test_bwd_plan_rules(b, n, m, k, sms):
    plan = spp.plan_bwd(b, n, m, k, sms=sms)
    # the first kernel: the largest tile that gives every SM a block
    assert _is_pow2(plan.tile) and 32 <= plan.tile <= spp.MAX_TILE
    blocks = -(-b * m // plan.tile)
    assert plan.tile == 32 or blocks >= sms
    assert plan.tile == spp.MAX_TILE or -(-b * m // (2 * plan.tile)) < sms
    # the second: SPAN points a block, fewer where the cloud is smaller; a
    # thread a point where the clouds are fewer than the SMs, else four
    assert plan.span == min(spp.SPAN, max(32, 1 << (n - 1).bit_length()))
    assert _is_pow2(plan.span) and plan.span >= min(n, spp.SPAN)
    assert plan.threads == (plan.span if b < sms
                            else max(32, plan.span // spp.MAX_PER))
    assert plan.threads % 32 == 0 and plan.span % plan.threads == 0
    assert 1 <= _per(plan) <= spp.MAX_PER
    # both grids are flat: the first's blocks, and B * (ranges + 1)
    assert blocks <= spp.MAX_GRID_X
    assert b * (-(-n // plan.span) + 1) <= spp.MAX_GRID_X
    warps = plan.threads // 32
    smem = spp.bwd_smem(plan.threads, plan.span, m * k)
    assert smem == ((warps + 1) * plan.span * 4
                    + max(min(_round(plan), m * k) * 20, plan.span * 12))
    # the most the kernel takes: 256 threads, 1024 points
    assert smem <= spp.bwd_smem(256, 1024, 2**30) == 57344


def test_bwd_plan_at_the_paths_shapes():
    got = [spp.plan_bwd(*shape, sms=132) for shape in PATH_SHAPES]
    # 1024 clouds: four points a thread, 4096 blocks of 64 threads
    assert got[0] == spp.BwdPlan(tile=128, threads=64, span=256)
    # 50 clouds: eight ranges of 256 points, 400 blocks; 3200 queries, 100
    # tiles
    assert got[1] == spp.BwdPlan(tile=32, threads=256, span=256)
    # 32 clouds of 1024: four ranges, 128 blocks
    assert got[2] == spp.BwdPlan(tile=128, threads=256, span=256)
    assert got[3] == spp.BwdPlan(tile=256, threads=256, span=256)
    # block i of the first kernel takes the flat queries [i * tile, (i + 1)
    # * tile): at the classification step's 32 queries a cloud, 4 clouds
    most = [max(len({q // s[2] for q in range(i, min(i + p.tile,
                                                      s[0] * s[2]))})
                for i in range(0, s[0] * s[2], p.tile))
            for p, s in zip(got, PATH_SHAPES)]
    assert most == [4, 1, 1, 1]


def test_bwd_plan_refuses_what_the_kernels_cannot_launch():
    with pytest.raises(ValueError, match="positive"):
        spp.plan_bwd(1, 0, 4, 1, sms=132)
    with pytest.raises(ValueError, match="positive"):
        spp.plan_bwd(1, 64, 4, 7, sms=0)
    # 2^32 entries in one cloud: taken since the point kernel counts them
    # in 64 bits there (it refused them while it counted in int)
    assert spp.plan_bwd(1, 64, 2**28, 16, sms=132)
    assert spp.counts_in_64_bits(2**28, 16)
    # the point kernel's flat grid: B * (ranges + 1) blocks
    with pytest.raises(ValueError, match="grid"):
        spp.plan_bwd(2**30, 32, 1, 1, sms=132)
    spp.plan_bwd(2**30 - 1, 32, 1, 1, sms=132)


# ------------------------------------------------ the kernels, emulated

def _popc(v: int) -> int:
    return bin(v).count("1")


def _emulate_points(flat: np.ndarray, n: int, plan: spp.BwdPlan
                    ) -> list[list[int]]:
    """The entries each point of one cloud adds, in the order the point
    kernel adds them; flat is idx[b] as [M * k]. Follows the kernel's
    rounds, list places, slices, masks, flags and owners' walks, and
    checks that every slice leaves the flags clear."""
    entries, threads, span = flat.size, plan.threads, plan.span
    warps, rnd = threads // 32, _round(plan)
    visits: list[list[int]] = [[] for _ in range(n)]
    for p0 in range(0, n, span):
        np_ = min(span, n - p0)
        hit = np.zeros(span, dtype=np.int64)
        mask = np.full((warps, span), -7, dtype=np.int64)  # never cleared
        for r0 in range(0, entries, rnd):
            lc = np.full(min(rnd, entries), -7)   # the entry, for its slot
            lp = np.full(min(rnd, entries), -7)
            votes, wcnt = [], []
            for wid in range(warps):
                es = [[r0 + 32 * (spp.UNROLL * wid + u) + lane
                       for lane in range(32)] for u in range(spp.UNROLL)]
                ps = [[flat[e] - p0 if e < entries else -1 for e in row]
                      for row in es]
                vote = [sum(1 << lane for lane in range(32)
                            if 0 <= row[lane] < np_) for row in ps]
                votes.append((es, ps, vote))
                wcnt.append(sum(_popc(v) for v in vote))
            total = sum(wcnt)
            for wid, (es, ps, vote) in enumerate(votes):
                at = sum(wcnt[:wid])
                for u in range(spp.UNROLL):
                    for lane in range(32):
                        if vote[u] >> lane & 1:
                            slot = at + _popc(vote[u] & ((1 << lane) - 1))
                            lc[slot], lp[slot] = es[u][lane], ps[u][lane]
                    at += _popc(vote[u])
            for c0 in range(0, total, threads):
                keys = [lp[c0 + t] if c0 + t < total else -1
                        for t in range(threads)]
                for wid in range(warps):
                    ks = keys[wid * 32:wid * 32 + 32]
                    for lane, key in enumerate(ks):
                        peers = sum(1 << o for o in range(32) if ks[o] == key)
                        if key >= 0 and peers & ((1 << lane) - 1) == 0:
                            mask[wid, key] = peers
                            hit[key] |= 1 << wid
                for t in range(threads):
                    for r in range(_per(plan)):
                        p = t + r * threads
                        if p >= np_:
                            continue
                        hw, hit[p] = int(hit[p]), 0
                        for w in range(warps):
                            if hw >> w & 1:
                                mk = int(mask[w, p])
                                visits[p0 + p] += [lc[c0 + 32 * w + lane]
                                                   for lane in range(32)
                                                   if mk >> lane & 1]
                assert not hit.any()
    return visits


def _stable_groups(flat: np.ndarray, n: int) -> list[list[int]]:
    order = np.argsort(flat, kind="stable")
    return [order[flat[order] == p].tolist() for p in range(n)]


def _entries(b, n, m, k, kind, seed):
    """Clouds, queries, sigma^2, a cotangent and idx [B, M, k]: "knn", the
    forward's neighbours; "collision", every entry on point 3; "few", each
    entry on one of four points; "dups", random points with repeats within
    a query."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    qs = rng.standard_normal((b, m, 3)).astype(np.float32)
    cot = rng.standard_normal((b, m, 3)).astype(np.float32)
    sigma = np.float32(0.4)
    if kind == "knn":
        idx = soft_project_fwd_plain(torch.from_numpy(pts),
                                     torch.from_numpy(qs),
                                     torch.tensor([sigma]), k)[1].numpy()
    elif kind == "collision":
        idx = np.full((b, m, k), 3, dtype=np.int32)
    elif kind == "few":
        idx = rng.choice([0, 5, n // 2, n - 1], size=(b, m, k))
    else:
        idx = rng.integers(0, n, size=(b, m, k))
    return pts, qs, sigma, cot, idx.astype(np.int32)


def _contributions(pts, qs, sigma, cot, idx):
    """Each entry's contribution to d points [B, M, k, 3], e_j and
    d_j - d_0 [B, M, k], in f32 as the first kernel forms them."""
    g = np.take_along_axis(pts[:, None], idx[..., None].astype(np.int64),
                           axis=2)
    delta = g - qs[:, :, None]
    d = (delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1]) \
        + delta[..., 2] * delta[..., 2]
    w = np.exp(-(d - d[..., :1]) / sigma)
    w = w / w.sum(-1, keepdims=True)
    out = (w[..., None] * g).sum(2)
    u = (cot[:, :, None] * g).sum(-1)
    e = w * (u - (cot * out).sum(-1, keepdims=True))
    two_dd = -2.0 * e / sigma
    c = w[..., None] * cot[:, :, None] + two_dd[..., None] * delta
    return c.astype(np.float32), e.astype(np.float32), \
        (d - d[..., :1]).astype(np.float32)


def _emulate_dsigma(e, dd, sigma):
    """d sigma^2 of one cloud as its last block sums it: stripe s adds the
    terms of queries s, s + 256, ... in (query, rank) order, then a tree."""
    m = e.shape[0]
    red = np.zeros(spp.STRIPES, dtype=np.float32)
    for s in range(min(m, spp.STRIPES)):
        acc = np.float32(0.0)
        for q in range(s, m, spp.STRIPES):
            for j in range(e.shape[1]):
                acc = np.float32(acc + e[q, j] * dd[q, j])
        red[s] = acc
    half = spp.STRIPES // 2
    while half:
        red[:half] = red[:half] + red[half:2 * half]
        half //= 2
    return red[0] / np.float32(sigma * sigma)


PLANS = [spp.BwdPlan(tile=32, threads=32, span=32),
         spp.BwdPlan(tile=64, threads=32, span=128),
         spp.BwdPlan(tile=128, threads=128, span=256),
         spp.BwdPlan(tile=256, threads=256, span=1024),
         spp.BwdPlan(tile=32, threads=64, span=64)]


@pytest.mark.parametrize("plan", PLANS,
                         ids=lambda p: f"t{p.threads}s{p.span}")
@pytest.mark.parametrize("kind,b,n,m,k", [("knn", 2, 150, 21, 7),
                                          ("collision", 1, 40, 37, 16),
                                          ("few", 1, 300, 40, 5),
                                          ("dups", 2, 70, 290, 1)])
def test_kernel_order_is_the_stable_sort(plan, kind, b, n, m, k):
    pts, qs, sigma, cot, idx = _entries(b, n, m, k, kind, seed=n + m + k)
    c, e, dd = _contributions(pts, qs, sigma, cot, idx)
    want_dp, _, want_ds = soft_project_bwd_plain(
        *(torch.from_numpy(a) for a in (pts, qs, np.array([sigma]), idx,
                                        cot)))
    ds_total = np.float32(0.0)
    for bi in range(b):
        flat = idx[bi].reshape(-1)
        visits = _emulate_points(flat, n, plan)
        assert visits == _stable_groups(flat, n)
        cf = c[bi].reshape(-1, 3)
        dp = np.zeros((n, 3), dtype=np.float32)
        for p in range(n):
            for ent in visits[p]:
                dp[p] = dp[p] + cf[ent]
        np.testing.assert_allclose(dp, want_dp[bi].numpy(), rtol=1e-4,
                                   atol=1e-5)
        ds_total = np.float32(ds_total + _emulate_dsigma(e[bi], dd[bi],
                                                         sigma))
    np.testing.assert_allclose(ds_total, want_ds.numpy()[0], rtol=1e-4,
                               atol=1e-6)


# --------------------------------------- the plain backward against JAX

@pytest.mark.parametrize("kind,b,n,m,k", [
    ("collision", 2, 50, 40, 16),    # one point takes all M*k entries
    ("collision", 1, 9, 300, 1),
    ("knn", 3, 200, 30, 1),          # k = 1
    ("knn", 2, 300, 64, 16),         # k = 16
    ("dups", 2, 64, 33, 7),          # repeats within a query
    ("knn", 1, 16384, 8, 16),        # N above the old shared-memory cap
])
def test_plain_backward_matches_jax_vjp(kind, b, n, m, k):
    pts, qs, sigma, cot, idx = _entries(b, n, m, k, kind, seed=3 * n + k)
    with jax.enable_x64(True):
        _, vjp = jax.vjp(lambda p, q, s: _soft_project_ref(p, q, s, idx),
                         *(jnp.asarray(a, jnp.float64)
                           for a in (pts, qs, sigma)))
        want = [np.asarray(w) for w in vjp(jnp.asarray(cot, jnp.float64))]
    got = soft_project_bwd_plain(
        *(torch.from_numpy(a) for a in (pts, qs, np.array([sigma]), idx,
                                        cot)))
    assert want[0].dtype == np.float64
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.reshape(g.shape), rtol=1e-4,
                                   atol=1e-5)
    if kind == "collision":
        dp = got[0].numpy()
        assert np.abs(dp[:, 3]).sum() > 0
        assert not np.delete(dp, 3, axis=1).any()
        assert float(got[2]) == 0.0     # every d_j - d_0 is 0
