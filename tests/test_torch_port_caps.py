"""Inputs the JAX package takes beyond the first kernels' caps, on the CPU.

The soft projection at group sizes above 16: the JAX package runs its XLA
path there (samplenet_tpu/models/soft_projection.py:108); the port runs
its wide kernels on the card and, here, their plain version.
`SoftProjection.project` is held to the XLA path at k = 17, 32 and N, with
N = 40 and 1024 and M = 32: the output within 1e-5 relative, the
gradients in the points, the queries and the temperature (jax.grad
against torch autograd) within 1e-4 relative, the indices equal. The XLA
path finds its neighbours by |x|^2 + |y|^2 - 2xy, so a query whose k-th
and (k+1)-th distances lie within 1e-6 relative of each other may take
another set there: those queries, and the points they reach, are left
out of the comparison (the share left in is asserted).

The wide forward's selection (csrc/soft_projection.cu) is emulated step
by step in numpy. The pruned kernel: each warp-slice's visits of its
block's points, a lane's 8 group minima (visit v into slot v mod 8), the
slots and lanes merged to G / S a slice, tau the k-th of the query's G
minima (from every block of the cluster), the keys at or below it, and
their sort by (key, index); a list longer than its buffer takes the radix
selection. The radix kernel: a radix select of four 8-bit passes on the
distance bits, the row written in index order by ballots, and the
in-place bitonic sort whose every compare puts the smaller entry at the
lower index. Both are held to the plain version's stable sort bit for bit
on randn clouds, on ties (every point three times, on an integer grid),
NaN and +inf points and k = N, the pruned one under its plan and under
splits over warps and over the blocks of a cluster; the tests also show
that the overflow path is taken where the ties fill the buffer.

FPS on clouds beyond a block: the launch plan sends every shape the block
kernel refuses (N above 16,384, or the cloud and the picks beyond a
block's shared memory) to the cluster variant, whose layout (a cluster
of blocks, R points a thread or streamed) is emulated in numpy and held
to the plain version bit for bit; today's shapes keep today's plans.
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
from samplenet_tpu_torch.models.soft_projection import SoftProjection
from samplenet_tpu_torch.ops.cuda import fps_plan as fp
from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp
from samplenet_tpu_torch.ops.cuda.fps_kernel import fps_plain
from samplenet_tpu_torch.ops.cuda.soft_projection_kernel import (
    soft_project,
    soft_project_fwd_plain,
)

torch.set_num_threads(1)

H100 = dict(sms=132, smem_limit=232448)
TIE = 1e-6          # the k-th and (k+1)-th distances closer than this apart


# ------------------------------------- SoftProjection.project against XLA

def _jax_project(pts, qs, cot, k, temperature):
    """(out, d points, d queries, d temperature) of the XLA path."""
    proj = JaxSoftProjection(group_size=k, initial_temperature=temperature,
                             sigma_mode="torch", use_pallas=False)
    v = proj.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(qs))

    def loss(params, p, q):
        out = proj.apply({"params": params}, p, q,
                         method=JaxSoftProjection.project)[0]
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        v["params"], jnp.asarray(pts), jnp.asarray(qs))
    return (np.asarray(out), np.asarray(grads[1]), np.asarray(grads[2]),
            float(grads[0]["temperature"]))


def _port_project(pts, qs, cot, k, temperature):
    proj = SoftProjection(k, initial_temperature=temperature,
                          sigma_mode="torch")
    p = torch.from_numpy(pts).requires_grad_(True)
    q = torch.from_numpy(qs).requires_grad_(True)
    out = proj.project(p, q)[0]
    (out * torch.from_numpy(cot)).sum().backward()
    return (out.detach().numpy(), p.grad.numpy(), q.grad.numpy(),
            float(proj._temperature.grad))


def _far_from_ties(pts, qs, k):
    """[B, M]: the queries whose k-th and (k+1)-th distances (float64) lie
    more than TIE relative apart (every query where k = N)."""
    d = ((qs[:, :, None, :].astype(np.float64)
          - pts[:, None, :, :].astype(np.float64)) ** 2).sum(-1)
    d = np.sort(d, axis=-1)
    if k == d.shape[-1]:
        return np.ones(d.shape[:2], bool)
    return d[..., k] - d[..., k - 1] > TIE * d[..., k]


@pytest.mark.parametrize("n,k", [(40, 17), (40, 32), (40, 40), (1024, 17),
                                 (1024, 32), (1024, 1024)])
def test_project_at_wide_k_matches_the_xla_path(n, k):
    b, m, temperature = 2, 32, 0.7
    rng = np.random.default_rng(n + k)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    qs = rng.standard_normal((b, m, 3)).astype(np.float32)
    cot = rng.standard_normal((b, m, 3)).astype(np.float32)
    far = _far_from_ties(pts, qs, k)
    assert far.mean() >= 0.9
    got = _port_project(pts, qs, cot, k, temperature)
    want = _jax_project(pts, qs, cot, k, temperature)

    # indices: the port's (the kernels' and the plain version's) against
    # knn_point's, which the XLA path gathers
    _, idx = soft_project(torch.from_numpy(pts), torch.from_numpy(qs),
                          torch.tensor(temperature ** 2), k)
    _, want_idx = knn_point(k, jnp.asarray(pts), jnp.asarray(qs))
    np.testing.assert_array_equal(np.sort(idx.numpy()[far], -1),
                                  np.sort(np.asarray(want_idx)[far], -1))

    np.testing.assert_allclose(got[0][far], want[0][far], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[2][far], want[2][far], rtol=1e-4,
                               atol=1e-4 * np.abs(want[2]).max())
    # the points that a query near a tie reaches take its share of d points
    reach = np.zeros((b, n), bool)
    near_b, near_q = np.nonzero(~far)
    for bi, qi in zip(near_b, near_q):
        reach[bi, idx.numpy()[bi, qi]] = True
        reach[bi, np.asarray(want_idx)[bi, qi]] = True
    np.testing.assert_allclose(got[1][~reach], want[1][~reach], rtol=1e-4,
                               atol=1e-4 * np.abs(want[1]).max())
    if far.all():
        np.testing.assert_allclose(got[3], want[3], rtol=1e-4)


# --------------------------------------- the wide forward's selection

def _dist_keys(pts, q):
    """The kernel's keys of one query: its f32 distances' bits, NaN as
    +inf (fminf(d, inf)), ((dx*dx + dy*dy) + dz*dz) op by op."""
    dx, dy, dz = (q[c] - pts[:, c] for c in range(3))
    d = (dx * dx + dy * dy) + dz * dz
    d = np.where(np.isnan(d), np.float32(np.inf), d).astype(np.float32)
    return d.view(np.uint32).astype(np.uint64)


def _radix_select(keys, k):
    """idx of one query as the radix kernel (soft_project_fwd_wide_kernel)
    computes it, and the pruned kernel past its buffer."""
    n = keys.size
    prefix, mask, rank, lt = 0, 0, k, 0
    for shift in (24, 16, 8, 0):
        on = (keys & mask) == prefix
        hist = np.bincount(((keys[on] >> shift) & 255).astype(np.int64),
                           minlength=256)
        run = np.cumsum(hist) - hist        # keys in the bins below
        digit = int(np.nonzero(run + hist >= rank)[0][0])
        lt += int(run[digit])
        rank -= int(run[digit])
        prefix |= digit << shift
        mask |= 255 << shift
    row = np.full(k, -1, np.int64)
    nlt = neq = 0
    for p0 in range(0, n, 32):              # 32 lanes a round, index order
        for p in range(p0, min(p0 + 32, n)):
            if keys[p] < prefix:
                row[nlt] = p
                nlt += 1
            elif keys[p] == prefix:
                if neq < rank:
                    row[lt + neq] = p
                neq += 1
    assert nlt == lt and (row >= 0).all()
    full = (keys << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    pad = 1
    while pad < k:
        pad *= 2
    size = 2
    while size <= pad:
        stride = size // 2
        while stride > 0:
            for t in range(pad // 2):
                base, off = t // stride * 2 * stride, t % stride
                i = base + off
                j = base + 2 * stride - 1 - off if stride == size // 2 \
                    else i + stride
                if j < k and full[row[i]] > full[row[j]]:
                    row[i], row[j] = row[j], row[i]
            stride //= 2
        size *= 2
    return row


PAD_KEY = 0xFFFFFFFF        # a visit past the block's points
INF_KEY = 0x7F800000        # +inf's bits: a real key is at most this


def _group_minima(keys, plan):
    """The G group minima of one query under a pruned plan: every block r
    of the cluster, warp-slice w and lane, visit v of chunk c taking point
    r span + c chunk + (v ws + w) 32 + lane into slot v mod 8, then the
    slots merged to keep_s (slot s into s mod keep_s) and the lanes to
    keep_l (lane l into l mod keep_l), gs = G / S a slice."""
    n = keys.size
    ws, cs = plan.ws, plan.cs
    gs = plan.groups // plan.split
    keep_s = gs // 32 if gs >= 32 else 1
    keep_l = gs // keep_s
    vpc = plan.chunk // (32 * ws)
    lanes = np.arange(32)
    minima = []
    for r in range(cs):
        base = r * plan.span
        length = max(0, min(plan.span, n - base))
        for w in range(ws):
            g = np.full((32, spp.SLOTS), PAD_KEY, np.uint64)
            for c in range(-(-length // plan.chunk)):
                cn = min(plan.chunk, length - c * plan.chunk)
                for v in range(vpc):
                    off = (v * ws + w) * 32 + lanes
                    at = np.minimum(base + c * plan.chunk + off, n - 1)
                    key = np.where(off < cn, keys[at], PAD_KEY)
                    g[:, v % spp.SLOTS] = np.minimum(g[:, v % spp.SLOTS], key)
            g = g.reshape(32, spp.SLOTS // keep_s, keep_s).min(1)
            g = g.reshape(32 // keep_l, keep_l, keep_s).min(0)
            minima.extend(g.ravel().tolist())
    assert len(minima) == plan.groups
    return np.array(minima, np.uint64)


def _wide_select(keys, k, plan=None):
    """(idx, overflowed) of one query as the wide forward computes it
    under `plan` (a pruned plan; None: the radix kernel)."""
    if plan is None or plan.radix:
        return _radix_select(keys, k), False
    tau = min(int(np.sort(_group_minima(keys, plan))[k - 1]), INF_KEY)
    cand = np.nonzero(keys <= tau)[0]
    assert cand.size >= k               # tau bounds the k-th neighbour
    if cand.size > plan.cap:            # past the buffer: the radix path
        return _radix_select(keys, k), True
    order = np.lexsort((cand, keys[cand]))
    return cand[order[:k]], False


def _splits(n, k):
    """Pruned plans of one cloud of n points, k neighbours, 40 queries:
    the planner's, and every split (ws, cs) of up to 64 slices that the
    kernel takes (G >= S, at most MAX_VISITS keys a lane)."""
    plans = []
    for ws in (1, 2, 4, 8):
        for cs in (1, 2, 4, 8):
            try:
                plans.append(spp.pruned_plan(1, n, 40, k, ws, cs))
            except ValueError:
                pass
    return plans


def _selection_input(kind, n, m, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    qs = rng.standard_normal((m, 3)).astype(np.float32)
    if kind == "triples":                   # every point three times
        grid = rng.integers(-2, 3, size=(-(-n // 3), 3))
        pts = np.repeat(grid, 3, axis=0)[:n].astype(np.float32)
        qs = rng.integers(-2, 3, size=(m, 3)).astype(np.float32)
    elif kind == "nan":
        pts[rng.choice(n, size=max(1, n // 5), replace=False), 1] = np.nan
        qs[0, 2] = np.nan                   # every distance NaN: 0..k-1
    elif kind == "inf":
        pts[: n // 2, 0] = np.inf           # half the cloud at +inf
    return pts, qs


@pytest.mark.parametrize("kind", ["randn", "triples", "nan", "inf"])
@pytest.mark.parametrize("n,k", [(40, 17), (40, 40), (40, 1), (300, 64),
                                 (300, 33), (97, 96)])
def test_wide_selection_is_the_stable_sort(kind, n, k):
    pts, qs = _selection_input(kind, n, 6, n * k + len(kind))
    _, want = soft_project_fwd_plain(torch.from_numpy(pts[None]),
                                     torch.from_numpy(qs[None]),
                                     torch.tensor([0.5]), k)
    plans = [None] + _splits(n, k)
    assert len(plans) > 4 or k > spp.PRUNE_MAX_K
    for qi in range(qs.shape[0]):
        keys = _dist_keys(pts, qs[qi])
        for plan in plans:
            np.testing.assert_array_equal(_wide_select(keys, k, plan)[0],
                                          want[0, qi].numpy(), str(plan))


@pytest.mark.parametrize("kind,overflows", [("randn", False),
                                            ("triples", True),
                                            ("same", True)])
def test_wide_selection_overflows_to_the_radix_path(kind, overflows):
    """On a randn cloud of 1024 points at k = 32 the candidates fit the
    buffer under every split; where ties fill it (every point three times
    on a small integer grid, or one point 1024 times), the radix path takes
    the query, and the answer is the stable sort all the same."""
    n, k = 1024, 32
    pts, qs = _selection_input("triples" if kind == "same" else kind, n, 8,
                               7)
    if kind == "same":
        pts[:] = pts[0]
    _, want = soft_project_fwd_plain(torch.from_numpy(pts[None]),
                                     torch.from_numpy(qs[None]),
                                     torch.tensor([0.5]), k)
    taken = []
    for qi in range(qs.shape[0]):
        keys = _dist_keys(pts, qs[qi])
        for plan in _splits(n, k):
            got, over = _wide_select(keys, k, plan)
            np.testing.assert_array_equal(got, want[0, qi].numpy())
            taken.append(over)
    assert any(taken) == overflows and (all(taken) or not overflows
                                        or kind == "triples")


def test_wide_candidates_stay_few_on_randn():
    """About k + k^2 / 2G candidates a query (40 at k = 32, G = 64) under
    the classification step's plan: the sort that follows is of 64 keys."""
    n, k = 1024, 32
    pts, qs = _selection_input("randn", n, 64, 11)
    plan = spp.plan_fwd_wide(1024, n, 32, k, sms=132)
    counts = []
    for q in qs:
        keys = _dist_keys(pts, q)
        tau = min(int(np.sort(_group_minima(keys, plan))[k - 1]), INF_KEY)
        counts.append(int((keys <= tau).sum()))
    assert min(counts) >= k and np.mean(counts) < 48 and max(counts) <= 128


def test_wide_plan():
    # the classification step at k = 32: one warp a query, no split
    plan = spp.plan_fwd_wide(1024, 1024, 32, 32, sms=132)
    assert (plan.ws, plan.cs, plan.groups, plan.cap) == (1, 1, 64, 128)
    assert (plan.chunk, plan.span, plan.visits) == (1024, 1024, 32)
    assert plan.grid == 1024 * 32 // 8 and plan.queries == 8
    assert plan.smem == 1024 * 16 + 8 * 1024 * 4 == 49152
    # 256 queries over 32768 points: 16 slices, 2 warps of 8-block clusters
    plan = spp.plan_fwd_wide(4, 32768, 64, 32, sms=132)
    assert (plan.ws, plan.cs, plan.split, plan.visits) == (2, 8, 16, 64)
    assert (plan.chunk, plan.span, plan.grid) == (2048, 4096, 4 * 16 * 8)
    assert plan.smem <= 232448
    # one query: the slices in warps, not in blocks the query cannot fill
    plan = spp.plan_fwd_wide(1, 4096, 1, 32, sms=132)
    assert (plan.ws, plan.cs) == (8, 2) and plan.queries == 1
    # a tiny cloud is not split; k = 64 takes G = 128
    assert spp.plan_fwd_wide(3, 200, 40, 17, sms=132).split == 1
    assert spp.plan_fwd_wide(4, 1024, 64, 64, sms=132).groups == 128
    # k a large share of N, k past 64, or a cloud the caches cannot hold:
    # the radix kernel, one warp a query
    for args in ((4, 1024, 64, 256), (3, 40, 5, 40), (4, 5000, 40, 100),
                 (1, 2**18, 2, 32)):
        plan = spp.plan_fwd_wide(*args, sms=132)
        assert plan.radix and plan.grid == -(-args[0] * args[2] // 8)
        assert plan.smem == 8 * 256 * 4
    for args in ((1, 10, 4, 11), (0, 10, 4, 4), (1, 10, 4, 0)):
        with pytest.raises(ValueError, match="positive"):
            spp.plan_fwd_wide(*args, sms=132)
    with pytest.raises(ValueError, match="grid"):
        spp.plan_fwd_wide(2**16, 64, 2**16 * 8, 17, sms=132)
    with pytest.raises(ValueError, match="does not take"):
        spp.pruned_plan(1, 32768, 1, 32, 1, 1)       # 1024 keys a lane


def test_register_forward_routes_the_rest_to_the_wide_one():
    for b, m in ((1024, 32), (50, 2048), (1, 16776960), (2, 2**20)):
        assert spp.takes_register_fwd(b, m, 16, sms=132)
        assert not spp.takes_register_fwd(b, m, 17, sms=132)
    # more query tiles than a grid axis holds: the wide forward at any k
    assert not spp.takes_register_fwd(1, 16776961, 4, sms=132)
    with pytest.raises(ValueError, match="grid"):
        spp.plan_fwd(1, 16, 16776961, sms=132)
    plan = spp.plan_fwd_wide(1, 16, 16776961, 4, sms=132)
    assert not plan.radix and plan.grid == 2097121


@pytest.mark.parametrize("k", [17, 24, 32, 64, 256, 1024])
def test_backward_plan_takes_any_k(k):
    plan = spp.plan_bwd(4, 1024, 64, k, sms=132)
    assert plan == spp.plan_bwd(4, 1024, 64, 16, sms=132)  # k moves nothing
    assert spp.bwd_smem(plan.threads, plan.span, 64 * k) <= 232448


# ------------------------------------------------ FPS beyond one block

# (B, N, k, the cluster variant's C and R; R = 0 streamed)
CLUSTER_SHAPES = [(2, 16385, 64, 2, 16), (4, 16385, 1024, 2, 16),
                  (2, 32768, 64, 2, 16), (2, 32768, 1024, 2, 16),
                  (3, 100003, 64, 8, 16), (2, 100003, 1024, 8, 16),
                  (1, 2**20, 256, 16, 0), (2, 8192, 8192, 1, 8),
                  (1, 17600, 1024, 2, 16), (1, 131072, 8, 8, 16),
                  (1, 131073, 8, 16, 0), (1024, 20000, 32, 2, 16)]


@pytest.mark.parametrize("b,n,k,c,r", CLUSTER_SHAPES)
def test_plan_sends_what_a_block_cannot_hold_to_the_cluster(b, n, k, c, r):
    plan = fp.plan_fps(b, n, k, **H100)
    assert (plan.cluster, plan.points) == (c, r)
    assert plan.stream == (r == 0) and fp.valid(plan, n)
    assert fp.cluster_smem(r) + 4720 <= H100["smem_limit"]


@pytest.mark.parametrize("b,n,k", [(1024, 1024, 32), (50, 2048, 64),
                                   (3, 5000, 64), (32, 1024, 1024),
                                   (1, 16384, 8), (1, 7000, 7000),
                                   (1, 8192, 1024)])
def test_todays_shapes_keep_the_block_kernel(b, n, k):
    plan = fp.plan_fps(b, n, k, **H100)
    assert not plan.cluster and not plan.stream
    assert fp.fps_smem(n, k) <= H100["smem_limit"]
    assert plan in fp.candidates(n)


def test_plan_cluster_rules():
    def plan(b, n, **kw):
        return fp.plan_cluster(b, n, sms=132, smem_limit=232448, **kw)

    # the fewest R that hold the cloud at the chosen C
    assert (plan(2, 8192).cluster, plan(2, 8192).points) == (1, 8)
    assert (plan(2, 8193).cluster, plan(2, 8193).points) == (1, 16)
    assert (plan(2, 16385).cluster, plan(2, 16385).points) == (2, 16)
    # fewer waves first: 132 clouds of 8192 points take C = 1 in one wave
    assert plan(132, 8192).cluster == 1
    # where the card holds fewer clouds of a C at once, another C may
    # take fewer waves: C = 4 holds 16,385 points at R = 8
    assert plan(40, 16385, active=lambda c, r: 16 if c == 2 else 40) \
        .cluster == 4
    # a card with less shared memory streams what its slices cannot hold
    assert fp.plan_cluster(2, 100003, sms=132, smem_limit=100000).stream
    assert fp.valid(fp.FpsPlan(32, 1, False, 8), 8192)
    assert not fp.valid(fp.FpsPlan(32, 1, False, 8), 8193)
    assert not fp.valid(fp.FpsPlan(32, 1, True, 8), 10)
    assert not fp.valid(fp.FpsPlan(16, 1, False, 8), 10)
    assert not fp.valid(fp.FpsPlan(32, 3, False, 8), 10)
    assert not fp.valid(fp.FpsPlan(32, 32, False, 8), 10)
    assert fp.valid(fp.FpsPlan(32, 0, False, 16), 10**9)   # streamed
    assert not fp.valid(fp.FpsPlan(32, 0, False, 8), 10)   # at C = 16 only
    assert not fp.valid(fp.FpsPlan(32, 0, False, 2), 10)
    assert not fp.valid(fp.FpsPlan(32, 16, False, 16), 10)  # 16 streams
    assert not fp.valid(fp.FpsPlan(32, 0, False, 0), 10)
    for c in (3, 5, 16):                                     # no such build
        assert not fp.valid(fp.FpsPlan(32, 16, False, c), 10)


def _cluster_fps(pts, given, count, k, csize, threads, r):
    """csrc/fps.cu's cluster variant for every cloud, in numpy, at `threads`
    a block (the kernel's 1024, or fewer to put a small cloud across many
    blocks): block c of csize holds points c S + t + j threads (S =
    threads r, padding at distance 0), or streamed (r = 0) points
    c threads + t + i threads csize; each thread's first maximum by bits,
    then the (bits, lowest index) maximum over the cluster."""
    b, n, _ = pts.shape
    c = np.arange(csize)[:, None, None]
    t = np.arange(threads)[None, None, :]
    if r:
        p = c * threads * r + t + np.arange(r)[None, :, None] * threads
    else:
        iters = -(-n // (csize * threads))
        p = c * threads + t + np.arange(iters)[None, :, None] * csize * threads
    p = p.transpose(1, 0, 2).reshape(p.shape[1], -1)     # [points, threads]
    real = p < n
    idx = np.zeros((b, k), np.int32)
    for bi in range(b):
        cloud = pts[bi]
        xyz = cloud[np.minimum(p, n - 1)]
        pd = np.where(real, np.float32(np.inf), np.float32(0))
        cnt = min(max(int(count[bi]), 0), k)
        picks = [int(g) for g in given[bi, :cnt]]
        for g in picks:
            s = cloud[g] if 0 <= g < n else np.zeros(3, np.float32)
            pd = np.where(real, np.minimum(pd, _sq(xyz, s)), pd)
        for step in range(cnt, k):
            keys = pd.view(np.uint32).astype(np.int64)
            keys[np.isnan(pd)] = 0x7FFFFFFF
            if not r:
                keys[~real] = -1              # a streamed thread's non-point
            j = np.argmax(keys, axis=0)       # the first maximum
            best = keys[j, np.arange(keys.shape[1])]
            own = np.where(best >= 0, p[j, np.arange(p.shape[1])], 2**32)
            far = int(own[best == best.max()].min())
            assert far < n
            picks.append(far)
            pd = np.where(real, np.minimum(pd, _sq(xyz, cloud[far])), pd)
        idx[bi] = picks
    return idx


def _sq(xyz, s):
    dx, dy, dz = (xyz[..., i] - s[i] for i in range(3))
    return (dx * dx + dy * dy) + dz * dz


@pytest.mark.parametrize("kind", ["randn", "grid", "nan", "all_nan"])
@pytest.mark.parametrize("threads,r,csize", [
    (32, 2, 8), (64, 1, 8), (32, 16, 8), (16, 4, 8), (1024, 1, 8),
    (16, 0, 8), (1024, 0, 8), (32, 16, 1), (64, 8, 1), (16, 16, 2),
    (64, 4, 2), (32, 4, 4), (128, 1, 4), (1024, 1, 1)])
def test_cluster_layout_emulated_matches_plain(kind, threads, r, csize):
    b, n, k = 2, 300, 24
    rng = np.random.default_rng(csize * threads + r)
    if kind == "grid":
        g = np.arange(7, dtype=np.float32)
        pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1)
        pts = np.repeat(pts.reshape(1, -1, 3)[:, :n], b, axis=0).copy()
    else:
        pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    if kind == "nan":
        pts[0, 123, 1] = np.nan
    elif kind == "all_nan":
        pts[1] = np.nan
    assert not r or csize * threads * r >= n
    given = rng.integers(0, n, (b, k)).astype(np.int32)
    count = np.array([1, k // 2], np.int32)
    want, _ = fps_plain(torch.from_numpy(pts), torch.from_numpy(given),
                        torch.from_numpy(count), k)
    np.testing.assert_array_equal(
        _cluster_fps(pts, given, count, k, csize, threads, r), want.numpy())
