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

The wide forward's selection (csrc/soft_projection.cu,
soft_project_fwd_wide_kernel) is emulated step by step in numpy: a radix
select of four 8-bit passes on the distance bits, the row written in
index order by ballots, and the in-place bitonic sort whose every compare
puts the smaller entry at the lower index; it is held to the plain
version's stable sort bit for bit on ties, NaN and k = N.

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


def _wide_select(keys, k):
    """idx of one query as soft_project_fwd_wide_kernel computes it."""
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
    for qi in range(qs.shape[0]):
        np.testing.assert_array_equal(
            _wide_select(_dist_keys(pts, qs[qi]), k), want[0, qi].numpy())


def test_wide_plan():
    plan = spp.plan_fwd_wide(1024, 1024, 32, 32)
    assert (plan.warps, plan.grid) == (spp.WIDE_WARPS, 1024 * 32 // 8)
    assert plan.smem == 8 * 256 * 4
    assert spp.plan_fwd_wide(3, 40, 5, 40).grid == 2      # 15 queries
    for args in ((1, 10, 4, 11), (0, 10, 4, 4), (1, 10, 4, 0)):
        with pytest.raises(ValueError, match="positive"):
            spp.plan_fwd_wide(*args)
    with pytest.raises(ValueError, match="grid"):
        spp.plan_fwd_wide(2**16, 64, 2**16 * 8, 17)


def test_register_forward_routes_the_rest_to_the_wide_one():
    for b, m in ((1024, 32), (50, 2048), (1, 16776960), (2, 2**20)):
        assert spp.takes_register_fwd(b, m, 16, sms=132)
        assert not spp.takes_register_fwd(b, m, 17, sms=132)
    # more query tiles than a grid axis holds: the wide forward at any k
    assert not spp.takes_register_fwd(1, 16776961, 4, sms=132)
    with pytest.raises(ValueError, match="grid"):
        spp.plan_fwd(1, 16, 16776961, sms=132)
    assert spp.plan_fwd_wide(1, 16, 16776961, 4).grid == 2097121


@pytest.mark.parametrize("k", [17, 24, 32, 64, 256, 1024])
def test_backward_plan_takes_any_k(k):
    plan = spp.plan_bwd(4, 1024, 64, k, sms=132)
    assert plan == spp.plan_bwd(4, 1024, 64, 16, sms=132)  # k moves nothing
    assert spp.bwd_smem(plan.threads, plan.span, 64 * k) <= 232448


# ------------------------------------------------ FPS beyond one block

# (B, N, k, the cluster variant's R; 0 streamed)
CLUSTER_SHAPES = [(2, 16385, 64, 4), (4, 16385, 1024, 4), (2, 32768, 64, 4),
                  (2, 32768, 1024, 4), (3, 100003, 64, 16),
                  (2, 100003, 1024, 16), (1, 2**20, 256, 0),
                  (2, 8192, 8192, 1), (1, 17600, 1024, 4),
                  (1, 131072, 8, 16), (1, 131073, 8, 0), (1024, 20000, 32, 4)]


@pytest.mark.parametrize("b,n,k,r", CLUSTER_SHAPES)
def test_plan_sends_what_a_block_cannot_hold_to_the_cluster(b, n, k, r):
    plan = fp.plan_fps(b, n, k, **H100)
    assert plan.cluster and plan.points == r
    assert plan.stream == (r == 0) and fp.valid(plan, n)
    assert fp.cluster_smem(r) + 4656 <= H100["smem_limit"]


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
    assert fp.plan_cluster(8192, smem_limit=232448).points == 1
    assert fp.plan_cluster(8193, smem_limit=232448).points == 2
    # a card with less shared memory streams what its slice cannot hold
    assert fp.plan_cluster(100003, smem_limit=100000).stream
    assert fp.valid(fp.FpsPlan(32, 1, False, True), 8192)
    assert not fp.valid(fp.FpsPlan(32, 1, False, True), 8193)
    assert not fp.valid(fp.FpsPlan(32, 1, True, True), 10)
    assert not fp.valid(fp.FpsPlan(16, 1, False, True), 10)
    assert not fp.valid(fp.FpsPlan(32, 3, False, True), 10)
    assert not fp.valid(fp.FpsPlan(32, 32, False, True), 10)
    assert fp.valid(fp.FpsPlan(32, 0, False, True), 10**9)    # streamed
    assert not fp.valid(fp.FpsPlan(32, 0, False, False), 10)


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
@pytest.mark.parametrize("threads,r", [(32, 2), (64, 1), (32, 16), (16, 4),
                                       (1024, 1), (16, 0), (1024, 0)])
def test_cluster_layout_emulated_matches_plain(kind, threads, r):
    csize = fp.CLUSTER_BLOCKS
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
