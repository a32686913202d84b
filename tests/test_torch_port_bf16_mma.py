"""The train chains' bf16 modes on the tensor cores, as far as the CPU can
check them: the operand packing of pmt_dense and pmt_bwd_dz, the bf16
launch plans (csrc/point_mlp_train.cu and ops/cuda/point_mlp_plan.py),
and the tensor cores' summation order emulated in torch.

The kernels (pmt_dense_kernel<true>, pmt_bwd_dw_mma_kernel in backward
modes 1 and 2, pmt_bwd_dz_mma_kernel in mode 2) take bf16 operands in
pairs: op(W) as [ceil(cin/2), cout] words for the forward (its rounded
f32 values where a layer of fewer than 16 input channels stays on the FP32
pipes) and op(W)^T as [pair_rows(cout), cin_pad] words for dh_prev. Each
packing unpacks to `round_op(W, True)` bit for bit.

The emulation sums each product as mma.sync m16n8k16 does in the kernels:
each K step of 16 from zero (here in float64, then rounded to f32), the
steps added in f32 in increasing order; dW's K runs over a tile's 64
points in 4 steps, and the tiles' f32 sums are added in float64. Run
through the exact chain in bf16 (forward, and backward mode 2 on the
forward's own state) at B=4, N=256, widths 3-64-64-64-128-128, it lands
within BF16_TOL (1e-3 norm-wise) of the plain bf16 version, as the card
check holds the kernels; the same emulation with bf16 off lands further
than BF16_TOL, as the card check's control must.
"""

import numpy as np
import pytest
import torch

from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme
from samplenet_tpu_torch.ops.cuda import point_mlp_plan as plan
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import round_op
from samplenet_tpu_torch.ops.cuda.point_mlp_train_kernel import (
    dense_weights,
    dz_weights,
)

torch.set_num_threads(1)

H100_SMEM, H100_SMS = 232448, 132
BF16_TOL = 1e-3
SAMPLENET = (3, 64, 64, 64, 128)
K_STEP = 16                 # mma.sync m16n8k16's K, in channels or points
TILE = 64


def _unpack(words: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[rows, cols] f32 from [rows / 2, cols] words of bf16 pairs (row 2k
    in the low half)."""
    w = words.reshape(rows // 2, cols).view(torch.int32)
    lo = (w << 16).view(torch.float32)
    hi = (w & -65536).view(torch.float32)
    return torch.stack([lo, hi], 1).reshape(rows, cols)


@pytest.mark.parametrize("cin", [3, 12, 20, 130])
@pytest.mark.parametrize("cout", [3, 12, 20, 130])
def test_pairs_unpack_to_the_rounded_weights(cin, cout):
    """dense_weights and dz_weights in bf16 hold round_op(W, True) bit for
    bit: op(W) in pairs of input rows from 16 input channels on (rounded
    f32 below), op(W)^T in pairs of output channels, zero-padded to the
    K step and to cin_pad."""
    w = torch.from_numpy(np.random.default_rng(cin * 1000 + cout)
                         .standard_normal((cin, cout)).astype(np.float32))
    ref = round_op(w, True)
    dense = dense_weights(w, True)
    if cin < plan.BF16_MMA_MIN_CIN:
        assert torch.equal(dense, ref)
    else:
        rows = cin + cin % 2
        got = _unpack(dense, rows, cout)
        assert torch.equal(got[:cin], ref) and not got[cin:].any()
    cin_pad = plan.pad4(cin)
    wt = dz_weights(ref, cin_pad, True)
    rows = 2 * plan.pair_rows(cout)
    assert wt.numel() == rows // 2 * cin_pad
    got = _unpack(wt, rows, cin_pad)
    assert torch.equal(got[:cout, :cin], ref.t())
    assert not got[cout:].any() and not got[:, cin:].any()
    assert torch.equal(dz_weights(ref, cin_pad, False)[:, :cin], ref.t())
    assert torch.equal(dense_weights(w, False), w)


@pytest.mark.parametrize("b,m", [(1, 1024 * 1024), (256, 4 * 1024),
                                 (1, 50 * 2048)])
def test_every_f32_plan_plans_in_bf16(b, m):
    """Every bottleneck 4..4096 of SampleNet's chain that plan_bwd plans in
    f32 it plans in bf16, within the card's shared memory, with K chunks
    of op(W)^T pairs a multiple of the K step where they are chunked; the
    same for each layer of cin 4..1024, and pmt_dense's plan."""
    for c in range(4, 4097, 4):
        widths = SAMPLENET + (c,)
        f32 = plan.plan_bwd(widths, b, m, H100_SMS, H100_SMEM)
        bf = plan.plan_bwd(widths, b, m, H100_SMS, H100_SMEM, bf16=True)
        assert (f32 is None) == (bf is None) and bf is not None, c
        for p, q in zip(f32, bf):
            assert q.bf16 and not p.bf16
            assert q.dz_smem <= H100_SMEM and q.dw_smem <= H100_SMEM
            assert (q.dw_ri, q.dw_out_tiles, q.dw_splits) == \
                (p.dw_ri, p.dw_out_tiles, p.dw_splits)
            if q.dz_oc == q.cout and q.dz_kc < q.cout:
                assert q.dz_kc % K_STEP == 0
            assert q.dz_smem == plan.dz_smem(q.cin_pad, q.cout, q.dz_kc,
                                             q.dz_stage, q.dz_oc, True, q.top)
            assert q.top == (q is bf[-1]) and q.dz_blocks in (2, 3)
            assert q.dz_mma == (q.dz_oc == q.cout)
        # the ghost chain's mode 1: pmt_bwd_dz in the f32 layout, dW in bf16
        ghost = plan.plan_bwd(widths, b, m, H100_SMS, H100_SMEM, bf16=True,
                              dz_bf16=False)
        for p, q in zip(f32, ghost):
            assert (q.dz_kc, q.dz_stage, q.dz_oc, q.dz_smem, q.dz_rp) == \
                (p.dz_kc, p.dz_stage, p.dz_oc, p.dz_smem, p.dz_rp)
            assert not q.dz_mma and q.bf16 and q.dw_smem == \
                plan.dw_smem(q.dw_ri, True)
    for cin in range(4, 1025, 4):
        for cout in (4, 20, 64, 132, 1024, 4096):
            if plan.plan_layer(cin, cout, b, m, H100_SMS, H100_SMEM):
                assert plan.plan_layer(cin, cout, b, m, H100_SMS, H100_SMEM,
                                       bf16=True), (cin, cout)
            if plan.plan_dense(cin, cout, H100_SMEM):
                d = plan.plan_dense(cin, cout, H100_SMEM, True)
                assert d and d.bf16 and d.smem <= H100_SMEM, (cin, cout)


def test_bf16_shared_memory_by_hand():
    """The bf16 layouts' bytes at two shapes, counted by hand."""
    # pmt_bwd_dz at 64 -> 64, staged: op(W)^T 32 pair rows of 72 words,
    # 7 x 64 constants, dz 64 x 68, clouds 2 x 64, z and dh 2 x 64 x 64
    assert plan.wt_stride(64) == 72
    assert plan.dz_smem(64, 64, 64, True, bf16=True) == \
        4 * (32 * 72 + 7 * 64 + 64 * 68 + 128 + 2 * 64 * 64) == 61696
    # 128 -> 132, unstaged: 72 pair rows (132 to the K step) of 136 words
    assert plan.wt_stride(128) == 136 and plan.wt_stride(36) == 40
    assert plan.dz_smem(128, 132, 132, False, bf16=True) == \
        4 * (72 * 136 + 7 * 132 + 132 * 68 + 128) == 79280
    # a top layer stages z alone: [64, 128] floats, not [2, 64, 128]
    assert plan.dz_smem(128, 128, 128, True, bf16=True, top=True) == \
        4 * (64 * 136 + 7 * 128 + 128 * 68 + 128 + 64 * 128) == 106496
    # the chunked layout keeps the f32 count in bf16
    assert plan.dz_smem(128, 1024, 128, False, 128, True) == \
        plan.dz_smem(128, 1024, 128, False, 128)
    # pmt_bwd_dw: raw rows [64, 68] and [64, 68 or 132], act(in)'s pairs
    # [64, 36] words, BN constants [4, 64]
    assert plan.dw_smem(4, True) == 4 * (64 * 136 + 64 * 36 + 256) == 45056
    assert plan.dw_smem(8, True) == 4 * (64 * 200 + 64 * 36 + 256) == 61440
    # pmt_dense at 64 -> 64, staged: 32 pair rows of 64 words, not 64, and
    # op(W)'s 32 pair rows of 72 words
    assert plan.dense_smem(64, 64, True, True, True) == \
        8 * 128 + 4 * (64 * 68 + 4 * 64 + 32 * 64 + 64 * 68 + 32 * 72) \
        == 54272
    assert plan.plan_dense(64, 64, H100_SMEM, True).w_smem
    assert not plan.plan_dense(128, 1024, H100_SMEM, True).w_smem
    assert plan.dense_smem(3, 64, False, True) == \
        plan.dense_smem(3, 64, False)            # x stays in f32 rows


# ------------------------------------------------------------ the emulation

def _mm_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] in f32 as the tensor cores sum it: each K step
    of 16 from zero (float64, rounded to f32), added in increasing order."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], K_STEP):
        acc = acc + (a[:, k0:k0 + K_STEP].double()
                     @ b[k0:k0 + K_STEP].double()).float()
    return acc


def _dw_steps(h: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """h^T dz [cin, cout] as pmt_bwd_dw_mma sums it over points: each
    64-point tile's 4 K steps from zero, added in f32, the tiles in
    float64."""
    t = h.shape[0] // TILE
    hs = h.reshape(t, TILE // K_STEP, K_STEP, -1).double()
    ds = dz.reshape(t, TILE // K_STEP, K_STEP, -1).double()
    steps = torch.einsum("tjpc,tjpo->tjco", hs, ds).float()
    tile = steps[:, 0]
    for j in range(1, TILE // K_STEP):
        tile = tile + steps[:, j]
    return tile.double().sum(0).float()


def _fwd_emulated(x, weights, gammas, betas, eps, bf16):
    """The exact chain's forward as the kernels run it: layers of 16 or
    more input channels on the tensor cores' order (f32 FMAs in channel
    order below, the plain matmul's), statistics from float64 sums."""
    b, n, c0 = x.shape
    h = x.reshape(b * n, c0)
    zs, mus, rstds, vars_ = [], [], [], []
    for w, gamma, beta in zip(weights, gammas, betas):
        a, wr = round_op(h, bf16), round_op(w, bf16)
        z = _mm_steps(a, wr) if w.shape[0] >= K_STEP else a @ wr
        zd = z.double()
        mu, var, rstd = pme._stats(zd.sum(0), (zd * zd).sum(0), b * n, eps,
                                   torch.float32)
        h = pme._act(z, mu, rstd, gamma, beta)
        zs.append(z)
        mus.append(mu)
        rstds.append(rstd)
        vars_.append(var)
    hb = h.reshape(b, n, -1)
    argmax = torch.argmax(hb, dim=1)
    pooled = torch.gather(hb, 1, argmax[:, None, :])[:, 0]
    return pooled, mus, vars_, (zs, mus, rstds, argmax)


def _bwd_emulated(x, weights, gammas, betas, saved, g, bf16):
    """Backward mode 2 as the kernels run it, on a forward's state: the
    rows from float64 sums, dz as the plain version forms it, dh_prev and
    dW in the tensor cores' order."""
    zs, mus, rstds, argmax = saved
    b, n, c0 = x.shape
    count = b * n
    dh = torch.zeros((b, n, g.shape[1]))
    dh.scatter_(1, argmax[:, None, :], g[:, None, :])
    dh = dh.reshape(count, -1)
    nl = len(weights)
    dws, dgammas, dbetas = [None] * nl, [None] * nl, [None] * nl
    for i in range(nl - 1, -1, -1):
        xhat = (zs[i] - mus[i]) * rstds[i]
        on = torch.relu(gammas[i] * xhat + betas[i]) > 0
        dy = torch.where(on, dh, torch.zeros_like(dh))
        s1, s2 = dy.double().sum(0), (dy * xhat).double().sum(0)
        dbetas[i], dgammas[i] = s1.float(), s2.float()
        r1 = (gammas[i].double() * s1 / count).float()
        r2 = (gammas[i].double() * s2 / count).float()
        if bf16 and i < nl - 1:
            dy = torch.where(on, round_op(dh, True), torch.zeros_like(dh))
        dz = round_op(rstds[i] * (gammas[i] * dy - r1 - xhat * r2), bf16)
        h_prev = x.reshape(count, c0) if i == 0 else pme._act(
            zs[i - 1], mus[i - 1], rstds[i - 1], gammas[i - 1],
            betas[i - 1])
        dws[i] = _dw_steps(round_op(h_prev, bf16), dz)
        dh = _mm_steps(dz, round_op(weights[i], bf16).t())
    return dh.reshape(b, n, c0), dws, dgammas, dbetas


def _norm_err(t, ref) -> float:
    return float((t - ref).norm() / ref.norm().clamp_min(1e-30))


def _gaps(inputs, bf16):
    """(outputs gap, backward gap) of the emulation against the plain bf16
    version, the backward on the emulated forward's own state."""
    x, weights, gammas, betas, g = inputs
    fe = _fwd_emulated(x, weights, gammas, betas, 1e-5, bf16)
    fp = pme.point_mlp_exact_fwd_plain(x, weights, gammas, betas, 1e-5, True)
    be = _bwd_emulated(x, weights, gammas, betas, fe[3], g, bf16)
    bp = pme.point_mlp_exact_bwd_plain(x, weights, gammas, betas, fe[3], g,
                                       True)
    flat = lambda gr: [gr[0], *gr[1], *gr[2], *gr[3]]  # noqa: E731
    outs = zip([fe[0], *fe[1], *fe[2]], [fp[0], *fp[1], *fp[2]])
    return (max(_norm_err(a, r) for a, r in outs),
            max(_norm_err(a, r) for a, r in zip(flat(be), flat(bp))))


@pytest.fixture(scope="module")
def chain_inputs():
    rng = np.random.default_rng(24)
    widths = (3, 64, 64, 64, 128, 128)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x = randn(4, 256, 3)
    pairs = list(zip(widths[:-1], widths[1:]))
    weights = [randn(ci, co) / ci ** 0.5 for ci, co in pairs]
    gammas = [1 + 0.1 * randn(co) for _, co in pairs]
    betas = [0.1 * randn(co) for _, co in pairs]
    return x, weights, gammas, betas, randn(4, widths[-1])


def test_tensor_core_order_within_bf16_tol(chain_inputs):
    """The exact chain in bf16 summed as the tensor cores sum it lands
    within BF16_TOL of the plain bf16 version: forward, and backward on
    its own forward state."""
    out, bwd = _gaps(chain_inputs, True)
    assert out <= BF16_TOL and bwd <= BF16_TOL, (out, bwd)


def test_tensor_core_order_with_bf16_off_exceeds_bf16_tol(chain_inputs):
    """The control: the same emulation with f32 operands exceeds BF16_TOL
    against the plain bf16 version, on the outputs and on the backward."""
    out, bwd = _gaps(chain_inputs, False)
    assert out > BF16_TOL and bwd > BF16_TOL, (out, bwd)


def test_step_sums_differ_from_one_sum_but_not_by_much():
    """The emulated order is not the plain matmul's (each K step rounded
    to f32 first), and lands within a few f32 ulps of it."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    a, w = round_op(a, True), round_op(w, True)
    steps, exact = _mm_steps(a, w), (a.double() @ w.double())
    assert not torch.equal(steps, exact.float())
    assert float((steps.double() - exact).abs().max()) \
        <= 1e-5 * float(exact.abs().max())
