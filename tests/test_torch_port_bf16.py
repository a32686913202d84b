"""The bf16 modes of the port's two per-point MLP kernels, their plain
versions against the JAX package's kernel arithmetic on the CPU, and what
the CPU can check of their CUDA side (operand packing, shared-memory
plan, no fallback).

The exact-BN train chain (`point_mlp_exact_train_max(..., bf16=True)`)
against the private `_pme(..., bf16=True, interpret=True)`, which runs
the TPU kernel's bf16 arithmetic off the TPU (the public entry forces
bf16 off there, point_mlp_exact_kernel.py:522-523): pooled, means,
variances, dx, dW, d gamma, d beta; the dense biases' gradients are
exact zeros on both sides. `point_mlp_max(..., bf16=True)` against the
private `_impl(xt, *wbs, block_b, True, True)` (the public entry forces
bf16 off under `interpret`, :148-149).

Tolerance: 1e-3 of each tensor's largest entry. Measured: at most 7e-7
(the chain) and 7e-8 (point_mlp_max). The two packages sum each z in other
orders, so where an f32 sum lands on the other side of a bf16 rounding
midpoint an operand lands one bf16 ulp apart: at B=4, N=256, widths
3-32-32-64-16 one did, and the chain's gradients moved by up to 2.7e-3 of
scale; the shapes here are small enough that none does (pooled features
within 1e-5 of scale, asserted first). Against the same reference the
f32 versions land 4e-3 or more away on some tensor, and each of three
wrong roundings of the chain's backward (the dh spill left unrounded,
the rows taken from the rounded dh, xhat rounded to bf16), made from the
plain version's own source, 2.5e-3 or more: the tests assert that each
fails.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.ops.pallas.point_mlp_exact_kernel import _pme
from samplenet_tpu.ops.pallas.point_mlp_kernel import _impl
from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme
from samplenet_tpu_torch.ops.cuda import point_mlp_kernel as pmk
from samplenet_tpu_torch.ops.cuda import point_mlp_plan as plan
from samplenet_tpu_torch.ops.cuda.point_mlp_exact_kernel import (
    point_mlp_exact_train_max,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_kernel import point_mlp_max

torch.set_num_threads(1)

TOL = 1e-3                       # of each tensor's largest entry
H100_SMEM = 232448
EXACT_SHAPES = [(1, 4, 128, (3, 16, 32, 8), 2), (3, 2, 128, (3, 16, 16), 1)]
MAX_SHAPES = [(0, 4, 128, (3, 16, 32, 8), 2),
              (1, 3, 200, (3, 64, 64, 64, 128, 128), 3),
              (2, 5, 128, (3, 24, 12), 8)]


def _inputs(seed, b, n, widths):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, widths[0]).astype(np.float32)
    pairs = list(zip(widths[:-1], widths[1:]))
    ws = [(rng.randn(a, c) / np.sqrt(a)).astype(np.float32) for a, c in pairs]
    bs = [(0.1 * rng.randn(c)).astype(np.float32) for _, c in pairs]
    gs = [(1 + 0.1 * rng.randn(c)).astype(np.float32) for _, c in pairs]
    bes = [(0.1 * rng.randn(c)).astype(np.float32) for _, c in pairs]
    g = rng.randn(b, widths[-1]).astype(np.float32)
    return x, [ws, bs, gs, bes], g


def _worst(got, want) -> list[float]:
    """Each tensor's largest error over its largest entry."""
    return [float(np.abs(a - c).max() / max(np.abs(c).max(), 1e-30))
            for a, c in zip(got, want)]


# --------------------------------------------------- the exact chain, bf16

def _jax_exact(x, groups, g, bb):
    def f(x, ws, bs, gs, bes):
        pooled, m, v = _pme(x, tuple(ws), tuple(bs), tuple(gs), tuple(bes),
                            1e-5, bb, True, True)
        return jnp.sum(pooled * g), (pooled, m, v)

    (_, (pooled, m, v)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2, 3, 4), has_aux=True)(x, *groups)
    return ([np.asarray(pooled)] + [np.asarray(a) for a in (*m, *v)]
            + [np.asarray(grads[0])]
            + [np.asarray(t) for k in (1, 3, 4) for t in grads[k]],
            [np.asarray(t) for t in grads[2]])


def _port_exact(x, groups, g, bf16):
    tx = torch.from_numpy(x).requires_grad_(True)
    tg = [[torch.from_numpy(a).requires_grad_(True) for a in grp]
          for grp in groups]
    pooled, m, v = point_mlp_exact_train_max(tx, *tg, bf16=bf16)
    (pooled * torch.from_numpy(g)).sum().backward()
    return ([pooled.detach().numpy()] + [a.numpy() for a in (*m, *v)]
            + [tx.grad.numpy()]
            + [t.grad.numpy() for k in (0, 2, 3) for t in tg[k]],
            [t.grad.numpy() for t in tg[1]])


@pytest.fixture(scope="module", params=EXACT_SHAPES,
                ids=[str(s[3]) for s in EXACT_SHAPES])
def exact_ref(request):
    seed, b, n, widths, bb = request.param
    x, groups, g = _inputs(seed, b, n, widths)
    return (x, groups, g), _jax_exact(x, groups, g, bb)


def test_exact_bf16_plain_matches_the_tpu_kernel_arithmetic(exact_ref):
    args, (want, want_db) = exact_ref
    got, got_db = _port_exact(*args, True)
    assert _worst(got[:1], want[:1])[0] <= 1e-5      # no operand apart
    assert max(_worst(got, want)) <= TOL
    for a, c in zip(got_db, want_db):                # dense biases
        assert not a.any() and not c.any()


def test_exact_f32_fails_the_bf16_tolerance(exact_ref):
    args, (want, _) = exact_ref
    got, _ = _port_exact(*args, False)
    assert max(_worst(got, want)) > TOL


MUTANTS = {   # the plain backward's line, and its wrong rounding
    "dh spill unrounded": (
        "                dy = torch.where(on, round_op(dh, True),\n",
        "                dy = torch.where(on, dh,\n"),
    "rows from the rounded dh": (
        "            dy = torch.where(on, dh, torch.zeros_like(dh))\n",
        "            dy = torch.where(on, round_op(dh, bf16 and i < nl - 1),\n"
        "                             torch.zeros_like(dh))\n"),
    "xhat rounded": (
        "            xhat = (zs[i] - mus[i]) * rstds[i]\n",
        "            xhat = round_op((zs[i] - mus[i]) * rstds[i], bf16)\n"),
}


@pytest.mark.parametrize("mutant", MUTANTS)
def test_exact_bf16_rounding_mutants_fail(mutant, exact_ref, monkeypatch):
    """Each wrong rounding, applied to the plain version's own source,
    fails the comparison that the plain version passes."""
    text, wrong = MUTANTS[mutant]
    src = inspect.getsource(pme.point_mlp_exact_bwd_plain)
    assert src.count(text) == 1
    namespace = dict(vars(pme))
    exec(src.replace(text, wrong), namespace)
    monkeypatch.setattr(pme, "point_mlp_exact_bwd_plain",
                        namespace["point_mlp_exact_bwd_plain"])
    args, (want, _) = exact_ref
    got, _ = _port_exact(*args, True)
    assert max(_worst(got, want)) > TOL


def test_exact_bf16_auto_block_matches_jax():
    from samplenet_tpu.ops.pallas.point_mlp_exact_kernel import (
        auto_block_b_exact as jax_auto_block_b_exact,
    )
    for b in (1, 3, 32, 50, 1024):
        for n, widths in ((1024, (64, 64, 64, 128, 128)),
                          (2048, (64, 128, 128, 256, 128)),
                          (4096, (64, 1024)), (128, (8, 16))):
            assert pme.auto_block_b_exact(b, n, widths) \
                == jax_auto_block_b_exact(b, n, widths)


# --------------------------------------------------- point_mlp_max, bf16

def _max_case(seed, b, n, widths):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, widths[0]).astype(np.float32)
    wbs = []
    for a, c in zip(widths[:-1], widths[1:]):
        wbs += [(rng.randn(a, c) / np.sqrt(a)).astype(np.float32),
                (0.1 * rng.randn(c)).astype(np.float32)]
    return x, wbs


@pytest.mark.parametrize("seed,b,n,widths,bb", MAX_SHAPES,
                         ids=[str(s[3]) for s in MAX_SHAPES])
def test_max_bf16_plain_matches_the_tpu_kernel_arithmetic(seed, b, n,
                                                          widths, bb):
    x, wbs = _max_case(seed, b, n, widths)
    jw = []
    for i in range(0, len(wbs), 2):
        jw += [jnp.asarray(wbs[i].T), jnp.asarray(wbs[i + 1]).reshape(-1, 1)]
    want = np.asarray(_impl(jnp.swapaxes(jnp.asarray(x), 1, 2), *jw, bb,
                            True, True))
    tw = [torch.from_numpy(a) for a in wbs]
    got = point_mlp_max(torch.from_numpy(x), tw, bf16=True).numpy()
    assert _worst([got], [want])[0] <= TOL
    f32 = point_mlp_max(torch.from_numpy(x), tw).numpy()
    assert _worst([f32], [want])[0] > TOL              # the control


# --------------------------------------------------- the CUDA side, on CPU

def test_bf16_pairs_pack_two_rows_a_word():
    """W [cin, cout] packs rows 2k (low half) and 2k + 1 (high half) of
    bf16(W) into word [k, c], an odd cin padded with a zero row."""
    w = torch.randn(5, 8, generator=torch.Generator().manual_seed(0))
    words = pmk._bf16_pairs(w).view(torch.int32).reshape(3, 8)
    bits = w.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    bits = torch.cat([bits, torch.zeros(1, 8, dtype=torch.int32)])
    want = bits[0::2] | (bits[1::2] << 16)
    assert torch.equal(words, want)


def test_params_buffer_layout():
    """f32: W_l then b_l. bf16: a first layer of fewer than 16 channels as
    rounded f32 values, the others as packed pairs, each then b_l."""
    gen = torch.Generator().manual_seed(1)
    pairs = [(torch.randn(3, 8, generator=gen), torch.randn(8, generator=gen)),
             (torch.randn(8, 12, generator=gen),
              torch.randn(12, generator=gen))]
    f32 = pmk._params(pairs, False)
    assert torch.equal(f32, torch.cat([t.reshape(-1) for p in pairs
                                       for t in p]))
    bf = pmk._params(pairs, True)
    assert bf.numel() == 3 * 8 + 8 + 4 * 12 + 12
    assert torch.equal(bf[:24], pairs[0][0].to(torch.bfloat16).float()
                       .reshape(-1))
    assert torch.equal(bf[24:32], pairs[0][1])
    assert torch.equal(bf[32:80], pmk._bf16_pairs(pairs[1][0]))
    assert torch.equal(bf[80:], pairs[1][1])


@pytest.mark.parametrize("widths", [(3, 64, 64, 64, 128, 128),
                                    (3, 64, 128, 128, 256, 128),
                                    (3, 8, 12), (16, 24, 8), (20, 64)])
def test_max_plan_bf16_halves_the_channel_rows(widths):
    """In bf16 a tile row holds two channels, to the K step of 16; x stays
    in f32 rows where the first layer runs on the FP32 pipes."""
    r32, rbf = plan.max_rows(widths), plan.max_rows(widths, True)
    x_rows = plan.tile_rows(widths[0], False) if widths[0] < 16 \
        else plan.pair_rows(widths[0])
    inner = [plan.pair_rows(c) for c in widths[1:-1]]
    assert rbf[0] == max([x_rows] + inner[1::2])
    assert rbf[1] == max([0] + inner[0::2])
    assert sum(rbf) <= sum(r32)
    p = plan.plan_max(widths, H100_SMEM, True)
    assert p is not None and p.smem == plan.max_smem(widths, True)
    if widths == (3, 64, 64, 64, 128, 128):
        assert plan.max_smem(widths, True) == 4 * (96 * 64 + 128)  # 24.5 KB
        assert plan.max_smem(widths) == 4 * (192 * 64 + 128)


def test_bf16_wrappers_do_not_fall_back(monkeypatch):
    """A CUDA-bound call (use_kernel True) of either bf16 mode on a CPU
    tensor raises, as the f32 modes do: no plain version on the card."""
    monkeypatch.setattr(pmk, "use_kernel", lambda t: True)
    monkeypatch.setattr(pme, "use_kernel", lambda t: True)
    x, wbs = _max_case(0, 2, 128, (3, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        point_mlp_max(torch.from_numpy(x), [torch.from_numpy(a)
                                            for a in wbs], bf16=True)
    x, groups, _ = _inputs(0, 2, 64, (3, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        point_mlp_exact_train_max(torch.from_numpy(x),
                                  *[[torch.from_numpy(a) for a in grp]
                                    for grp in groups], bf16=True)


def test_point_mlp_routes_the_modes(monkeypatch):
    """The exact chain takes bf16 where the fused-mode rule says
    exact_bf16, and the eval kernel takes `eval_bf16`."""
    from samplenet_tpu_torch.nn import layers
    seen = []
    real_exact, real_max = layers.point_mlp_exact_train_max, \
        layers.point_mlp_max

    def exact(*args, **kwargs):
        seen.append(("exact", kwargs["bf16"]))
        return real_exact(*args, **kwargs)

    def eval_max(*args, **kwargs):
        seen.append(("max", kwargs["bf16"]))
        return real_max(*args, **kwargs)

    monkeypatch.setattr(layers, "point_mlp_exact_train_max", exact)
    monkeypatch.setattr(layers, "point_mlp_max", eval_max)
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 128, 3)
                         .astype(np.float32))
    for fused_train, fused_bf16 in ((True, True), (None, True), (None, None)):
        mlp = layers.PointMLP(3, (8, 16), fused_train=fused_train,
                              fused_mode="exact", fused_bf16=fused_bf16)
        mlp(x, training=True, pool_max=True)
    for eval_bf16 in (True, False):
        mlp = layers.PointMLP(3, (8, 16), eval_bf16=eval_bf16)
        with torch.no_grad():
            mlp(x, pool_max=True)
    assert seen == [("exact", True), ("exact", True), ("exact", False),
                    ("max", True), ("max", False)]
