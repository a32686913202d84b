"""The port's ghost-BN train chain (`point_mlp_train_max`, the chain behind
`--fused-train`) and its selection rule, against the JAX package on the
CPU.

The plain version against JAX's `point_mlp_train_max(..., interpret=True)`
(the Pallas kernel run off-TPU, which forces bf16 off, :422-423), on the
same seeded inputs: pooled features, the EMA's global means and variances,
and dx, dW, d gamma, d beta, with the JAX kernel test's tolerances
(tests/test_pallas_kernels.py:390-399,424-426): pooled rtol 1e-4 / atol
1e-5, means rtol 1e-4, variances rtol 1e-3 / atol 1e-5, gradients rtol
1e-3 / atol 1e-4. Dense-bias gradients are exactly 0 on both sides.

With bf16 on, the plain version against the private `_pmt(..., bf16=True,
interpret=True)`, which runs the kernel's bf16 arithmetic on the CPU:
the two sum each z in other orders, so a bf16 rounding of an operand, a
stored xhat or dz can land one bf16 ulp (2^-8 relative) apart; outputs
and gradients are held to 5e-3 of each tensor's largest entry (measured:
under 3e-4).

`auto_block_b` and the fused-mode rule against JAX's `auto_block_b` and
`PointMLP._resolve_fused_mode`, exactly: JAX's "ghost" is the port's
"ghost", and JAX's XLA chain (None) and exact kernel ("exact") are both
the port's exact chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.nn.layers import PointMLP as JaxPointMLP
from samplenet_tpu.ops.pallas.point_mlp_train_kernel import _pmt
from samplenet_tpu.ops.pallas.point_mlp_train_kernel import (
    auto_block_b as jax_auto_block_b,
)
from samplenet_tpu.ops.pallas.point_mlp_train_kernel import (
    point_mlp_train_max as jax_point_mlp_train_max,
)
from samplenet_tpu_torch.nn import layers
from samplenet_tpu_torch.ops.cuda import point_mlp_train_kernel as pmt
from samplenet_tpu_torch.ops.cuda.point_mlp_exact_kernel import (
    point_mlp_exact_train_max,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_train_kernel import (
    auto_block_b,
    point_mlp_train_max,
)

torch.set_num_threads(1)


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


def _jax_run(x, groups, g, bb, bf16):
    def f(x, ws, bs, gs, bes):
        if bf16:
            pooled, m, v = _pmt(x, tuple(ws), tuple(bs), tuple(gs),
                                tuple(bes), 1e-5, bb, True, True)
        else:
            pooled, m, v = jax_point_mlp_train_max(
                x, tuple(ws), tuple(bs), tuple(gs), tuple(bes), block_b=bb,
                interpret=True)
        return jnp.sum(pooled * g), (pooled, m, v)

    (_, (pooled, m, v)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2, 3, 4), has_aux=True)(x, *groups)
    return (np.asarray(pooled), [np.asarray(a) for a in m],
            [np.asarray(a) for a in v], [np.asarray(grads[0])]
            + [np.asarray(t) for grp in grads[1:] for t in grp])


def _port_run(x, groups, g, bb, bf16):
    tx = torch.from_numpy(x).requires_grad_(True)
    tg = [[torch.from_numpy(a).requires_grad_(True) for a in grp]
          for grp in groups]
    pooled, m, v = point_mlp_train_max(tx, *tg, block_b=bb, bf16=bf16)
    (pooled * torch.from_numpy(g)).sum().backward()
    return (pooled.detach().numpy(), [a.numpy() for a in m],
            [a.numpy() for a in v],
            [tx.grad.numpy()] + [t.grad.numpy() for grp in tg for t in grp])


@pytest.mark.parametrize("b,n,widths,bb", [
    (4, 128, (3, 16, 32, 8), 2),
    (4, 128, (3, 16, 32, 8), 1),
    (2, 96, (3, 8, 12), 2),       # N not a multiple of 64
])
def test_f32_matches_interpreted_kernel(b, n, widths, bb):
    x, groups, g = _inputs(b + n, b, n, widths)
    jp, jm, jv, jg = _jax_run(x, groups, g, bb, False)
    pp, pm, pv, pg = _port_run(x, groups, g, bb, False)
    nl = len(widths) - 1
    np.testing.assert_allclose(pp, jp, rtol=1e-4, atol=1e-5)
    for a, c in zip(pm, jm):
        np.testing.assert_allclose(a, c, rtol=1e-4)
    for a, c in zip(pv, jv):
        np.testing.assert_allclose(a, c, rtol=1e-3, atol=1e-5)
    for i, (a, c) in enumerate(zip(pg, jg)):
        if 1 + nl <= i < 1 + 2 * nl:                # dense biases
            assert not a.any() and not c.any(), i
            continue
        np.testing.assert_allclose(a, c, rtol=1e-3, atol=1e-4, err_msg=str(i))


def test_bf16_matches_interpreted_kernel_arithmetic():
    x, groups, g = _inputs(7, 4, 128, (3, 16, 32, 8))
    jp, jm, jv, jg = _jax_run(x, groups, g, 2, True)
    pp, pm, pv, pg = _port_run(x, groups, g, 2, True)
    for a, c in zip([pp, *pm, *pv, *pg], [jp, *jm, *jv, *jg]):
        scale = max(float(np.abs(c).max()), 1e-30)
        assert float(np.abs(a - c).max()) <= 5e-3 * scale
    # bf16 on changes the numbers: the rounding is really applied
    p32 = _port_run(x, groups, g, 2, False)
    assert not np.array_equal(pp, p32[0])


def test_ema_stats_are_the_global_batch_statistics():
    """The block rows reconstruct the exact global statistics: the first
    layer sees x itself in both chains, so the ghost chain's mean and
    variance of z equal the exact chain's there."""
    x, (ws, bs, gs, bes), _ = _inputs(3, 8, 128, (3, 16, 8))
    t = [[torch.from_numpy(a) for a in grp] for grp in (ws, bs, gs, bes)]
    _, gm, gv = point_mlp_train_max(torch.from_numpy(x), *t, block_b=2,
                                    bf16=False)
    _, em, ev = point_mlp_exact_train_max(torch.from_numpy(x), *t)
    torch.testing.assert_close(gm[0], em[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gv[0], ev[0], rtol=1e-4, atol=1e-6)


def test_float64_runs_and_refuses_a_batch_without_a_block():
    x, groups, g = _inputs(4, 4, 64, (3, 8, 4))
    t = [[torch.from_numpy(a).double() for a in grp] for grp in groups]
    pooled, _, _ = point_mlp_train_max(torch.from_numpy(x).double(), *t,
                                       block_b=2, bf16=False)
    assert pooled.dtype == torch.float64
    with pytest.raises(ValueError, match="no valid batch block"):
        point_mlp_train_max(torch.from_numpy(x).double(), *t, block_b=3)


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 32, 48, 50, 1024])
@pytest.mark.parametrize("n,widths", [
    (1024, (64, 64, 64, 128, 128)),      # classification
    (2048, (64, 128, 128, 256, 128)),    # reconstruction
    (128, (8, 16, 8)),
    (4096, (64, 64, 64, 128, 128)),
])
@pytest.mark.parametrize("bf16", [True, False])
def test_auto_block_b_matches_jax(batch, n, widths, bf16):
    assert auto_block_b(batch, n, widths, bf16) == jax_auto_block_b(
        batch, n, widths, bf16)


@pytest.mark.parametrize("fused_train", [None, False, True])
@pytest.mark.parametrize("fused_mode", ["ghost", "exact"])
@pytest.mark.parametrize("fused_bf16", [None, False])
@pytest.mark.parametrize("shape,training,pool_max", [
    ((32, 1024, 3), True, True),
    ((50, 2048, 3), True, True),
    ((4, 200, 3), True, True),           # N % 128 != 0
    ((4, 256, 3), False, True),          # eval
    ((4, 256, 3), True, False),          # no pool
])
def test_fused_mode_rule_matches_jax(fused_train, fused_mode, fused_bf16,
                                     shape, training, pool_max):
    widths = (64, 128, 128, 256, 128) if shape[1] == 2048 \
        else (64, 64, 64, 128, 128)
    jmod = JaxPointMLP(features=widths, fused_train=fused_train,
                       fused_mode=fused_mode, fused_bf16=fused_bf16)
    want = jmod._resolve_fused_mode(jnp.zeros(shape), training, pool_max)
    got = layers.resolve_fused_mode(
        torch.zeros(shape), widths, training=training, pool_max=pool_max,
        fused_train=fused_train, fused_mode=fused_mode,
        fused_bf16=fused_bf16)
    assert got == ("ghost" if want == "ghost" else "exact")


def test_fused_mode_rule_refuses_bf16_exact_and_unknown_modes():
    """The exact mode in bf16 resolves (it was refused before the exact
    chain had a bf16 mode): to the bf16 chain where the JAX package's TPU
    runs its exact kernel, to the f32 chain where it falls back to its XLA
    chain (one layer); an unknown mode is still refused."""
    x = torch.zeros(4, 128, 3)
    for widths, want in (((8,), "exact"), ((8, 16), "exact_bf16")):
        assert layers.resolve_fused_mode(
            x, widths, training=True, pool_max=True, fused_train=True,
            fused_mode="exact", fused_bf16=True) == want
    with pytest.raises(ValueError, match="fused_mode"):
        layers.resolve_fused_mode(x, (8,), training=True, pool_max=True,
                                  fused_mode="fast")


def test_point_mlp_takes_the_ghost_chain_when_selected(monkeypatch):
    """PointMLP with fused_train runs point_mlp_train_max (bf16 by default,
    f32 with fused_bf16=False), updates its running statistics from the
    chain's global statistics, and gives the dense biases exact zeros."""
    calls = []
    real = layers.point_mlp_train_max

    def spy(*args, **kwargs):
        calls.append(kwargs["bf16"])
        return real(*args, **kwargs)

    monkeypatch.setattr(layers, "point_mlp_train_max", spy)
    x = torch.from_numpy(np.random.RandomState(5).randn(4, 128, 3)
                         .astype(np.float32))
    for fused_bf16 in (None, False):
        mlp = layers.PointMLP(3, (8, 16), fused_train=True,
                              fused_bf16=fused_bf16)
        out = mlp(x, training=True, pool_max=True)
        out.sum().backward()
        assert mlp.conv1.bias.grad is not None
        assert not mlp.conv1.bias.grad.any()
        assert not torch.equal(mlp.bn1.running_mean, torch.zeros(8))
        assert int(mlp.bn1.num_batches_tracked) == 1
    assert calls == [True, False]
    layers.PointMLP(3, (8, 16))(x, training=True, pool_max=True)
    layers.PointMLP(3, (8, 16), fused_train=True)(x[:, :100], training=True,
                                                  pool_max=True)
    assert calls == [True, False]       # the exact chain for both


def test_wrapper_does_not_fall_back(monkeypatch):
    monkeypatch.setattr(pmt, "use_kernel", lambda t: True)
    x, groups, _ = _inputs(0, 2, 64, (3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        point_mlp_train_max(torch.from_numpy(x),
                            *[[torch.from_numpy(a) for a in grp]
                              for grp in groups], block_b=1)
