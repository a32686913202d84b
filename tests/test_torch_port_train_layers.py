"""The port's train-mode layers against the JAX package on the CPU.

BatchNorm in training against flax's (batch statistics, biased fast
variance clamped at 0, running averages with momentum 0.9); the per-point
MLP with pool_max in training (`point_mlp_exact_train_max`'s plain
version on a CPU tensor) against JAX's XLA chain (`PointMLP(fused_train=
False)`) and against the exact-BN Pallas kernel in interpret mode, at
FEATS (8, 16, 8), B=4, N=128 as in test_pallas_kernels.py:512-590:
forward, the running statistics, and every gradient, with the dense
bias's gradient exactly 0.

Tolerances: forward and statistics rtol 1e-5 / atol 1e-6 (f32 sums in
another order); gradients rtol 1e-3 / atol 1e-5, those of the JAX test
of the Pallas kernel against the XLA chain.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.nn.layers import MLPHead as JaxMLPHead
from samplenet_tpu.nn.layers import PointMLP as JaxPointMLP
from samplenet_tpu.ops.pallas.point_mlp_exact_kernel import (
    point_mlp_exact_train_max as jax_exact,
)
from samplenet_tpu_torch.nn.layers import BatchNorm, MLPHead, PointMLP
from samplenet_tpu_torch.ops.cuda import point_mlp_exact_train_max

torch.set_num_threads(1)

FEATS = (8, 16, 8)
B, N = 4, 128


def _t(a, grad=False):
    return torch.tensor(np.array(a), requires_grad=grad)


def _load(module, variables, conv: bool):
    """A flax PointMLP / MLPHead variable tree into the port module."""
    p, s = variables["params"], variables["batch_stats"]
    layer, bn_name = ("conv", "bn") if conv else ("fc", "bn_fc")
    sd = {}
    for i in range(sum(k.startswith("dense_") for k in p)):
        w = np.asarray(p[f"dense_{i}"]["kernel"]).T
        sd[f"{layer}{i + 1}.weight"] = w[:, :, None] if conv else w
        sd[f"{layer}{i + 1}.bias"] = np.asarray(p[f"dense_{i}"]["bias"])
        if f"bn_{i}" in p:
            sd[f"{bn_name}{i + 1}.weight"] = np.asarray(p[f"bn_{i}"]["scale"])
            sd[f"{bn_name}{i + 1}.bias"] = np.asarray(p[f"bn_{i}"]["bias"])
            sd[f"{bn_name}{i + 1}.running_mean"] = np.asarray(
                s[f"bn_{i}"]["mean"])
            sd[f"{bn_name}{i + 1}.running_var"] = np.asarray(
                s[f"bn_{i}"]["var"])
            sd[f"{bn_name}{i + 1}.num_batches_tracked"] = np.asarray(0)
    module.load_state_dict({k: _t(v) for k, v in sd.items()})
    return module


@pytest.fixture(scope="module")
def chain():
    """JAX's XLA chain, perturbed variables, and the input (as
    test_pallas_kernels.py:520-531)."""
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(B, N, 3), jnp.float32)
    plain = JaxPointMLP(features=FEATS, fused_train=False)
    v = plain.init(jax.random.PRNGKey(0), x[:2], training=False)
    r = np.random.RandomState(1)
    v = jax.tree.map(
        lambda a: a + 0.1 * r.randn(*a.shape).astype(np.float32), v)
    return plain, v, x


def test_batchnorm_train_matches_flax():
    rng = np.random.RandomState(2)
    x = rng.randn(6, 10, 5).astype(np.float32) * 3 + 1
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree.map(
        lambda a: a + 0.3 * rng.randn(*a.shape).astype(np.float32), v)
    want, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(5)
    port.load_state_dict({
        "weight": _t(v["params"]["scale"]), "bias": _t(v["params"]["bias"]),
        "running_mean": _t(v["batch_stats"]["mean"]),
        "running_var": _t(v["batch_stats"]["var"]),
        "num_batches_tracked": torch.tensor(0)})
    got = port(torch.from_numpy(x), training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(port, ours).numpy(),
            np.asarray(upd["batch_stats"][theirs]), rtol=1e-5, atol=1e-6)
    assert int(port.num_batches_tracked) == 1


def test_batchnorm_variance_is_biased_fast_and_clamped():
    x = torch.tensor([[1.0, 5.0], [3.0, 5.0]])
    bn = BatchNorm(2)
    bn(x, training=True)
    # biased: var of (1, 3) is 1, not 2; a constant channel gives 0, not < 0
    np.testing.assert_allclose(bn.running_var.numpy(),
                               [0.9 * 1 + 0.1 * 1.0, 0.9 * 1 + 0.1 * 0.0])
    np.testing.assert_allclose(bn.running_mean.numpy(), [0.2, 0.5])


def test_point_mlp_exact_forward_and_ema_match_xla_chain(chain):
    plain, v, x = chain
    want, upd = plain.apply(v, x, training=True, pool_max=True,
                            mutable=["batch_stats"])
    port = _load(PointMLP(3, FEATS), v, conv=True)
    with torch.no_grad():
        got = port(_t(x), training=True, pool_max=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    for i in range(len(FEATS)):
        bn = getattr(port, f"bn{i + 1}")
        np.testing.assert_allclose(
            bn.running_mean.numpy(),
            np.asarray(upd["batch_stats"][f"bn_{i}"]["mean"]),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            bn.running_var.numpy(),
            np.asarray(upd["batch_stats"][f"bn_{i}"]["var"]),
            rtol=1e-5, atol=1e-6)


def test_point_mlp_exact_gradients_match_xla_chain(chain):
    plain, v, x = chain

    def loss(params, xx):
        out, _ = plain.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, xx,
            training=True, pool_max=True, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(out))

    g, gx = jax.grad(loss, argnums=(0, 1))(v["params"], x)
    port = _load(PointMLP(3, FEATS), v, conv=True)
    xt = _t(x, grad=True)
    torch.sin(port(xt, training=True, pool_max=True)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    for i in range(len(FEATS)):
        conv, bn = getattr(port, f"conv{i + 1}"), getattr(port, f"bn{i + 1}")
        for got, want in ((conv.weight.grad[:, :, 0].T,
                           g[f"dense_{i}"]["kernel"]),
                          (bn.weight.grad, g[f"bn_{i}"]["scale"]),
                          (bn.bias.grad, g[f"bn_{i}"]["bias"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-3, atol=1e-5)
        # BN's mean subtraction cancels the dense bias exactly
        assert not conv.bias.grad.any()


def test_point_mlp_exact_matches_interpreted_kernel(chain):
    _, v, x = chain
    p = v["params"]
    args = [[p[f"dense_{i}"][k] for i in range(3)] for k in ("kernel",
                                                             "bias")]
    args += [[p[f"bn_{i}"][k] for i in range(3)] for k in ("scale", "bias")]
    gout = np.random.RandomState(3).randn(B, FEATS[-1]).astype(np.float32)

    def loss(xx, ws, gs, bes):
        out, _, _ = jax_exact(xx, tuple(ws), tuple(args[1]), tuple(gs),
                              tuple(bes), interpret=True)
        return jnp.sum(out * gout)

    want, means, vars_ = jax_exact(x, *map(tuple, args), interpret=True)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(x, args[0], args[2],
                                                 args[3])
    xt = _t(x, grad=True)
    targs = [[_t(a, grad=True) for a in group] for group in args]
    got, gmeans, gvars = point_mlp_exact_train_max(xt, *targs)
    (got * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip((*gmeans, *gvars), (*means, *vars_)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grads[0]),
                               rtol=1e-4, atol=1e-5)
    for group, want_group in zip((targs[0], targs[2], targs[3]), grads[1:]):
        for a, b in zip(group, want_group):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                       rtol=1e-3, atol=1e-5)
    for bias in targs[1]:
        assert bias.grad is not None and not bias.grad.any()


def test_per_point_train_chain_matches_flax(chain):
    plain, v, x = chain
    want, upd = plain.apply(v, x, training=True, mutable=["batch_stats"])
    port = _load(PointMLP(3, FEATS), v, conv=True)
    with torch.no_grad():
        got = port(_t(x), training=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        port.bn3.running_var.numpy(),
        np.asarray(upd["batch_stats"]["bn_2"]["var"]), rtol=1e-5, atol=1e-6)


def test_mlp_head_train_matches_flax():
    feats = (32, 32, 24)
    rng = np.random.RandomState(4)
    x = rng.randn(16, 12).astype(np.float32)
    jm = JaxMLPHead(features=feats, activate_final=True)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    v = jax.tree.map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32), v)
    want, upd = jm.apply(v, jnp.asarray(x), training=True,
                         mutable=["batch_stats"])
    port = _load(MLPHead(12, feats, activate_final=True), v, conv=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x), training=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    for i in range(len(feats)):
        np.testing.assert_allclose(
            getattr(port, f"bn_fc{i + 1}").running_var.numpy(),
            np.asarray(upd["batch_stats"][f"bn_{i}"]["var"]), rtol=1e-5,
            atol=1e-6)
