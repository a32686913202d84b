"""The port's layers against the JAX package on the CPU.

The port's PointMLP with pool_max (BN folded, `point_mlp_max`'s plain
version on a CPU tensor) is held against JAX's PointMLP with the fused
Pallas kernel in interpret mode and against its XLA chain; MLPHead
against JAX's MLPHead. Weights and inputs come from a numpy seed.

Tolerances: rtol 1e-4 / atol 1e-5, since the fold reorders f32 roundings
against the unfused chain and the matmuls sum in another order;
`fold_bn_affine` itself at rtol 1e-6, one rsqrt rounding apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.nn.layers import MLPHead as JaxMLPHead
from samplenet_tpu.nn.layers import PointMLP as JaxPointMLP
from samplenet_tpu.ops.pallas.point_mlp_kernel import (
    fold_bn_affine as jax_fold,
)
from samplenet_tpu_torch.nn.layers import MLPHead, PointMLP
from samplenet_tpu_torch.ops.cuda import fold_bn_affine

torch.set_num_threads(1)

FEATS = (64, 64, 64, 128, 64)


def _random_bn(variables, seed):
    """Non-trivial BN statistics so the fold and eval BN transform."""
    rs = np.random.RandomState(seed)
    bs = jax.tree.map(
        lambda a: np.abs(np.asarray(a) + 0.1 * rs.randn(*a.shape)).astype(
            np.float32) + 0.5, variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": bs}


def _load(module, variables, conv: bool):
    """Copies a flax PointMLP / MLPHead variable tree into the port module
    (conv{i}/bn{i} or fc{i}/bn_fc{i}, reference names)."""
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
    module.load_state_dict({k: torch.tensor(np.array(v))
                           for k, v in sd.items()})
    return module.eval()


@pytest.fixture(scope="module")
def point_mlp():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 96, 3).astype(np.float32)
    jm = JaxPointMLP(features=FEATS)
    v = _random_bn(jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1])), 1)
    return jm, v, _load(PointMLP(3, FEATS), v, conv=True), x


def test_fold_bn_affine_matches_jax():
    rs = np.random.RandomState(2)
    args = [rs.randn(8, 16), rs.randn(16), rs.randn(16), rs.randn(16),
            rs.randn(16), np.abs(rs.randn(16)) + 0.1]
    args = [a.astype(np.float32) for a in args]
    jw, jb = jax_fold(*map(jnp.asarray, args))
    tw, tb = fold_bn_affine(*map(torch.from_numpy, args))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)


def test_point_mlp_pool_max_matches_pallas_and_xla(point_mlp):
    jm, v, tm, x = point_mlp
    with torch.no_grad():
        got = tm(torch.from_numpy(x), pool_max=True).numpy()
    fused = JaxPointMLP(features=FEATS, use_pallas=True).apply(
        v, jnp.asarray(x), pool_max=True)                # interpreted kernel
    xla = jm.apply(v, jnp.asarray(x), pool_max=True)
    np.testing.assert_allclose(got, np.asarray(fused), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=1e-4, atol=1e-5)


def test_point_mlp_per_point_matches_xla(point_mlp):
    jm, v, tm, x = point_mlp
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("activate_final", [False, True])
def test_mlp_head_matches_jax(activate_final):
    feats = (32, 32, 24)
    x = np.random.RandomState(3).randn(5, 16).astype(np.float32)
    jm = JaxMLPHead(features=feats, activate_final=activate_final)
    v = _random_bn(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 4)
    tm = _load(MLPHead(16, feats, activate_final=activate_final), v,
               conv=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)


def test_train_mode_is_not_ported_yet(point_mlp):
    """The sampler's train mode is ported (test_torch_port_train_*.py);
    the classifier's, with its dropout, comes with its trainer."""
    from samplenet_tpu_torch.models import PointNetClassifier

    _, _, _, x = point_mlp
    with pytest.raises(NotImplementedError, match="trainer"):
        PointNetClassifier(10)(torch.from_numpy(x), training=True)


def test_init_follows_flax_and_generator():
    a = PointMLP(3, (64, 32), generator=torch.Generator().manual_seed(5))
    b = PointMLP(3, (64, 32), generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.conv2.weight.detach()
    assert w.shape == (32, 64, 1)
    # lecun-normal: std sqrt(1/fan_in), truncated at 2 std before rescaling
    std = 1.0 / np.sqrt(64) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-6
    assert abs(float(w.std()) - np.sqrt(1 / 64)) < 0.2 * np.sqrt(1 / 64)
    assert torch.equal(a.bn1.running_var, torch.ones(64))
    assert not a.conv1.bias.detach().any()
