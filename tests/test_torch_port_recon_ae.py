"""The port's autoencoder, its losses, the N < 128 eval rule of the point
MLP, and the copied ShapeNet loader, against the JAX package on the CPU.

Weights go from a JAX-initialised `PointNetAE` (random BN statistics and
affines, so eval BN is not the identity) into the port through
`autoencoder_state_dict_from_jax`.

Tolerances, and why:
  * forwards: rtol 1e-4 / atol 1e-5, f32 sums in other orders (the port
    folds eval BN into the affine for N >= 128 and runs the chain below);
  * train forward: rtol 1e-4 / atol 1e-5, and new running statistics
    rtol 1e-4 / atol 1e-6 (the fast variance over B*N points loses a few
    digits to cancellation);
  * Chamfer and soft-assignment losses: rtol 1e-5; EMD: rtol 2e-4, the
    bound of both f32 paths against the f64 oracle (test_emd_kernel.py);
  * FPS order of a reconstruction: bit for bit (same distances, same
    tie order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.data.plyio import load_ply as jax_load_ply
from samplenet_tpu.data.shapenet import (
    load_category_split as jax_load_category_split,
)
from samplenet_tpu.models import autoencoder as jax_ae
from samplenet_tpu_torch.data import plyio, shapenet
from samplenet_tpu_torch.interop import autoencoder_state_dict_from_jax
from samplenet_tpu_torch.models import autoencoder as port_ae
from samplenet_tpu_torch.nn import layers
from samplenet_tpu_torch.ops.cuda import point_mlp_kernel

torch.set_num_threads(1)

NOUT, BNECK = 48, 32


def _perturb(variables, seed):
    rs = np.random.RandomState(seed)

    def f(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return (np.abs(a + 0.3 * rs.randn(*a.shape)) + 0.5).astype(
                np.float32)
        if "bn" in name or "mean" in name:
            return (a + 0.1 * rs.randn(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(f, variables)


@pytest.fixture(scope="module")
def aes():
    jm = jax_ae.PointNetAE(num_output_points=NOUT, bottleneck_size=BNECK)
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((2, 64, 3)), training=False))(
        jax.random.PRNGKey(0))
    v = _perturb(jax.tree.map(np.asarray, v), 1)
    port = port_ae.PointNetAE(NOUT, BNECK)
    port.load_state_dict({k: torch.tensor(np.array(a)) for k, a in
                          autoencoder_state_dict_from_jax(v).items()})
    return jm, v, port


@pytest.mark.parametrize("n", [64, 160])
def test_eval_forward_matches_jax(aes, n):
    jm, v, port = aes
    x = np.random.RandomState(n).randn(3, n, 3).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        z = port.encode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)
    jz = jm.apply(v, jnp.asarray(x), method=jax_ae.PointNetAE.encode)
    np.testing.assert_allclose(z, np.asarray(jz), rtol=1e-4, atol=1e-5)
    assert got.shape == (3, NOUT, 3)


def test_train_forward_and_running_stats_match_jax(aes):
    jm, v, _ = aes
    port = port_ae.PointNetAE(NOUT, BNECK)
    port.load_state_dict({k: torch.tensor(np.array(a)) for k, a in
                          autoencoder_state_dict_from_jax(v).items()})
    x = np.random.RandomState(5).randn(4, 128, 3).astype(np.float32)
    got = port(torch.from_numpy(x), training=True).detach().numpy()
    want, upd = jm.apply(v, jnp.asarray(x), training=True,
                         mutable=["batch_stats"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    new = autoencoder_state_dict_from_jax(
        {"params": v["params"],
         "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    for k, t in port.state_dict().items():
        if "running_" in k:
            np.testing.assert_allclose(t.numpy(), new[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_losses_match_jax():
    rng = np.random.RandomState(7)
    a = rng.randn(2, 96, 3).astype(np.float32)
    b = rng.randn(2, 80, 3).astype(np.float32)
    ta, tb, ja, jb = (torch.from_numpy(a), torch.from_numpy(b),
                      jnp.asarray(a), jnp.asarray(b))
    for port_fn, jax_fn in ((port_ae.ae_chamfer_loss, jax_ae.ae_chamfer_loss),
                            (port_ae.ae_soft_assignment_loss,
                             jax_ae.ae_soft_assignment_loss),
                            (port_ae.ae_per_cloud_chamfer,
                             jax_ae.ae_per_cloud_chamfer)):
        np.testing.assert_allclose(port_fn(ta, tb).numpy(),
                                   np.asarray(jax_fn(ja, jb)), rtol=1e-5)
    b = b[:, :48]                      # EMD: integer saturations 2 and 1
    got = float(port_ae.ae_emd_loss(ta, torch.from_numpy(b)))
    want = float(jax_ae.ae_emd_loss(ja, jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert float(port_ae.ae_chamfer_loss(ta, ta)) < 1e-10
    assert float(port_ae.ae_emd_loss(ta, ta)) < 1e-2


def test_sort_output_matches_jax():
    x = np.random.RandomState(1).randn(2, 64, 3).astype(np.float32)
    got = port_ae.PointNetAE.sort_output(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_ae.PointNetAE.sort_output(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got, axis=1), np.sort(x, axis=1))


@pytest.mark.parametrize("n,kernel", [(64, False), (127, False),
                                      (128, True)])
def test_eval_point_mlp_takes_the_kernel_from_128_points(n, kernel,
                                                         monkeypatch):
    """JAX's rule (nn/layers.py:100-109): the fused eval kernel only for
    N >= 128, and only where no gradient has to cross it; otherwise the
    chain under autograd, so a gradient crosses a frozen network at any
    N. Below 128 points both calls run the same chain, bit for bit; from
    128 the kernel's plain version folds BN into the affine, so the two
    agree to f32 rounding (rtol 1e-5)."""
    calls = []
    real = point_mlp_kernel.point_mlp_max
    monkeypatch.setattr(layers, "point_mlp_max",
                        lambda *a: calls.append(1) or real(*a))
    mlp = layers.PointMLP(3, (16, 32))
    for p in mlp.parameters():
        p.requires_grad_(False)
    x = torch.from_numpy(np.random.RandomState(n).randn(2, n, 3)
                         .astype(np.float32))
    with torch.no_grad():
        ref = mlp(x, pool_max=True)
    assert bool(calls) == kernel
    calls.clear()
    xg = x.clone().requires_grad_(True)
    out = mlp(xg, pool_max=True)
    torch.testing.assert_close(out, ref, rtol=1e-5 if kernel else 0,
                               atol=1e-6 if kernel else 0)
    out.sum().backward()
    assert calls == [] and float(xg.grad.abs().max()) > 0
    # a parameter that requires a gradient keeps the chain too
    mlp.conv1.weight.requires_grad_(True)
    mlp(x, pool_max=True).sum().backward()
    assert calls == [] and float(mlp.conv1.weight.grad.abs().max()) > 0


def test_point_mlp_max_refuses_inputs_that_need_a_gradient():
    x = torch.zeros(1, 4, 3)
    w, b = torch.ones(3, 4), torch.zeros(4)
    with pytest.raises(RuntimeError, match="no backward"):
        point_mlp_kernel.point_mlp_max(x.requires_grad_(True), (w, b))
    with pytest.raises(RuntimeError, match="no backward"):
        point_mlp_kernel.point_mlp_max(torch.zeros(1, 4, 3),
                                       (w.requires_grad_(True), b))
    with torch.no_grad():          # no grad mode: allowed
        assert point_mlp_kernel.point_mlp_max(x, (w, b)).shape == (1, 4)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_round_trip_and_category_split(tmp_path, binary):
    rng = np.random.RandomState(2)
    synset = shapenet.CATEGORY_TO_SYNSET["chair"]
    root = tmp_path / "shape_net_core_uniform_samples_2048" / synset
    root.mkdir(parents=True)
    clouds = rng.randn(20, 40, 3).astype(np.float32)
    for i, c in enumerate(clouds):
        plyio.save_ply(str(root / f"m{i:02d}.ply"), c, binary=binary)
    got = plyio.load_ply(str(root / "m03.ply"))
    np.testing.assert_allclose(got, clouds[3], rtol=1e-6)
    np.testing.assert_array_equal(got, jax_load_ply(str(root / "m03.ply")))
    split = shapenet.load_category_split(str(tmp_path), "chair", 32, seed=4)
    want = jax_load_category_split(str(tmp_path), "chair", 32, seed=4)
    assert [len(s) for s in split] == [17, 1, 2]
    for a, c in zip(split, want):
        np.testing.assert_array_equal(a, c)
    assert split[0].shape[1:] == (32, 3)
    with pytest.raises(FileNotFoundError):
        shapenet.load_category_split(str(tmp_path / "none"), "chair")
