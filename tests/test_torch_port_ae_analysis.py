"""The port's AE analysis ops and ConvDecoder against the JAX package on the
CPU, on weights carried by `autoencoder_state_dict_from_jax` and
`conv_decoder_state_dict_from_jax` (random BN statistics and affines, so
that eval BN is not the identity).

The AE takes 128-point clouds, the least at which its eval encoder is
`point_mlp_max` (nn/layers.py::use_eval_kernel; its plain version here),
and the sampled clouds 16 points, where the chain runs as tensor ops.

Tolerances, and why:
  * forwards, latents, interpolations and per-cloud Chamfer distances:
    rtol 1e-5 / atol 1e-6 (f32 sums in other orders; the eval encoder of
    128-point clouds folds BN into the affine, which moves a latent by up
    to ~4e-7 here);
  * through approx_match (match_samples, interpolate_samples): the
    argmaxes exactly on every row whose top two weights are more than 1e-4
    apart, the points then exactly, the interpolation at rtol 1e-4;
  * critical_idx: exactly on every channel whose two largest per-point
    values are more than 1e-5 of scale apart (a ReLU zero shared by
    several points is a tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.models import ae_analysis as jax_ana
from samplenet_tpu.models import autoencoder as jax_ae
from samplenet_tpu.ops.matching import approx_match as jax_approx_match
from samplenet_tpu_torch.interop import (
    autoencoder_state_dict_from_jax,
    conv_decoder_state_dict_from_jax,
)
from samplenet_tpu_torch.models import ConvDecoder, ae_analysis
from samplenet_tpu_torch.models import autoencoder as port_ae
from tests.test_torch_port_recon_ae import _perturb

torch.set_num_threads(1)

N, NOUT, BNECK, MS = 128, 128, 32, 16


@pytest.fixture(scope="module")
def aes():
    jm = jax_ae.PointNetAE(num_output_points=NOUT, bottleneck_size=BNECK)
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((2, N, 3)), training=False))(
        jax.random.PRNGKey(0))
    v = _perturb(jax.tree.map(np.asarray, v), 1)
    port = port_ae.PointNetAE(NOUT, BNECK)
    port.load_state_dict({k: torch.tensor(np.array(a)) for k, a in
                          autoencoder_state_dict_from_jax(v).items()})
    return jm, v, port.eval()


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_transform_and_decode_match_jax(aes):
    jm, v, port = aes
    x = _rand(0, 3, N, 3)
    with torch.no_grad():
        z = ae_analysis.transform(port, torch.from_numpy(x)).numpy()
    jz = np.asarray(jax_ana.transform(jm, v, jnp.asarray(x)))
    np.testing.assert_allclose(z, jz, rtol=1e-5, atol=1e-6)
    code = _rand(1, 3, BNECK)
    with torch.no_grad():
        rec = ae_analysis.decode(port, torch.from_numpy(code)).numpy()
    np.testing.assert_allclose(
        rec, np.asarray(jax_ana.decode(jm, v, jnp.asarray(code))),
        rtol=1e-5, atol=1e-6)
    assert rec.shape == (3, NOUT, 3)


@pytest.mark.parametrize("steps", [0, 3])
def test_interpolate_matches_jax(aes, steps):
    jm, v, port = aes
    x, y = _rand(2, N, 3), _rand(3, N, 3)
    with torch.no_grad():
        got = ae_analysis.interpolate(port, torch.from_numpy(x),
                                      torch.from_numpy(y), steps).numpy()
    want = np.asarray(jax_ana.interpolate(jm, v, jnp.asarray(x),
                                          jnp.asarray(y), steps))
    assert got.shape == (steps + 2, NOUT, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _clear_rows(match: np.ndarray, gap: float) -> np.ndarray:
    """[B, rows] bool: the row's two largest entries differ by more than
    `gap` of the largest."""
    top = np.sort(match, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0] > gap * np.abs(top[..., 1])


def test_match_samples_matches_jax():
    s1, s2 = _rand(4, 3, MS, 3), _rand(5, 3, MS, 3)
    got = ae_analysis.match_samples(torch.from_numpy(s1),
                                    torch.from_numpy(s2)).numpy()
    want = np.asarray(jax_ana.match_samples(jnp.asarray(s1), jnp.asarray(s2)))
    clear = _clear_rows(np.asarray(jax_approx_match(jnp.asarray(s2),
                                                    jnp.asarray(s1))), 1e-4)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])
    for b in range(3):      # every output point is a point of s1
        assert all((s1[b] == p).all(-1).any() for p in got[b])


@pytest.mark.parametrize("steps", [0, 4])
def test_interpolate_samples_matches_jax(steps):
    s1, s2 = _rand(6, MS, 3), _rand(7, MS, 3)
    got = ae_analysis.interpolate_samples(torch.from_numpy(s1),
                                          torch.from_numpy(s2), steps).numpy()
    want = np.asarray(jax_ana.interpolate_samples(jnp.asarray(s1),
                                                  jnp.asarray(s2), steps))
    assert got.shape == (steps + 2, MS, 3)
    clear = _clear_rows(np.asarray(jax_approx_match(
        jnp.asarray(s2[None]), jnp.asarray(s1[None])))[0], 1e-4)
    assert clear.mean() > 0.9
    np.testing.assert_allclose(got[:, clear], want[:, clear], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(got[-1], s2)


def test_critical_idx_matches_jax(aes):
    jm, v, port = aes
    x = _rand(8, 3, N, 3)
    with torch.no_grad():
        got = ae_analysis.critical_idx(port, torch.from_numpy(x)).numpy()
        feats = port.encoder(torch.from_numpy(x)).numpy()     # [B, N, C]
    want = np.asarray(jax_ana.critical_idx(jm, v, jnp.asarray(x)))
    assert got.shape == (3, BNECK) and got.dtype == np.int32
    top = np.sort(feats, axis=1)[:, -2:]                        # [B, 2, C]
    clear = top[:, 1] - top[:, 0] > 1e-5 * np.abs(feats).max()
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], want[clear])


def test_reconstructions_from_sampled_matches_jax(aes):
    jm, v, port = aes
    sampled = _rand(9, 5, MS, 3)
    got = ae_analysis.reconstructions_from_sampled(port, sampled,
                                                   batch_size=2)
    want = jax_ana.reconstructions_from_sampled(jm, v, sampled, batch_size=2)
    assert isinstance(got, np.ndarray) and got.shape == (5, NOUT, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    full = _rand(10, 3, N, 3)         # 128 points: the eval kernel's path
    np.testing.assert_allclose(
        ae_analysis.reconstructions_from_sampled(port, full),
        jax_ana.reconstructions_from_sampled(jm, v, full),
        rtol=1e-5, atol=1e-6)


def test_nn_distances_per_cloud_matches_jax(aes):
    jm, v, port = aes
    clouds, samples = _rand(11, 5, N, 3), _rand(12, 5, MS, 3)
    got = ae_analysis.nn_distances_per_cloud(port, clouds, samples,
                                             batch_size=2)
    want = jax_ana.nn_distances_per_cloud(jm, v, clouds, samples,
                                          batch_size=2)
    assert isinstance(got, np.ndarray) and got.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_bn", [True, False])
@pytest.mark.parametrize("training", [False, True])
def test_conv_decoder_matches_jax(use_bn, training):
    jm = jax_ae.ConvDecoder(num_output_points=24, widths=(32, 16),
                            use_bn=use_bn)
    z = _rand(13, 4, BNECK)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(z))
    if use_bn:
        v = _perturb(jax.tree.map(np.asarray, v), 3)
    port = ConvDecoder(24, BNECK, widths=(32, 16), use_bn=use_bn)
    sd = conv_decoder_state_dict_from_jax(v)
    port.load_state_dict({k: torch.tensor(np.array(a)) for k, a in sd.items()})
    assert set(sd) == set(port.state_dict())
    with torch.no_grad():
        got = port(torch.from_numpy(z), training=training).numpy()
    if training and use_bn:
        want, _ = jm.apply(v, jnp.asarray(z), training=True,
                           mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(z), training=training)
    assert got.shape == (4, 24, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
