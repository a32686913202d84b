"""The port's SampleNet eval forward, the slice as a whole, against the JAX
package on the CPU, on the same weights and inputs.

The JAX SampleNet gets random BN statistics (as in test_torch_parity.py),
its variables go through `samplenet_state_dict_from_jax` into the port,
and both run the eval forward on one numpy batch.

Tolerances: the simplified cloud at rtol 1e-4 / atol 1e-5 (the BN fold and
matmul order reorder f32 roundings). Matched indices and points exactly,
on every cloud without a near-tie: JAX on the CPU takes the NN by
|x|^2+|y|^2-2xy (ops/pairwise.py:44-55) on a simplified cloud that is
itself ~1e-6 away, so a cloud whose NN or FPS step has two candidates
within 1e-4 relative may resolve either way and is left out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.interop import samplenet_to_torch
from samplenet_tpu.models import SampleNet as JaxSampleNet
from samplenet_tpu.ops.matching import nn_match_from_clouds as jax_match
from samplenet_tpu_torch.interop import (
    infer_samplenet_config,
    load_sampler_weights,
    samplenet_state_dict_from_jax,
)
from samplenet_tpu_torch.models import SampleNet
from samplenet_tpu_torch.ops.matching import nn_match_from_clouds

torch.set_num_threads(1)

M, BOTTLENECK = 16, 64
GAP = 1e-4


def _state_dict(sd_np):
    return {k: torch.tensor(np.array(v)) for k, v in sd_np.items()}


@pytest.fixture(scope="module")
def nets():
    net = JaxSampleNet(num_out_points=M, bottleneck_size=BOTTLENECK,
                       group_size=4)
    x = np.random.RandomState(0).randn(4, 256, 3).astype(np.float32)
    v = net.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)
    bs = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.random.RandomState(1).randn(*a.shape)
        .astype(np.float32) if a.ndim else a, v["batch_stats"])
    bs = jax.tree_util.tree_map(lambda a: jnp.abs(a) + 0.5, bs)
    v = {"params": v["params"], "batch_stats": bs}
    sd = samplenet_state_dict_from_jax(v)
    port = SampleNet(**infer_samplenet_config(sd), group_size=4)
    port.load_state_dict(_state_dict(sd))
    return net, v, port.eval(), x


def _near_tie(full, simp, idx, k):
    """[B] bool: the cloud's NN step or FPS completion had two candidates
    within GAP relative."""
    full64, simp64 = full.astype(np.float64), simp.astype(np.float64)
    tie = np.zeros(len(full), bool)
    for b in range(len(full)):
        d = ((simp64[b, :, None] - full64[b, None]) ** 2).sum(-1)
        two = np.sort(d, -1)[:, :2]
        tie[b] = (two[:, 1] - two[:, 0] <= GAP * two[:, 1]).any()
        nn = d.argmin(-1)
        _, first = np.unique(nn, return_index=True)
        dist = np.full(full.shape[1], np.inf)
        for t, sel in enumerate(idx[b][:k]):
            if t >= len(first):
                two = np.sort(dist)[-2:]
                tie[b] |= two[1] - two[0] <= GAP * two[1]
            dist = np.minimum(dist, ((full64[b] - full64[b, sel]) ** 2).sum(-1))
    return tie


def test_state_dict_equals_samplenet_to_torch(nets):
    _, v, port, _ = nets
    ref = samplenet_to_torch(v, prefix="")
    ours = samplenet_state_dict_from_jax(v)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert list(port.state_dict()) == sorted(port.state_dict(),
                                             key=list(ref).index)
    assert set(port.state_dict()) == set(ref)


def test_simplified_cloud_matches_jax(nets):
    net, v, port, x = nets
    simp_j, _ = net.apply(v, jnp.asarray(x), training=False)
    with torch.no_grad():
        simp_t = port.simplify(torch.from_numpy(x))
    np.testing.assert_allclose(simp_t.numpy(), np.asarray(simp_j),
                               rtol=1e-4, atol=1e-5)


def test_matched_points_and_indices_match_jax(nets):
    net, v, port, x = nets
    simp_j, matched_j = net.apply(v, jnp.asarray(x), training=False)
    _, idx_j = jax_match(jnp.asarray(x), simp_j, M)
    with torch.no_grad():
        simp_t, matched_t = port(torch.from_numpy(x))
        _, idx_t = nn_match_from_clouds(torch.from_numpy(x), simp_t, M)
    idx_t, matched_t = idx_t.numpy(), matched_t.numpy()
    np.testing.assert_array_equal(
        matched_t, np.take_along_axis(x, idx_t[..., None], 1))
    clear = ~_near_tie(x, simp_t.numpy(), idx_t, M)
    assert clear.sum() >= 3
    np.testing.assert_array_equal(idx_t[clear], np.asarray(idx_j)[clear])
    np.testing.assert_array_equal(matched_t[clear],
                                  np.asarray(matched_j)[clear])


def test_bcn_layouts(nets):
    _, v, _, x = nets
    sd = _state_dict(samplenet_state_dict_from_jax(v))
    bnc = SampleNet(M, BOTTLENECK)
    bcn = SampleNet(M, BOTTLENECK, input_shape="bcn", output_shape="bcn")
    bnc.load_state_dict(sd)
    bcn.load_state_dict(sd)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        s1, m1 = bnc.eval()(xt)
        s2, m2 = bcn.eval()(xt.transpose(1, 2))
        s3 = bcn.simplify(xt.transpose(1, 2))
    assert s2.shape == (4, 3, M) and m2.shape == (4, 3, M)
    assert torch.equal(s2.transpose(1, 2), s1)
    assert torch.equal(m2.transpose(1, 2), m1)
    assert torch.equal(s3, s2)


def test_train_mode_raises(nets):
    """Train mode runs the soft projection. The hard projection of the
    progressive track, which raised while the nn_snap kernel was not
    ported, now snaps each simplified point to its nearest input point,
    as JAX's hard projection does (compared away from near-ties)."""
    net, v, port, x = nets
    xt = torch.from_numpy(x)
    with torch.no_grad():
        simp, proj = port(xt, training=True)
        hard, w, d = port.project.project(xt, simp, hard=True)
    assert proj.shape == simp.shape == hard.shape and w is None and d is None
    simp = simp.numpy()
    hard_j = np.asarray(net.apply(
        v, jnp.asarray(x), jnp.asarray(simp),
        method=lambda m, pc, q: m.project.project(pc, q, hard=True)[0]))
    d2 = ((simp[:, :, None].astype(np.float64) - x[:, None]) ** 2).sum(-1)
    two = np.sort(d2, -1)[..., :2]
    clear = two[..., 1] - two[..., 0] > GAP * two[..., 1]
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(
        hard.numpy(), np.take_along_axis(x, d2.argmin(-1)[..., None], 1))
    np.testing.assert_array_equal(hard.numpy()[clear], hard_j[clear])


def test_weights_file_with_or_without_sampler_prefix(nets, tmp_path):
    _, v, port, x = nets
    sd = samplenet_state_dict_from_jax(v)
    for prefix in ("", "sampler."):
        path = tmp_path / f"w{len(prefix)}.pth"
        torch.save({f"{prefix}{k}": torch.tensor(np.array(a))
                    for k, a in sd.items()}, path)
        loaded = load_sampler_weights(str(path))
        assert set(loaded) == set(sd)
        other = SampleNet(**infer_samplenet_config(loaded))
        other.load_state_dict(loaded)
        with torch.no_grad():
            assert torch.equal(other.eval()(torch.from_numpy(x))[1],
                               port(torch.from_numpy(x))[1])


def test_sigma_modes_and_temperature(nets):
    _, v, port, _ = nets
    assert float(port.project._temperature.detach()) == float(
        v["params"]["project"]["temperature"])
    for mode, t, want in (("torch", 0.05, 1e-2), ("tf", 0.05, 0.0025),
                          ("recon", 0.05, 0.0025), ("recon", 0.001, 1e-4)):
        net = SampleNet(M, BOTTLENECK, initial_temperature=t,
                        sigma_mode=mode)
        assert float(net.sigma().detach()) == pytest.approx(want, rel=1e-6)
    frozen = SampleNet(M, BOTTLENECK, is_temperature_trainable=False)
    assert not frozen.project._temperature.requires_grad
    assert "project._temperature" in frozen.state_dict()
