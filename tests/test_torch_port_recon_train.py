"""The port's reconstruction track, the slice as a whole, against the JAX
package on the CPU: one AE train step (Chamfer and EMD), one SampleNet
step against the frozen AE with the gradient that crosses the AE, the NRE
evaluation with SampleNet and with FPS, and the CLI's two phases.

Set-up: JAX-initialised models (the AE's BN statistics and affines
perturbed, so eval BN is not the identity), carried into the port with
`autoencoder_state_dict_from_jax` and `samplenet_state_dict_from_jax`;
inputs from numpy seeds. JAX's EMD runs its fused Pallas kernel in
interpret mode (as tests/test_emd_kernel.py runs it), so both sides
compute d2 in broadcast-difference form.

Tolerances, and why:
  * losses and metrics: rtol 1e-5 (Chamfer) and 1e-4 (EMD: the two sum
    in other orders);
  * gradients: rtol 1e-3 with an atol of 1e-4 times the tensor's largest
    entry, as the classification track's step test holds them: at random
    initialisation and small batch the conv chain's gradients are
    ill-conditioned, so f32 round-off needs a floor tied to the scale.
    Through the EMD, 2e-3 of each tensor's norm instead: where the steep
    auction levels meet a near-tie, two f32 sums in other orders move a
    few points' match, and the decoder's gradient with them (0.04% of
    dec_out's entries, by up to 7e-4, in the EMD step below);
  * new running statistics rtol 1e-4 / atol 1e-6;
  * updated parameters atol 1e-6 where JAX's gradient is resolved (above
    1e-4 of its tensor's largest entry): Adam's first step is +-lr there.
  * NRE and its two means: rtol 1e-5.
Left out of the parameter comparison: the dense biases before each conv
BN, whose gradient is zero in exact arithmetic. JAX's XLA chain gives them
round-off that Adam's first step turns into +-lr; the port's exact chain
gives exact zeros. Their gradients are held to be round-off on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import samplenet_tpu.ops.pallas.emd_kernel as jax_emd_kernel
from samplenet_tpu.models.losses import (
    reconstruction_simplification_loss as jax_recon_simp_loss,
)
from samplenet_tpu.models.samplenet import SampleNet as JaxSampleNet
from samplenet_tpu.train import reconstruction as jr
from samplenet_tpu_torch.interop import (
    autoencoder_state_dict_from_jax,
    samplenet_state_dict_from_jax,
)
from samplenet_tpu_torch.models.autoencoder import PointNetAE
from samplenet_tpu_torch.train import reconstruction as pr
from samplenet_tpu_torch.train import train_reconstruction

torch.set_num_threads(1)

N = 64                 # points per cloud, and the AE's output points
B = 8
BNECK = 32
M, K = 16, 4           # sampled points, soft-projection group size
AE_CANCELLED = {f"encoder.conv{i}.bias" for i in range(1, 6)}
SN_CANCELLED = {f"conv{i}.bias" for i in range(1, 6)}


def _sd(tree):
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(variables, seed):
    rs = np.random.RandomState(seed)

    def f(path, a):
        name = jax.tree_util.keystr(path)
        if "batch_stats" in name and "var" in name:
            return (np.abs(a + 0.3 * rs.randn(*a.shape)) + 0.5).astype(
                np.float32)
        if "batch_stats" in name or "bn_" in name:
            return (a + 0.1 * rs.randn(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(f, variables)


@pytest.fixture(scope="module")
def interpreted_jax_emd():
    """JAX's fused EMD in interpret mode (the Pallas kernel off-TPU)."""
    orig = jax_emd_kernel.emd_cost_pallas
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_emd_kernel, "emd_cost_pallas",
                   lambda a, b, with_grads=True, interpret=False: orig(
                       a, b, with_grads=with_grads, interpret=True))
        yield


def _clouds(seed, b=B, n=N):
    return np.random.RandomState(seed).randn(b, n, 3).astype(np.float32)


def _assert_grads(port_model, jgrads, cancelled, normwise=False):
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, p in port_model.named_parameters():
        got, want = p.grad.numpy(), jgrads[name]
        if name in cancelled:
            assert not got.any(), name            # the exact chain's zeros
            assert float(np.abs(want).max()) < 1e-5 * scale, name
            continue
        if normwise:
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err < 2e-3, (name, err)
            continue
        np.testing.assert_allclose(
            got, want, rtol=1e-3, atol=1e-4 * float(np.abs(want).max()),
            err_msg=name)


def _assert_updated(port_model, jnew, jgrads, cancelled):
    for name, v in port_model.state_dict().items():
        if name.endswith("num_batches_tracked") or name in cancelled:
            continue
        if "running_" in name:
            np.testing.assert_allclose(v.numpy(), jnew[name], rtol=1e-4,
                                       atol=1e-6, err_msg=name)
            continue
        g = np.abs(jgrads[name])
        resolved = g > 1e-4 * g.max()
        np.testing.assert_allclose(v.numpy()[resolved], jnew[name][resolved],
                                   atol=1e-6, err_msg=name)


# ------------------------------------------------------------ AE train step

@pytest.mark.parametrize("loss", ["chamfer", "emd"])
def test_ae_train_step_matches_jax(loss, interpreted_jax_emd):
    x = _clouds(0)
    jcfg = jr.AEConfig(num_points=N, bottleneck_size=BNECK, batch_size=B,
                       n_sample_points=N, loss=loss,
                       emd_kernel=True if loss == "emd" else None)
    jmodel, jstate = jr.create_ae_state(jcfg, jax.random.PRNGKey(0))
    v0 = {"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)}
    inner = jr._ae_loss_fn(loss, False, jcfg.emd_kernel)

    def loss_fn(params):
        recon, _ = jmodel.apply({"params": params, "batch_stats":
                                 jstate.batch_stats}, jnp.asarray(x),
                                training=True, mutable=["batch_stats"])
        return inner(recon, jnp.asarray(x))

    jgrads = autoencoder_state_dict_from_jax(
        {"params": _np(jax.jit(jax.grad(loss_fn))(jstate.params)),
         "batch_stats": v0["batch_stats"]})
    jnew, jloss = jr.make_ae_train_step(jmodel, jcfg)(jstate, jnp.asarray(x))
    jnewsd = autoencoder_state_dict_from_jax(
        {"params": _np(jnew.params), "batch_stats": _np(jnew.batch_stats)})

    cfg = pr.AEConfig(num_points=N, bottleneck_size=BNECK, batch_size=B,
                      n_sample_points=N, loss=loss)
    model, state = pr.create_ae_state(cfg)
    model.load_state_dict(_sd(autoencoder_state_dict_from_jax(v0)))
    got = pr.make_ae_train_step(model, cfg)(state, torch.from_numpy(x))
    np.testing.assert_allclose(float(got), float(jloss),
                               rtol=1e-5 if loss == "chamfer" else 1e-4)
    assert state.step == 1 and state.optimizer.count == 1
    _assert_grads(model, jgrads, AE_CANCELLED, normwise=loss == "emd")
    _assert_updated(model, jnewsd, jgrads, AE_CANCELLED)


def test_ae_train_step_denoising_and_fps_front_end():
    """(noisy x, clean gt) scores against gt; the FPS front-end feeds the
    encoder n_sample_points FPS points of x."""
    x = torch.from_numpy(_clouds(1))
    noisy = x + 0.02 * torch.from_numpy(_clouds(2))
    cfg = pr.AEConfig(num_points=N, bottleneck_size=BNECK, batch_size=B,
                      n_sample_points=N)
    losses = []
    for args in ((x,), (noisy, x)):
        model, state = pr.create_ae_state(cfg)
        losses.append(float(pr.make_ae_train_step(model, cfg)(state, *args)))
    assert losses[0] != losses[1] and all(np.isfinite(losses))
    fcfg = pr.AEConfig(num_points=N, bottleneck_size=BNECK, batch_size=B,
                       n_sample_points=32, use_fps=True)
    model, state = pr.create_ae_state(fcfg)
    seen = []
    model.register_forward_pre_hook(lambda mod, a, kw: seen.append(a[0]),
                                    with_kwargs=True)
    pr.make_ae_train_step(model, fcfg)(state, x)
    from samplenet_tpu_torch.ops.fps import farthest_point_sample_with_points
    assert torch.equal(seen[0], farthest_point_sample_with_points(32, x)[1])


# ------------------------------------------- SampleNet against the frozen AE

@pytest.fixture(scope="module")
def sampler_setup():
    acfg = jr.AEConfig(num_points=N, bottleneck_size=BNECK, batch_size=B,
                       n_sample_points=N)
    jae, astate = jr.create_ae_state(acfg, jax.random.PRNGKey(0))
    ae_vars = _perturb({"params": _np(astate.params),
                        "batch_stats": _np(astate.batch_stats)}, 3)
    jcfg = jr.SampleNetAEConfig(num_out_points=M, group_size=K, batch_size=B,
                                bottleneck_size=BNECK)
    jsampler, jstate = jr.create_sampler_ae_state(jcfg, N,
                                                  jax.random.PRNGKey(1))
    sv0 = {"params": _np(jstate.params),
           "batch_stats": _np(jstate.batch_stats)}
    ae = PointNetAE(N, BNECK)
    ae.load_state_dict(_sd(autoencoder_state_dict_from_jax(ae_vars)))
    cfg = pr.SampleNetAEConfig(num_out_points=M, group_size=K, batch_size=B,
                               bottleneck_size=BNECK)
    return dict(jae=jae, ae_vars=ae_vars, jcfg=jcfg, jsampler=jsampler,
                jstate=jstate, sv0=sv0, ae=ae, cfg=cfg)


def _port_sampler(s):
    sampler, state = pr.create_sampler_ae_state(s["cfg"])
    sampler.load_state_dict(_sd(samplenet_state_dict_from_jax(s["sv0"])))
    return sampler, state


def test_sampler_ae_train_step_matches_jax(sampler_setup):
    s = sampler_setup
    x = _clouds(4)
    jsampler, jcfg, jae, ae_vars = s["jsampler"], s["jcfg"], s["jae"], \
        s["ae_vars"]

    def loss_fn(params):          # reconstruction.py:185-196
        variables = {"params": params, "batch_stats": s["sv0"]["batch_stats"]}
        (q, sp), _ = jsampler.apply(variables, jnp.asarray(x), training=True,
                                    mutable=["batch_stats"])
        loss_ae = jr._ae_loss_fn("chamfer")(jae.apply(ae_vars, sp),
                                            jnp.asarray(x))
        loss_simp = jax_recon_simp_loss(jnp.asarray(x), q, M)
        sigma = jsampler.apply(variables,
                               method=JaxSampleNet.get_projection_loss)
        return loss_ae + jcfg.alpha * loss_simp + jcfg.lmbda * sigma

    params = jax.tree.map(jnp.asarray, s["sv0"]["params"])
    jgrads = samplenet_state_dict_from_jax(
        {"params": _np(jax.jit(jax.grad(loss_fn))(params)),
         "batch_stats": s["sv0"]["batch_stats"]})
    jstate = s["jstate"].replace(
        params=params, batch_stats=jax.tree.map(jnp.asarray,
                                                s["sv0"]["batch_stats"]))
    jstep = jr.make_sampler_ae_train_step(jsampler, jae, ae_vars, jcfg)
    jnew, jm = jstep(jstate, jnp.asarray(x))
    jnewsd = samplenet_state_dict_from_jax(
        {"params": _np(jnew.params), "batch_stats": _np(jnew.batch_stats)})

    sampler, state = _port_sampler(s)
    pm = pr.make_sampler_ae_train_step(sampler, s["ae"], s["cfg"])(
        state, torch.from_numpy(x))
    for k in ("loss", "ae", "simplification", "projection"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    _assert_grads(sampler, jgrads, SN_CANCELLED)
    _assert_updated(sampler, jnewsd, jgrads, SN_CANCELLED)
    # the AE is frozen: no parameter of it has, or needs, a gradient
    assert all(p.grad is None and not p.requires_grad
               for p in s["ae"].parameters())


def test_gradient_through_the_frozen_ae_matches_jax(sampler_setup):
    """d loss_ae / d sample for the sample's 16 points: the AE's encoder
    runs its chain under autograd there (N < 128), and the gradient
    reaches the sample through it."""
    s = sampler_setup
    x = _clouds(5)
    sample = _clouds(6, n=M)
    jg = jax.jit(jax.grad(lambda q: jr._ae_loss_fn("chamfer")(
        s["jae"].apply(s["ae_vars"], q), jnp.asarray(x))))(jnp.asarray(sample))
    q = torch.from_numpy(sample).requires_grad_(True)
    pr.ae_loss_fn("chamfer")(s["ae"](q), torch.from_numpy(x)).backward()
    scale = float(np.abs(np.asarray(jg)).max())
    assert scale > 0
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(jg), rtol=1e-3,
                               atol=1e-4 * scale)


def test_sampler_step_with_128_sampled_points(sampler_setup):
    """m = 128 (ratio 2 on 256 points; the paper's ratios reach m = 1024 on
    2048): the frozen AE gets 128 soft-projected points that need a
    gradient, so its encoder runs the chain under autograd, not the
    forward-only eval kernel it takes from 128 points without one. The
    gradient that reaches the sample is JAX's, held as the 16-point case
    above; then a whole sampler step runs and updates the sampler."""
    s = sampler_setup
    x = _clouds(10, b=2, n=256)
    sample = _clouds(11, b=2, n=128)
    jg = jax.jit(jax.grad(lambda q: jr._ae_loss_fn("chamfer")(
        s["jae"].apply(s["ae_vars"], q), jnp.asarray(x))))(jnp.asarray(sample))
    q = torch.from_numpy(sample).requires_grad_(True)
    pr.ae_loss_fn("chamfer")(s["ae"](q), torch.from_numpy(x)).backward()
    scale = float(np.abs(np.asarray(jg)).max())
    assert scale > 0
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(jg), rtol=1e-3,
                               atol=1e-4 * scale)
    cfg = pr.SampleNetAEConfig(num_out_points=128, group_size=K,
                               batch_size=2, bottleneck_size=BNECK)
    sampler, state = pr.create_sampler_ae_state(cfg)
    metrics = pr.make_sampler_ae_train_step(sampler, s["ae"], cfg)(
        state, torch.from_numpy(x))
    assert state.step == 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    head = [p.grad for name, p in sampler.named_parameters()
            if name.startswith("fc")]
    assert head and all(g is not None and bool(g.abs().max() > 0)
                        for g in head)


# ------------------------------------------------------------- evaluation

def test_eval_steps_and_nre_match_jax(sampler_setup):
    s = sampler_setup
    data = _clouds(7, b=6)
    jstate = s["jstate"].replace(params=jax.tree.map(jnp.asarray,
                                                     s["sv0"]["params"]))
    sampler, state = _port_sampler(s)
    for jstep, pstep in (
            (jr.make_sampler_ae_eval_step(s["jsampler"], s["jae"],
                                          s["ae_vars"]),
             pr.make_sampler_ae_eval_step(sampler, s["ae"])),
            (jr.make_fps_ae_eval_step(s["jae"], s["ae_vars"], M),
             pr.make_fps_ae_eval_step(s["ae"], M))):
        ls, lf = pstep(state, torch.from_numpy(data[:4]))
        jls, jlf = jstep(jstate, jnp.asarray(data[:4]))
        np.testing.assert_allclose(ls.numpy(), np.asarray(jls), rtol=1e-5)
        np.testing.assert_allclose(lf.numpy(), np.asarray(jlf), rtol=1e-5)
        got = pr.evaluate_nre(pstep, state, data, 4, device="cpu")
        want = jr.evaluate_nre(jstep, jstate, data, 4)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
        rng_a, rng_b = np.random.RandomState(9), np.random.RandomState(9)
        noisy = pr.evaluate_nre(
            pstep, state, data, 4, device="cpu",
            noise_fn=lambda b: b + 0.02 * rng_a.randn(*b.shape).astype("f4"))
        jnoisy = jr.evaluate_nre(
            jstep, jstate, data, 4,
            noise_fn=lambda b: b + 0.02 * rng_b.randn(*b.shape).astype("f4"))
        np.testing.assert_allclose(noisy["nre"], jnoisy["nre"], rtol=1e-5)


# -------------------------------------------------------------------- CLI

def test_cli_both_phases(tmp_path, capsys):
    common = ["--device", "cpu", "--num-points", "64", "--batch-size", "4",
              "--train-size", "8", "--test-size", "4", "--epochs", "1",
              "--steps-per-epoch", "2"]
    ae_dir = tmp_path / "ae"
    state = train_reconstruction.main(
        common + ["--phase", "ae", "--loss", "emd", "--log-dir", str(ae_dir),
                  "--denoising-sigma", "0.01"])
    assert state.step == 2
    out = capsys.readouterr().out
    assert "epoch 0: train=" in out and "test=" in out
    sd = torch.load(ae_dir / "ckpt" / "ae.pth", weights_only=True)
    assert sd["dec_out.weight"].shape == (3 * 64, 256)
    sn_dir = tmp_path / "sn"
    sn = common + ["--phase", "samplenet", "--ae-ckpt", str(ae_dir / "ckpt"),
                   "--num-out-points", "8", "--group-size", "4",
                   "--fps-baseline", "--log-dir", str(sn_dir)]
    state = train_reconstruction.main(sn)
    assert state.step == 2
    out = capsys.readouterr().out
    assert "'loss': 'emd'" in out            # the AE's loss, from its config
    assert "| NRE=" in out and "FPS baseline @8: NRE=" in out
    assert (sn_dir / "ckpt" / "sampler.pth").exists()
    # eval only, from the published checkpoints
    train_reconstruction.main(common[:-4] + [
        "--epochs", "0", "--phase", "ae", "--init-ckpt",
        str(ae_dir / "ckpt"), "--log-dir", str(tmp_path / "ae_eval")])
    assert "eval-only: test=" in capsys.readouterr().out
    train_reconstruction.main(sn[:sn.index("--epochs")] + sn[
        sn.index("--phase"):] + ["--epochs", "0", "--init-ckpt",
                                 str(sn_dir / "ckpt")])
    out = capsys.readouterr().out
    assert "eval-only: NRE=" in out and "FPS baseline @8" in out


@pytest.mark.parametrize("flags,match", [
    (["--progressive"], "progressive"),
    (["--fused-train"], "ghost"),
    (["--fused-train", "--fused-mode", "exact"], "only train chain"),
])
def test_cli_refuses_what_is_not_ported(flags, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        train_reconstruction.main(["--device", "cpu", "--log-dir",
                                   str(tmp_path)] + flags)


@pytest.mark.parametrize("flag", ["--no-emd-kernel", "--emd-fast"])
def test_cli_refuses_the_xla_scan_emd(flag, tmp_path):
    """The JAX CLI's flags for its XLA-scan EMD: the port has no second
    EMD path, so they are refused, on either device."""
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="EMD kernel only"):
            train_reconstruction.main(["--device", device, "--loss", "emd",
                                       "--log-dir", str(tmp_path), flag])


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_reconstruction.main(["--device", "cuda", "--log-dir",
                                   str(tmp_path)])
