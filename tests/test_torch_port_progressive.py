"""The port's progressive track, the slice as a whole, against the JAX
package on the CPU: the progressive classification train step (the exact
chain, and the ghost chain of `--fused-train` in f32), the ordered infer
step, `evaluate_prefixes`, the progressive AE step and
`evaluate_ae_prefix_nre`, and the CLIs.

Set-up as tests/test_torch_port_train_step.py and
test_torch_port_recon_train.py: JAX-initialised models carried into the
port with the interop mappings, inputs from numpy seeds, B = 16 (at
random initialisation a smaller batch leaves the conv chain's gradient
ill-conditioned, ROADMAP Queue 3). JAX's ghost chain runs its Pallas
kernel in interpret mode, which computes in f32, so the port's ghost
chain is held in f32 (`fused_bf16=False`).

Tolerances: loss terms rtol 1e-5 (2e-5 summed over three prefixes);
gradients rtol 1e-3 with an atol of 1e-4 times the tensor's largest entry;
running statistics rtol 1e-4 / atol 1e-6; updated parameters atol 1e-6
where JAX's gradient is resolved, leaving out the parameters whose
gradient is zero in exact arithmetic (their gradients are held to be
round-off on both sides); the simplified and soft-projected clouds rtol
1e-4 / atol 1e-5; hard-projected and matched points exactly, on clouds
without a near-tie (1e-4 relative); accuracies exactly and NRE rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.models.autoencoder import (
    ae_chamfer_loss as jax_ae_chamfer_loss,
)
from samplenet_tpu.models.losses import (
    reconstruction_simplification_loss as jax_recon_simp_loss,
)
from samplenet_tpu.models.losses import (
    simplification_loss as jax_simplification_loss,
)
from samplenet_tpu.models.pointnet_cls import (
    PointNetClassifier as JaxPointNetClassifier,
)
from samplenet_tpu.models.pointnet_cls import (
    classification_loss as jax_classification_loss,
)
from samplenet_tpu.models.samplenet import SampleNet as JaxSampleNet
from samplenet_tpu.ops.matching import nn_match_from_clouds as jax_match
from samplenet_tpu.train import progressive as jp
from samplenet_tpu.train import reconstruction as jr
from samplenet_tpu.train.state import clone_state
from samplenet_tpu_torch.interop import (
    autoencoder_state_dict_from_jax,
    pointnet_state_dict_from_jax,
    samplenet_state_dict_from_jax,
)
from samplenet_tpu_torch.models import PointNetClassifier
from samplenet_tpu_torch.models.autoencoder import PointNetAE
from samplenet_tpu_torch.nn import layers
from samplenet_tpu_torch.ops.cuda.chamfer_kernel import nn_direction_plain
from samplenet_tpu_torch.train import progressive as pp
from samplenet_tpu_torch.train import reconstruction as pr
from samplenet_tpu_torch.train import (
    train_progressive,
    train_reconstruction,
    train_samplenet,
)
from tests.test_torch_port_recon_train import (
    _assert_grads,
    _assert_updated,
    _perturb,
)
from tests.test_torch_port_samplenet import _near_tie

torch.set_num_threads(1)

B = 16
KW = dict(max_num_out_points=32, min_num_out_points=8, bottleneck_size=32,
          group_size=4, batch_size=B)
# zero gradient in exact arithmetic (tests/test_torch_port_train_step.py)
CANCELLED = {f"conv{i}.bias" for i in range(1, 6)} | {
    "bn5.bias", "fc1.bias", "fc2.bias", "fc3.bias"}
SN_CANCELLED = {f"conv{i}.bias" for i in range(1, 6)}


def _sd(tree):
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _clouds(seed, b=B, n=64):
    return np.random.RandomState(seed).randn(b, n, 3).astype(np.float32)


def test_progressive_sizes_and_config():
    assert pp.progressive_sizes(8, 64) == (8, 16, 32, 64)
    assert pp.progressive_sizes(2, 2) == (2,)
    assert pp.ProgressiveConfig().sizes == jp.ProgressiveConfig().sizes
    assert pp.ProgressiveAEConfig().sizes == jp.ProgressiveAEConfig().sizes
    assert pp.ProgressiveConfig().sizes == (8, 16, 32, 64, 128, 256, 512,
                                            1024)


# --------------------------------------------------- classification step

def _cls_setup(n, **fused):
    rng = np.random.RandomState(0)
    x = rng.randn(B, n, 3).astype(np.float32)
    y = rng.randint(0, 4, B).astype(np.int32)
    cls = JaxPointNetClassifier(num_classes=4)
    cv = cls.init(jax.random.PRNGKey(1), jnp.asarray(x[:, :8]),
                  training=False)
    jcfg = jp.ProgressiveConfig(**KW, **fused)
    sampler, state = jp.create_progressive_state(jcfg, n,
                                                 jax.random.PRNGKey(0))
    v0 = {"params": _np(state.params), "batch_stats": _np(state.batch_stats)}
    classifier = PointNetClassifier(4)
    classifier.load_state_dict(_sd(pointnet_state_dict_from_jax(_np(cv))))
    cfg = pp.ProgressiveConfig(**KW, **fused)
    port, pstate = pp.create_progressive_state(cfg, device="cpu")
    port.load_state_dict(_sd(samplenet_state_dict_from_jax(v0)))
    return dict(x=x, y=y, cls=cls, cv=cv, jcfg=jcfg, sampler=sampler,
                state=state, v0=v0, classifier=classifier, cfg=cfg,
                port=port, pstate=pstate)


@pytest.fixture(scope="module", params=["exact", "ghost"])
def cls_steps(request):
    if request.param == "ghost":
        # N % 128 == 0, and auto_block_b(16, 256, .., f32) = 8: two blocks
        s = _cls_setup(256, fused_train=True, fused_bf16=False)
    else:
        s = _cls_setup(64)
    x, y, cls, cv, jcfg, sampler, state = (s[k] for k in (
        "x", "y", "cls", "cv", "jcfg", "sampler", "state"))

    def loss_fn(params):          # progressive.py:104-121
        variables = {"params": params, "batch_stats": state.batch_stats}
        (simp, proj), _ = sampler.apply(variables, jnp.asarray(x),
                                        training=True,
                                        mutable=["batch_stats"])
        total = 0.0
        for size in jcfg.sizes:
            logits, _ = cls.apply(cv, proj[:, :size], training=False)
            total = total + jax_classification_loss(logits, jnp.asarray(y)) \
                + jcfg.alpha * jax_simplification_loss(
                    jnp.asarray(x), simp[:, :size], size, jcfg.gamma,
                    jcfg.delta)
        return total + jcfg.lmbda * sampler.apply(
            variables, method=JaxSampleNet.get_projection_loss)

    jgrads = jax.jit(jax.grad(loss_fn))(state.params)
    jstep = jp.make_progressive_train_step(sampler, cls, cv, jcfg)
    jnew, jm = jstep(clone_state(state), jnp.asarray(x), jnp.asarray(y))
    calls = []
    real = layers.point_mlp_train_max
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "point_mlp_train_max",
                   lambda *a, **k: calls.append(k) or real(*a, **k))
        pm = pp.make_progressive_train_step(s["port"], s["classifier"],
                                            s["cfg"])(
            s["pstate"], torch.from_numpy(x), torch.from_numpy(y).long())
    s.update(kind=request.param, jm=jm, pm=pm, calls=calls,
             jgrads=samplenet_state_dict_from_jax(
                 {"params": _np(jgrads), "batch_stats": s["v0"]["batch_stats"]}),
             jnew=samplenet_state_dict_from_jax(
                 {"params": _np(jnew.params),
                  "batch_stats": _np(jnew.batch_stats)}))
    return s


def test_train_step_metrics_match_jax(cls_steps):
    s = cls_steps
    assert set(s["pm"]) == set(s["jm"])
    for k in s["jm"]:
        np.testing.assert_allclose(float(s["pm"][k]), float(s["jm"][k]),
                                   rtol=2e-5, err_msg=k)
    assert s["pstate"].step == 1 and s["pstate"].optimizer.count == 1
    # the ghost chain ran where it was asked for, in f32
    assert s["calls"] == ([{"eps": 1e-5, "bf16": False}]
                          if s["kind"] == "ghost" else [])


def test_train_step_gradients_match_jax(cls_steps):
    s = cls_steps
    scale = max(float(np.abs(g).max()) for g in s["jgrads"].values())
    for name, p in s["port"].named_parameters():
        got, want = p.grad.numpy(), s["jgrads"][name]
        if name in CANCELLED:
            assert float(np.abs(got).max()) < 1e-5 * scale, name
            assert float(np.abs(want).max()) < 1e-5 * scale, name
            if name.startswith("conv"):
                assert not got.any(), name
            continue
        np.testing.assert_allclose(
            got, want, rtol=1e-3, atol=1e-4 * float(np.abs(want).max()),
            err_msg=name)
    assert all(p.grad is None for p in s["classifier"].parameters())


def test_train_step_new_stats_and_params_match_jax(cls_steps):
    s = cls_steps
    for name, v in s["port"].state_dict().items():
        if name.endswith("num_batches_tracked") or name in CANCELLED:
            continue
        if "running_" in name:
            np.testing.assert_allclose(v.numpy(), s["jnew"][name],
                                       rtol=1e-4, atol=1e-6, err_msg=name)
            continue
        g = np.abs(s["jgrads"][name])
        resolved = g > 1e-4 * g.max()
        np.testing.assert_allclose(v.numpy()[resolved],
                                   s["jnew"][name][resolved], atol=1e-6,
                                   err_msg=name)


# ----------------------------------------------------- infer and prefixes

@pytest.fixture(scope="module")
def infer_setup():
    s = _cls_setup(64)
    s["jstate"] = s["state"]
    return s


def test_infer_step_ordered_outputs_match_jax(infer_setup):
    s = infer_setup
    x = _clouds(3)
    jout = [np.asarray(a) for a in jp.make_progressive_infer_step(
        s["sampler"], 32)(s["jstate"], jnp.asarray(x))]
    out = [t.numpy() for t in pp.make_progressive_infer_step(s["port"], 32)(
        s["pstate"], torch.from_numpy(x))]
    assert all(o.shape == (B, 32, 3) for o in out)
    for a, c in zip(out[:2], jout[:2]):            # simplified, soft
        np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-5)
    simp, _, hard, matched = out
    # hard: each simplified point snapped to its nearest input point
    _, idx = nn_direction_plain(torch.from_numpy(simp), torch.from_numpy(x))
    nn_pts = np.take_along_axis(x, idx.numpy()[..., None].astype(np.int64), 1)
    np.testing.assert_array_equal(hard, nn_pts)
    _, midx = jax_match(jnp.asarray(x), jnp.asarray(simp), 32)
    clear = ~_near_tie(x, simp, np.asarray(midx), 32)
    assert clear.sum() >= 4
    np.testing.assert_array_equal(hard[clear], jout[2][clear])
    np.testing.assert_array_equal(matched[clear], jout[3][clear])
    for b in range(B):                             # unique per cloud
        assert len(np.unique(matched[b], axis=0)) == 32


def test_evaluate_prefixes_matches_jax(infer_setup):
    s = infer_setup
    data = _clouds(4, b=10)
    labels = np.random.RandomState(4).randint(0, 4, 10).astype(np.int32)
    want = jp.evaluate_prefixes(
        jp.make_progressive_infer_step(s["sampler"], 32), s["jstate"],
        s["cls"], s["cv"], data, labels, s["cfg"].sizes, 4)
    got = pp.evaluate_prefixes(
        pp.make_progressive_infer_step(s["port"], 32), s["pstate"],
        s["classifier"], data, labels, s["cfg"].sizes, 4, device="cpu")
    assert got == want


# ---------------------------------------------------------------- AE track

@pytest.fixture(scope="module")
def ae_setup():
    n, bneck = 64, 32
    acfg = jr.AEConfig(num_points=n, bottleneck_size=bneck, batch_size=B,
                       n_sample_points=n)
    jae, astate = jr.create_ae_state(acfg, jax.random.PRNGKey(0))
    ae_vars = _perturb({"params": _np(astate.params),
                        "batch_stats": _np(astate.batch_stats)}, 3)
    ae = PointNetAE(n, bneck)
    ae.load_state_dict(_sd(autoencoder_state_dict_from_jax(ae_vars)))
    jcfg = jr.SampleNetAEConfig(num_out_points=32, group_size=4,
                                batch_size=B, bottleneck_size=bneck)
    jsampler, jstate = jr.create_sampler_ae_state(jcfg, n,
                                                  jax.random.PRNGKey(1))
    sv0 = {"params": _np(jstate.params),
           "batch_stats": _np(jstate.batch_stats)}
    cfg = pr.SampleNetAEConfig(num_out_points=32, group_size=4,
                               batch_size=B, bottleneck_size=bneck)
    sampler, state = pr.create_sampler_ae_state(cfg, device="cpu")
    sampler.load_state_dict(_sd(samplenet_state_dict_from_jax(sv0)))
    kw = dict(max_num_out_points=32, min_num_out_points=8, group_size=4,
              batch_size=B)
    return dict(jae=jae, ae_vars=ae_vars, ae=ae, jsampler=jsampler,
                jstate=jstate, sv0=sv0, sampler=sampler, state=state,
                jpcfg=jp.ProgressiveAEConfig(**kw),
                pcfg=pp.ProgressiveAEConfig(**kw))


def test_ae_train_step_matches_jax(ae_setup):
    s = ae_setup
    x = _clouds(5)
    jsampler, jae, ae_vars, jpcfg = (s[k] for k in (
        "jsampler", "jae", "ae_vars", "jpcfg"))

    def loss_fn(params):          # progressive.py:252-267
        variables = {"params": params, "batch_stats": s["sv0"]["batch_stats"]}
        (q, sp), _ = jsampler.apply(variables, jnp.asarray(x), training=True,
                                    mutable=["batch_stats"])
        loss_ae = loss_simp = 0.0
        for size in jpcfg.sizes:
            loss_ae = loss_ae + jax_ae_chamfer_loss(
                jae.apply(ae_vars, sp[:, :size]), jnp.asarray(x))
            loss_simp = loss_simp + jax_recon_simp_loss(
                jnp.asarray(x), q[:, :size], size)
        n = len(jpcfg.sizes)
        return loss_ae / n + jpcfg.alpha * loss_simp / n + jpcfg.lmbda * \
            jsampler.apply(variables, method=JaxSampleNet.get_projection_loss)

    params = jax.tree.map(jnp.asarray, s["sv0"]["params"])
    jgrads = samplenet_state_dict_from_jax(
        {"params": _np(jax.jit(jax.grad(loss_fn))(params)),
         "batch_stats": s["sv0"]["batch_stats"]})
    jstate = s["jstate"].replace(
        params=params, batch_stats=jax.tree.map(jnp.asarray,
                                                s["sv0"]["batch_stats"]))
    jnew, jm = jp.make_progressive_ae_train_step(jsampler, jae, ae_vars,
                                                 jpcfg)(jstate, jnp.asarray(x))
    jnewsd = samplenet_state_dict_from_jax(
        {"params": _np(jnew.params), "batch_stats": _np(jnew.batch_stats)})
    sampler, state = pr.create_sampler_ae_state(
        pr.SampleNetAEConfig(num_out_points=32, group_size=4, batch_size=B,
                             bottleneck_size=32), device="cpu")
    sampler.load_state_dict(_sd(samplenet_state_dict_from_jax(s["sv0"])))
    pm = pp.make_progressive_ae_train_step(sampler, s["ae"], s["pcfg"])(
        state, torch.from_numpy(x))
    for k in ("loss", "ae", "simplification", "projection"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    _assert_grads(sampler, jgrads, SN_CANCELLED)
    _assert_updated(sampler, jnewsd, jgrads, SN_CANCELLED)
    assert all(p.grad is None and not p.requires_grad
               for p in s["ae"].parameters())


def test_evaluate_ae_prefix_nre_matches_jax(ae_setup):
    s = ae_setup
    data = _clouds(6, b=6)
    jstate = s["jstate"].replace(params=jax.tree.map(jnp.asarray,
                                                     s["sv0"]["params"]))
    want = jp.evaluate_ae_prefix_nre(s["jsampler"], jstate, s["jae"],
                                     s["ae_vars"], data, s["pcfg"].sizes, 4)
    got = pp.evaluate_ae_prefix_nre(s["sampler"], s["state"], s["ae"], data,
                                    s["pcfg"].sizes, 4, device="cpu")
    assert set(got) == set(want) == set(s["pcfg"].sizes)
    for size in want:
        for k in ("loss_sampled", "loss_full", "nre"):
            np.testing.assert_allclose(got[size][k], want[size][k],
                                       rtol=1e-5, err_msg=f"{size} {k}")


# -------------------------------------------------------------------- CLIs

@pytest.fixture
def ghost_calls(monkeypatch):
    calls = []
    real = layers.point_mlp_train_max
    monkeypatch.setattr(layers, "point_mlp_train_max",
                        lambda *a, **k: calls.append(k["bf16"]) or
                        real(*a, **k))
    return calls


@pytest.mark.parametrize("flags,ghost", [
    ([], []),
    (["--fused-train"], [True, True]),
    (["--fused-train", "--fused-f32"], [False, False]),
])
def test_train_progressive_cli(flags, ghost, tmp_path, capsys, ghost_calls):
    cls_path = tmp_path / "classifier.pth"
    torch.save(PointNetClassifier(24).state_dict(), cls_path)
    state = train_progressive.main([
        "--device", "cpu", "--epochs", "1", "--steps-per-epoch", "2",
        "--batch-size", "4", "--num-points", "128", "--train-size", "8",
        "--test-size", "6", "--max-num-out-points", "16",
        "--classifier-weights", str(cls_path),
        "--log-dir", str(tmp_path / "log")] + flags)
    assert state.step == 2
    out = capsys.readouterr().out
    assert "progressive sizes (8, 16)" in out
    assert "final eval_acc@8=" in out and "final eval_acc@16=" in out
    sd = torch.load(tmp_path / "log" / "ckpt" / "sampler.pth",
                    weights_only=True)
    assert sd["fc4.weight"].shape == (48, 256)
    assert ghost_calls == ghost


def test_train_reconstruction_progressive_cli(tmp_path, capsys, ghost_calls):
    common = ["--device", "cpu", "--num-points", "128", "--batch-size", "4",
              "--train-size", "8", "--test-size", "4", "--epochs", "1",
              "--steps-per-epoch", "2"]
    ae_dir = tmp_path / "ae"
    train_reconstruction.main(common + ["--phase", "ae", "--log-dir",
                                        str(ae_dir)])
    sn_dir = tmp_path / "sn"
    state = train_reconstruction.main(common + [
        "--phase", "samplenet", "--ae-ckpt", str(ae_dir / "ckpt"),
        "--num-out-points", "32", "--group-size", "4", "--progressive",
        "--fused-train", "--log-dir", str(sn_dir)])
    assert state.step == 2
    out = capsys.readouterr().out
    assert "progressive AE sizes (16, 32)" in out
    assert "prefix 16: NRE=" in out and "prefix 32: NRE=" in out
    import json
    curve = json.loads((sn_dir / "prefix_nre.json").read_text())
    assert set(curve) == {"16", "32"}
    assert all(np.isfinite(v["nre"]) for v in curve.values())
    assert ghost_calls == [True, True]        # the sampler's two steps


def test_train_samplenet_cli_fused_train(tmp_path, ghost_calls):
    cls_path = tmp_path / "classifier.pth"
    torch.save(PointNetClassifier(24).state_dict(), cls_path)
    state = train_samplenet.main([
        "--device", "cpu", "--epochs", "1", "--steps-per-epoch", "2",
        "--batch-size", "4", "--num-points", "128", "--train-size", "8",
        "--test-size", "4", "--num-out-points", "8", "--fused-train",
        "--classifier-weights", str(cls_path),
        "--log-dir", str(tmp_path / "log")])
    assert state.step == 2
    assert ghost_calls == [True, True]


def test_clis_refuse_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_progressive.main(["--device", "cuda", "--classifier-weights",
                                str(tmp_path / "none.pth")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_reconstruction.main(["--device", "cuda", "--phase",
                                   "samplenet", "--progressive",
                                   "--log-dir", str(tmp_path)])
