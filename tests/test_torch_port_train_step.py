"""The port's classification-track train step, the slice as a whole,
against the JAX package on the CPU, and its CLI.

One step of the port's plain path against JAX's
`make_samplenet_train_step(..., augment_data=False)` on CPU, set up as
test_samplenet.py:342-367 (a JAX-initialised sampler and classifier, the
sampler's variables carried into the port by
`samplenet_state_dict_from_jax`): the loss terms, every gradient, the
new BN running statistics and the updated parameters.

Tolerances. Loss terms rtol 1e-5. Gradients rtol 1e-3 with an atol of
1e-4 times the tensor's largest entry: at random initialisation the
conv chain's gradients are ill-conditioned (at B=8, N=64 a 1e-7
relative change of the input moves JAX's own gradients past rtol 1e-3),
so an absolute floor tied to each tensor's scale is the f32 round-off
both sides can hold (here they agree to 4e-5 of it). Running statistics rtol 1e-4 /
atol 1e-6 (the fast variance E[x^2] - E[x]^2 over 16 samples loses a
few digits to cancellation). Updated parameters atol 1e-6 wherever
JAX's gradient is resolved (above 1e-4 of its tensor's largest entry):
Adam's first step is lr * g / (|g| + 1e-8), +-lr once the signs agree,
and an element whose gradient is itself round-off may take either
sign.

Not compared: the updated values of the parameters whose gradient is
zero in exact arithmetic (every dense bias followed by a BatchNorm, and
the last conv BN's beta, which shifts all pooled features equally before
the FC head's BN). JAX's XLA chain gives them round-off gradients that
Adam's first step blows up to about +-lr; the port's conv biases get
exact zeros, as the TPU kernel's do. Their gradients are held to be
round-off (below 1e-5 of the model's largest gradient) on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.models.pointnet_cls import (
    PointNetClassifier as JaxPointNetClassifier,
)
from samplenet_tpu.models.pointnet_cls import (
    classification_loss as jax_classification_loss,
)
from samplenet_tpu.models.samplenet import SampleNet as JaxSampleNet
from samplenet_tpu.train.classification import (
    SampleNetConfig as JaxSampleNetConfig,
)
from samplenet_tpu.train.classification import (
    create_samplenet_state as jax_create_samplenet_state,
)
from samplenet_tpu.train.classification import (
    make_samplenet_train_step as jax_make_samplenet_train_step,
)
from samplenet_tpu_torch.interop import (
    pointnet_state_dict_from_jax,
    samplenet_state_dict_from_jax,
)
from samplenet_tpu_torch.models import PointNetClassifier
from samplenet_tpu_torch.train import train_samplenet
from samplenet_tpu_torch.train.classification import (
    SampleNetConfig,
    create_samplenet_state,
    make_samplenet_train_step,
)

torch.set_num_threads(1)

B, N = 16, 64
KW = dict(num_out_points=8, bottleneck_size=32, group_size=4, batch_size=B)
# zero gradient in exact arithmetic (see the module docstring)
CANCELLED = {f"conv{i}.bias" for i in range(1, 6)} | {
    "bn5.bias", "fc1.bias", "fc2.bias", "fc3.bias"}


def _sd(tree):
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module", params=[False, True],
                ids=["ema", "bn_schedule"])
def steps(request):
    bn_schedule = request.param
    rng = np.random.RandomState(0)
    x = rng.randn(B, N, 3).astype(np.float32)
    y = rng.randint(0, 4, B).astype(np.int32)
    cls = JaxPointNetClassifier(num_classes=4)
    cv = cls.init(jax.random.PRNGKey(1), jnp.asarray(x[:, :8]),
                  training=False)
    jcfg = JaxSampleNetConfig(**KW, bn_schedule=bn_schedule)
    sampler, state = jax_create_samplenet_state(jcfg, N,
                                                jax.random.PRNGKey(0))
    v0 = {"params": jax.tree.map(np.asarray, state.params),
          "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}

    def loss_fn(params):          # classification.py:199-218
        variables = {"params": params, "batch_stats": state.batch_stats}
        (simp, proj), _ = sampler.apply(variables, jnp.asarray(x),
                                        training=True,
                                        mutable=["batch_stats"])
        logits, _ = cls.apply(cv, proj, training=False)
        return (jax_classification_loss(logits, jnp.asarray(y))
                + 30.0 * sampler.apply(
                    variables, jnp.asarray(x), simp, 8, 1.0, 0.0,
                    method=JaxSampleNet.get_simplification_loss)
                + sampler.apply(variables,
                                method=JaxSampleNet.get_projection_loss))

    jgrads = jax.grad(loss_fn)(state.params)
    jstep = jax_make_samplenet_train_step(sampler, cls, cv, jcfg,
                                          augment_data=False)
    jnew, jm = jstep(state, jnp.asarray(x), jnp.asarray(y),
                     jax.random.PRNGKey(2))

    cfg = SampleNetConfig(**KW, bn_schedule=bn_schedule)
    port, pstate = create_samplenet_state(cfg, device="cpu")
    port.load_state_dict(_sd(samplenet_state_dict_from_jax(v0)))
    classifier = PointNetClassifier(4)
    classifier.load_state_dict(_sd(pointnet_state_dict_from_jax(
        jax.tree.map(np.asarray, cv))))
    pstep = make_samplenet_train_step(port, classifier, cfg,
                                      augment_data=False)
    pm = pstep(pstate, torch.from_numpy(x), torch.from_numpy(y).long())
    jgsd = samplenet_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jgrads),
         "batch_stats": v0["batch_stats"]})
    jnewsd = samplenet_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jnew.params),
         "batch_stats": jax.tree.map(np.asarray, jnew.batch_stats)})
    return dict(jm=jm, pm=pm, jgrads=jgsd, jnew=jnewsd, port=port,
                pstate=pstate, classifier=classifier)


def test_loss_terms_match_jax(steps):
    for k in ("loss", "task", "simplification", "projection", "acc"):
        np.testing.assert_allclose(float(steps["pm"][k]),
                                   float(steps["jm"][k]), rtol=1e-5,
                                   err_msg=k)
    assert steps["pstate"].step == 1 and steps["pstate"].optimizer.count == 1


def test_gradients_match_jax(steps):
    scale = max(float(np.abs(g).max()) for g in steps["jgrads"].values())
    for name, p in steps["port"].named_parameters():
        got, want = p.grad.numpy(), steps["jgrads"][name]
        if name in CANCELLED:
            assert float(np.abs(got).max()) < 1e-5 * scale, name
            assert float(np.abs(want).max()) < 1e-5 * scale, name
            if name.startswith("conv"):
                assert not got.any(), name    # the exact kernel's zeros
            continue
        np.testing.assert_allclose(
            got, want, rtol=1e-3, atol=1e-4 * float(np.abs(want).max()),
            err_msg=name)
    # the classifier is frozen, and still passes the gradient through
    assert all(p.grad is None for p in steps["classifier"].parameters())


def test_new_batch_stats_and_params_match_jax(steps):
    for name, v in steps["port"].state_dict().items():
        if name.endswith("num_batches_tracked") or name in CANCELLED:
            continue
        if "running_" in name:
            np.testing.assert_allclose(v.numpy(), steps["jnew"][name],
                                       rtol=1e-4, atol=1e-6, err_msg=name)
            continue
        g = np.abs(steps["jgrads"][name])
        resolved = g > 1e-4 * g.max()
        assert resolved.mean() > 0.9, name
        np.testing.assert_allclose(v.numpy()[resolved],
                                   steps["jnew"][name][resolved], atol=1e-6,
                                   err_msg=name)


def test_train_forward_returns_simplified_and_projected():
    net, _ = create_samplenet_state(SampleNetConfig(**KW), device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).randn(2, N, 3)
                         .astype(np.float32))
    simp, proj = net(x, training=True)
    assert simp.shape == proj.shape == (2, 8, 3)
    assert not torch.equal(simp, proj)
    net.skip_projection = True
    simp2, same = net(x, training=True)
    assert same is simp2
    assert float(net.get_projection_loss()) == 0.0


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    cls_path = tmp_path / "classifier.pth"
    torch.save(PointNetClassifier(24).state_dict(), cls_path)
    argv = ["--device", "cpu", "--epochs", "1", "--steps-per-epoch", "2",
            "--batch-size", "4", "--num-points", "128", "--train-size", "16",
            "--test-size", "6", "--num-out-points", "8",
            "--classifier-weights", str(cls_path),
            "--log-dir", str(tmp_path / "log")]
    state = train_samplenet.main(argv)
    assert state.step == 2
    log = tmp_path / "log"
    assert (log / "snap_last" / "state.pt").exists()
    assert (log / "ckpt" / "sampler.pth").exists()
    sd = torch.load(log / "ckpt" / "sampler.pth", weights_only=True)
    assert sd["fc4.weight"].shape == (24, 256)
    out = capsys.readouterr().out
    assert "eval_acc@8=" in out
    argv[argv.index("--epochs") + 1] = "2"
    state = train_samplenet.main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "at epoch 1" in out
    assert "epoch 0:" not in out and "epoch 1:" in out
    last = torch.load(log / "snap_last" / "state.pt", weights_only=True)
    assert last["step"] == 4 and last["optimizer"]["count"] == 4


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_samplenet.main(["--device", "cuda", "--classifier-weights",
                              str(tmp_path / "none.pth")])
