"""The port's PointNet classifiers, vanilla and T-net, and the classifier's
training, against the JAX package on the CPU, and the classifier CLI.

The same seeded numpy weights (a JAX-initialised variable tree, its T-net
transforms and BN parameters and statistics moved off their initial
values) go through the JAX module and, mapped by
`pointnet_state_dict_from_jax`, through the port's, on the same inputs:
B = 16 clouds of 64 points (8 of 128 for the eval forward), 5 classes,
the T-nets at their fixed widths.

Tolerances, as tests/test_torch_port_train_step.py: loss terms rtol
1e-5; logits rtol 1e-5 / atol 1e-6 at eval, the end points (after the
T-nets' products) rtol 1e-5 / atol 1e-5 of the tensor's largest entry,
and in train mode (batch statistics, the head's over 16 clouds) both
with an atol of 1e-4 of the tensor's largest entry: both packages' f32
train forwards land up to 3e-5 of scale from the float64 forward there;
gradients rtol 1e-3
with an atol of 1e-4 times the tensor's largest entry; running
statistics rtol 1e-4 / atol 1e-6; updated parameters atol 1e-6 wherever
JAX's gradient is resolved (above 1e-4 of its tensor's largest entry).
Parameters whose gradient is zero in exact arithmetic (every dense bias
followed by a BatchNorm, and each max-pooled chain's last BN beta, which
shifts every pooled feature of the batch alike before the next BN) are
held to be round-off (below 1e-5 of the model's largest gradient) on both
sides and their updates are not compared. Parity runs with dropout 0: no
generator gives both packages the same mask, so the mask is tested on its
own.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.data import augment as jax_augment
from samplenet_tpu.data.modelnet import load_h5 as jax_load_h5
from samplenet_tpu.data.modelnet import save_h5 as jax_save_h5
from samplenet_tpu.models import pointnet_cls as jm
from samplenet_tpu.train import classification as jc
from samplenet_tpu.train.state import TrainState as JaxTrainState
from samplenet_tpu_torch.data import augment
from samplenet_tpu_torch.data.modelnet import load_h5, save_h5
from samplenet_tpu_torch.interop import (
    infer_pointnet_config,
    pointnet_state_dict_from_jax,
)
from samplenet_tpu_torch.models import pointnet_cls as pm
from samplenet_tpu_torch.nn.layers import BatchNorm
from samplenet_tpu_torch.train import checkpoints
from samplenet_tpu_torch.train import classification as pc
from samplenet_tpu_torch.train import train_classifier

torch.set_num_threads(1)

B, N, CLASSES = 16, 64, 5
VARIANTS = {"vanilla": False, "tnet": True}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(tree):
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


def _perturb(variables, seed):
    """BN scale, bias and statistics, and the T-nets' transform, moved off
    their initial values (the transform off the identity)."""
    rs = np.random.RandomState(seed)

    def f(path, a):
        name = jax.tree_util.keystr(path)
        if "batch_stats" in name and "var" in name:
            return (np.abs(a + 0.3 * rs.randn(*a.shape)) + 0.5).astype(
                np.float32)
        if "transform" in name:      # kernel [256, k*k] -> T near I
            scale = 0.05 if "bias" in name else 0.002
            return (a + scale * rs.randn(*a.shape)).astype(np.float32)
        if "batch_stats" in name or "bn_" in name:
            return (a + 0.1 * rs.randn(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(f, _np(variables))


def _clouds(seed, b=B, n=N):
    return np.random.RandomState(seed).randn(b, n, 3).astype(np.float32)


def _labels(seed, b=B):
    return np.random.RandomState(seed).randint(0, CLASSES, b).astype(
        np.int32)


def _cancelled(names):
    """Parameters with a zero gradient in exact arithmetic."""
    out = set()
    for name in names:
        prefix, _, leaf = name.rpartition(".")
        last = prefix.rsplit(".", 1)[-1]
        if leaf == "bias" and (last.startswith("conv") or last in (
                "fc1", "fc2", "fc_0", "fc_1")):
            out.add(name)
    return out | {"bn5.bias", "convs_b.bn3.bias", "tnet_input.convs.bn3.bias",
                  "tnet_feature.convs.bn3.bias"}


def _models(use_tnets, seed=0):
    jax_model = jm.PointNetClassifier(num_classes=CLASSES,
                                      use_tnets=use_tnets)
    v = _perturb(jax_model.init(jax.random.PRNGKey(seed),
                                jnp.zeros((2, N, 3)), training=False), seed)
    port = pm.PointNetClassifier(CLASSES, use_tnets=use_tnets)
    port.load_state_dict(_sd(pointnet_state_dict_from_jax(v)))
    return jax_model, v, port


# ------------------------------------------------------------ the mapping

@pytest.mark.parametrize("variant", VARIANTS)
def test_mapping_covers_the_port_state_dict(variant):
    jax_model, v, port = _models(VARIANTS[variant])
    sd = pointnet_state_dict_from_jax(v)
    want = port.state_dict()
    assert sorted(sd) == sorted(want)
    for k, a in sd.items():
        assert tuple(np.shape(a)) == tuple(want[k].shape), k
    assert infer_pointnet_config(sd) == {"num_classes": CLASSES,
                                         "use_tnets": VARIANTS[variant]}
    n_params = sum(a.size for a in jax.tree.leaves(v["params"]))
    assert n_params == sum(p.numel() for p in port.parameters())


def test_mapping_refuses_another_tree():
    with pytest.raises(KeyError, match="PointNetClassifier"):
        pointnet_state_dict_from_jax({"params": {"encoder": {}}})
    with pytest.raises(KeyError, match="fc3"):
        infer_pointnet_config({"conv1.weight": np.zeros((64, 3, 1))})


def test_tnet_starts_at_the_identity_and_its_bns_at_momentum_0_9():
    port = pm.PointNetClassifier(CLASSES, use_tnets=True, bn_momentum=0.0)
    x = torch.from_numpy(_clouds(1))
    for tnet in (port.tnet_input, port.tnet_feature):
        with torch.no_grad():
            t = tnet(x if tnet.k == 3 else torch.randn(
                B, N, 64, generator=torch.Generator().manual_seed(0)))
        assert torch.equal(t, torch.eye(tnet.k).expand(B, -1, -1))
    moms = {name: m.momentum for name, m in port.named_modules()
            if isinstance(m, BatchNorm)}
    assert {v for k, v in moms.items() if k.startswith("tnet_")} == {0.9}
    assert {v for k, v in moms.items() if not k.startswith("tnet_")} == {0.0}


# ------------------------------------------------------------ the forward

@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(variant, training):
    jax_model, v, port = _models(VARIANTS[variant])
    n = N if training else 128
    x = _clouds(2, b=B if training else 8, n=n)
    if training:
        (logits, ends), upd = jax_model.clone(dropout_rate=0.0).apply(
            v, jnp.asarray(x), training=True, mutable=["batch_stats"])
        port.dropout_rate = 0.0
    else:
        logits, ends = jax_model.apply(v, jnp.asarray(x), training=False)
    with torch.no_grad():
        got, got_ends = port(torch.from_numpy(x), training=training)
    got_ends["logits"], ends["logits"] = got, logits
    assert sorted(got_ends) == sorted(ends)
    for k in ("logits", "GFV", "retrieval_vectors", "transform"):
        if k in ends:
            want = np.asarray(ends[k])
            # train mode: batch statistics of 16 clouds in the head
            scale = np.abs(want).max()
            atol = 1e-4 * scale if training else \
                1e-6 if k == "logits" else 1e-5 * scale
            np.testing.assert_allclose(got_ends[k].numpy(), want, rtol=1e-5,
                                       atol=atol, err_msg=k)
    np.testing.assert_array_equal(got_ends["critical_set_idx"].numpy(),
                                  np.asarray(ends["critical_set_idx"]))
    if training:
        new = pointnet_state_dict_from_jax(
            {"params": v["params"], "batch_stats": _np(upd["batch_stats"])})
        for k, t in port.state_dict().items():
            if "running_" in k:
                np.testing.assert_allclose(t.numpy(), new[k], rtol=1e-4,
                                           atol=1e-6, err_msg=k)


# ------------------------------------------------------------ the losses

@pytest.mark.parametrize("k", [3, 64])
def test_matrix_regularization_loss_matches_jax(k):
    t = np.random.RandomState(k).randn(B, k, k).astype(np.float32) * 0.3
    want = float(jm.matrix_regularization_loss(jnp.asarray(t)))
    got = float(pm.matrix_regularization_loss(torch.from_numpy(t)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # summed over the batch, not averaged: B clouds give B times one cloud
    one = float(pm.matrix_regularization_loss(
        torch.from_numpy(np.repeat(t[:1], B, 0))))
    np.testing.assert_allclose(one, B * float(pm.matrix_regularization_loss(
        torch.from_numpy(t[:1]))), rtol=1e-5)


@pytest.mark.parametrize("with_transform", [False, True])
def test_pointnet_loss_matches_jax(with_transform):
    rs = np.random.RandomState(5)
    logits = rs.randn(B, CLASSES).astype(np.float32)
    labels = _labels(6)
    ends = {"transform": rs.randn(B, 64, 64).astype(np.float32) * 0.1} \
        if with_transform else {}
    want = float(jm.pointnet_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        {k: jnp.asarray(a) for k, a in ends.items()}))
    got = float(pm.pointnet_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 {k: torch.from_numpy(a)
                                  for k, a in ends.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------------------ the dropout

def test_dropout_keeps_1_minus_rate_and_scales_the_kept():
    x = torch.full((1000, 200), 2.0)
    y = pm.dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0 / 0.7))


def test_dropout_same_generator_same_mask_and_edges():
    x = torch.randn(64, 256)
    a = pm.dropout(x, 0.3, torch.Generator().manual_seed(7))
    b = pm.dropout(x, 0.3, torch.Generator().manual_seed(7))
    c = pm.dropout(x, 0.3, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert pm.dropout(x, 0.0, None) is x
    assert not pm.dropout(x, 1.0, None).any()
    with pytest.raises(ValueError, match="Generator"):
        pm.dropout(x, 0.3, None)


@pytest.mark.parametrize("variant", VARIANTS)
def test_dropout_in_train_mode_only(variant):
    _, _, port = _models(VARIANTS[variant])
    x = torch.from_numpy(_clouds(3))
    with torch.no_grad():
        ev1, _ = port(x)
        ev2, _ = port(x, generator=torch.Generator().manual_seed(1))
        assert torch.equal(ev1, ev2)                 # off in eval
        tr = [port(x, training=True,
                   generator=torch.Generator().manual_seed(s))[0]
              for s in (1, 1, 2)]
        port.dropout_rate = 0.0
        nodrop, _ = port(x, training=True)
    assert torch.equal(tr[0], tr[1]) and not torch.equal(tr[0], tr[2])
    assert not torch.equal(tr[0], nodrop)


# ------------------------------------------------------------ train step

STEPS = [("vanilla", False), ("tnet", False), ("tnet", True)]


@pytest.fixture(scope="module", params=STEPS,
                ids=[f"{v}-{'bn_schedule' if s else 'ema'}" for v, s in STEPS])
def steps(request):
    variant, bn_schedule = request.param
    use_tnets = VARIANTS[variant]
    x, y = _clouds(10), _labels(11)
    kw = dict(num_classes=CLASSES, batch_size=B, use_tnets=use_tnets,
              bn_schedule=bn_schedule, augment=False)
    jcfg = jc.ClassifierConfig(**kw, num_points=N)
    jmodel, state = jc.create_classifier_state(jcfg, jax.random.PRNGKey(0))
    jmodel = jmodel.clone(dropout_rate=0.0)
    v0 = _perturb({"params": state.params,
                   "batch_stats": state.batch_stats}, 3)
    state = JaxTrainState.create(params=v0["params"],
                                 batch_stats=v0["batch_stats"], tx=state.tx)

    def loss_fn(params):               # classification.py:110-117
        (logits, ends), _ = jmodel.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jnp.asarray(x), training=True, mutable=["batch_stats"])
        return jm.pointnet_loss(logits, jnp.asarray(y), ends)

    jgrads = _np(jax.grad(loss_fn)(state.params))
    jstep = jc.make_classifier_train_step(jmodel, jcfg)
    jnew, jloss, jacc = jstep(state, jnp.asarray(x), jnp.asarray(y),
                              jax.random.PRNGKey(2))

    cfg = pc.ClassifierConfig(**kw)
    port, pstate = pc.create_classifier_state(cfg, device="cpu")
    port.load_state_dict(_sd(pointnet_state_dict_from_jax(v0)))
    port.dropout_rate = 0.0
    loss, acc = pc.make_classifier_train_step(port, cfg)(
        pstate, torch.from_numpy(x), torch.from_numpy(y).long())
    return dict(
        loss=loss, acc=acc, jloss=jloss, jacc=jacc, port=port,
        pstate=pstate,
        jgrads=pointnet_state_dict_from_jax(
            {"params": jgrads, "batch_stats": v0["batch_stats"]}),
        jnew=pointnet_state_dict_from_jax(
            {"params": _np(jnew.params),
             "batch_stats": _np(jnew.batch_stats)}))


def test_train_step_loss_matches_jax(steps):
    np.testing.assert_allclose(float(steps["loss"]), float(steps["jloss"]),
                               rtol=1e-5)
    assert float(steps["acc"]) == float(steps["jacc"])
    assert steps["pstate"].step == 1 and steps["pstate"].optimizer.count == 1


def test_train_step_gradients_match_jax(steps):
    jgrads = steps["jgrads"]
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    cancelled = _cancelled(jgrads)
    for name, p in steps["port"].named_parameters():
        got, want = p.grad.numpy(), jgrads[name]
        if name in cancelled:
            assert float(np.abs(got).max()) < 1e-5 * scale, name
            assert float(np.abs(want).max()) < 1e-5 * scale, name
            continue
        np.testing.assert_allclose(
            got, want, rtol=1e-3, atol=1e-4 * float(np.abs(want).max()),
            err_msg=name)


def test_train_step_new_stats_and_params_match_jax(steps):
    cancelled = _cancelled(steps["jgrads"])
    for name, v in steps["port"].state_dict().items():
        if name.endswith("num_batches_tracked") or name in cancelled:
            continue
        if "running_" in name:
            np.testing.assert_allclose(v.numpy(), steps["jnew"][name],
                                       rtol=1e-4, atol=1e-6, err_msg=name)
            continue
        g = np.abs(steps["jgrads"][name])
        resolved = g > 1e-4 * g.max()
        assert resolved.mean() > 0.8, name
        np.testing.assert_allclose(v.numpy()[resolved],
                                   steps["jnew"][name][resolved], atol=1e-6,
                                   err_msg=name)


def test_bn_schedule_averages_the_tnet_statistics_twice():
    """Under bn_schedule the classifier's BNs run at momentum 0 and the
    step averages every statistic with decay 0.5 (step 0): the T-nets'
    BNs, at momentum 0.9, have already averaged theirs once (the JAX
    package's TransformNets do not take bn_momentum)."""
    cfg = pc.ClassifierConfig(num_classes=CLASSES, batch_size=B,
                              use_tnets=True, bn_schedule=True, augment=False)
    port, pstate = pc.create_classifier_state(cfg, device="cpu", seed=1)
    _, v, _ = _models(True, seed=5)
    port.load_state_dict(_sd(pointnet_state_dict_from_jax(v)))
    port.dropout_rate = 0.0
    x = torch.from_numpy(_clouds(14))
    probe = copy.deepcopy(port)
    for m in probe.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 0.0
    with torch.no_grad():
        probe(x, training=True)
    old = copy.deepcopy(port.state_dict())
    batch = probe.state_dict()
    pc.make_classifier_train_step(port, cfg)(
        pstate, x, torch.from_numpy(_labels(15)).long())
    new = port.state_dict()
    n_tnet = 0
    for k in new:
        if "running_" not in k:
            continue
        if k.startswith("tnet_"):
            n_tnet += 1
            want = 0.5 * old[k] + 0.5 * (0.9 * old[k] + 0.1 * batch[k])
        else:
            want = 0.5 * old[k] + 0.5 * batch[k]
        torch.testing.assert_close(new[k], want, rtol=1e-5, atol=1e-7,
                                   msg=k)
    assert n_tnet == 2 * 2 * 5


def test_evaluate_classifier_matches_jax():
    jax_model, v, port = _models(True, seed=4)
    data, labels = _clouds(12, b=11), _labels(13, b=11)
    state = JaxTrainState.create(params=v["params"],
                                 batch_stats=v["batch_stats"],
                                 tx=jc.adam_with_schedule(lambda c: 1e-3))
    want = jc.evaluate_classifier(jc.make_classifier_eval_step(jax_model),
                                  state, (data, labels), 4)
    step = pc.make_classifier_eval_step(port)
    got = [pc.evaluate_classifier(step, None, (data, labels), bs,
                                  device="cpu") for bs in (4, 3, 11)]
    assert got == [want] * 3


@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_state_matches_jax(variant):
    """ClassifierConfig(bf16=True) gives, as the JAX package's does, a
    model that computes in bf16 while its parameters and statistics stay
    f32, with the JAX tree's entries and shapes (the bf16 forward and
    step against flax: tests/test_torch_port_bf16_compute.py)."""
    kw = dict(num_classes=CLASSES, use_tnets=VARIANTS[variant], bf16=True)
    jmodel, jstate = jc.create_classifier_state(
        jc.ClassifierConfig(**kw, num_points=N), jax.random.PRNGKey(0))
    port, pstate = pc.create_classifier_state(pc.ClassifierConfig(**kw),
                                              device="cpu")
    assert jmodel.dtype == jnp.bfloat16 and port.dtype == torch.bfloat16
    want = pointnet_state_dict_from_jax(
        {"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)})
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert tuple(t.shape) == tuple(np.shape(want[k])), k
        if not k.endswith("num_batches_tracked"):
            assert t.dtype == torch.float32, k
            assert np.asarray(want[k]).dtype == np.float32, k
    assert pstate.step == 0


# ------------------------------------------------------------ data helpers

@pytest.mark.parametrize("angle", [0.0, 0.5, 2 * np.pi * 7 / 12])
def test_rotate_point_cloud_by_angle_matches_jax(angle):
    x = _clouds(20, b=3)
    np.testing.assert_array_equal(
        augment.rotate_point_cloud_by_angle(x, angle),
        jax_augment.rotate_point_cloud_by_angle(x, angle))


def test_h5_round_trip_against_jax(tmp_path):
    pytest.importorskip("h5py")
    data, labels = _clouds(21, b=5), _labels(22, b=5)
    save_h5(str(tmp_path / "port.h5"), data, labels)
    jax_save_h5(str(tmp_path / "jax.h5"), data, labels)
    for path in ("port.h5", "jax.h5"):
        for load in (load_h5, jax_load_h5):
            d, lab = load(str(tmp_path / path))
            np.testing.assert_array_equal(d, data)
            np.testing.assert_array_equal(lab, labels)


# ------------------------------------------------------------ the CLI

CLI = ["--device", "cpu", "--num-points", "128", "--train-size", "16",
       "--test-size", "6", "--batch-size", "4", "--epochs", "2",
       "--steps-per-epoch", "2"]


@pytest.mark.parametrize("flags", [["--use-tnets", "--bn-schedule"], []],
                         ids=["tnet-bn_schedule", "vanilla"])
def test_cli_writes_best_and_last(flags, tmp_path, capsys):
    log = tmp_path / "cls"
    state = train_classifier.main(CLI + flags + ["--log-dir", str(log)])
    assert state.step == 4
    out = capsys.readouterr().out
    assert "epoch 1:" in out and "test_acc=" in out
    best, last = (checkpoints.load_published(str(log / d), "classifier.pth")
                  for d in ("ckpt", "ckpt_last"))
    use_tnets = bool(flags)
    assert best[1]["use_tnets"] is use_tnets and best[1]["num_classes"] == 24
    assert {"best_epoch", "best_test_acc"} <= set(best[1])
    assert last[1] == {"num_classes": 24, "use_tnets": use_tnets}
    for k, t in state.model.state_dict().items():
        assert torch.equal(last[0][k], t), k
    model = checkpoints.load_classifier(str(log / "ckpt"), "cpu")
    assert model.use_tnets is use_tnets


@pytest.mark.parametrize("flag,match", [("--data-parallel", "item 9")])
def test_cli_refuses_what_is_not_ported(flag, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        train_classifier.main(CLI + [flag, "--log-dir", str(tmp_path)])


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_classifier.main(["--device", "cuda", "--log-dir",
                               str(tmp_path)])
