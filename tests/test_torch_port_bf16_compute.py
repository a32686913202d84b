"""The port's compute dtype (`dtype=torch.bfloat16`, the JAX package's
`dtype=jnp.bfloat16`, reached by `--bf16`) against flax on the CPU.

The same seeded weights (a JAX-initialised variable tree with its BN
parameters and statistics, and the T-nets' transforms, moved off their
initial values) go through the flax module at dtype=bf16 and, mapped by
the interop functions, through the port's at dtype=bf16: SampleNet (the
classification track's sampler, bottleneck 32, 8 points out, k=4) and the
PointNet classifier, vanilla and T-net, at B = 4 clouds of 16 points. The
layers' own casts are checked alone first: Dense and BatchNorm (train
and eval) on the same bf16 inputs.

Tolerances, measured here. In bf16 two implementations that sum in other
orders part where an f32 sum lands on the other side of a bf16 rounding
midpoint: one entry then moves by a bf16 ulp (2^-8 relative), and
batch-statistics BN spreads it through the batch. Layer by layer that is
one entry in 10^4 to 10^5 (measured on SampleNet's conv chain at B=16,
N=64); through a whole network at B=16, N=64 it grows to 1e-2 of the
logits' scale, as far as flax itself moves when its input moves by a
relative 1e-6, and there the comparison cannot tell bf16 from f32. The
T-nets' FC BNs over 4 clouds make it worse: on other seeded inputs at
B=4, N=16 one such entry moved the T-net step's gradients by up to 0.6
norm-wise. So these tests run on one seeded input and weight set (B=4,
N=16) on which both packages round alike up to rare entries, the same
for the forward and the train steps, and hold the layers' casts apart.
There the train outputs agree to 2e-7 of scale (held to 1e-5), the eval
outputs to 2.5e-3 (T-net; the others 1.3e-7; held to 5e-3), running
statistics to 1.7e-5 (held to 1e-4) and gradients to 3.2e-2 norm-wise
per tensor (T-net; the sampler's 4.3e-3; held to 5e-2), while the port
run in f32 lands at least 0.17 (train outputs), 5.7e-3 (statistics) and
0.30 (some gradient) away, which the control asserts. Output dtypes are
held exactly to flax's. Gradients that are zero in exact arithmetic
(dense biases before a BN, and each max-pooled chain's last BN beta) are
not compared: in bf16 they are not round-off small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from samplenet_tpu.models import pointnet_cls as jm
from samplenet_tpu.models.samplenet import SampleNet as JaxSampleNet
from samplenet_tpu.nn.layers import PointMLP as JaxPointMLP
from samplenet_tpu.train import classification as jc
from samplenet_tpu.train.state import TrainState as JaxTrainState
from samplenet_tpu_torch.interop import (
    pointnet_state_dict_from_jax,
    samplenet_state_dict_from_jax,
)
from samplenet_tpu_torch.models import pointnet_cls as pm
from samplenet_tpu_torch.models.samplenet import SampleNet
from samplenet_tpu_torch.nn import layers
from samplenet_tpu_torch.train import classification as pc
from samplenet_tpu_torch.train import train_classifier, train_samplenet

torch.set_num_threads(1)

B, N, CLASSES = 4, 16, 5
BF16 = torch.bfloat16
OUT_RTOL = 1e-5          # of the tensor's largest entry
EVAL_RTOL = 5e-3
STATS_RTOL = 1e-4
GRAD_NORM = 5e-2         # norm-wise, per tensor
VARIANTS = ("samplenet", "vanilla", "tnet")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(tree):
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


def _perturb(variables, seed):
    rs = np.random.RandomState(seed)

    def f(path, a):
        name = jax.tree_util.keystr(path)
        if "batch_stats" in name and "var" in name:
            return (np.abs(a + 0.3 * rs.randn(*a.shape)) + 0.5).astype(
                np.float32)
        if "transform" in name:
            scale = 0.05 if "bias" in name else 0.002
            return (a + scale * rs.randn(*a.shape)).astype(np.float32)
        if "batch_stats" in name or "bn_" in name:
            return (a + 0.1 * rs.randn(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(f, _np(variables))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cancelled(variant: str, name: str) -> bool:
    """Zero gradient in exact arithmetic: a dense bias before a BN (the
    sampler's fc3 has one, the classifiers' fc3 is their linear output),
    and a max-pooled chain's last BN beta. In bf16 the dense bias enters
    before the rounding of the product's sum, so these are not round-off
    small and are not compared."""
    prefix, _, leaf = name.rpartition(".")
    last = prefix.rsplit(".", 1)[-1]
    fcs = ("fc1", "fc2", "fc3") if variant == "samplenet" \
        else ("fc1", "fc2", "fc_0", "fc_1")
    return (leaf == "bias" and (last.startswith("conv") or last in fcs)) \
        or name in ("bn5.bias", "convs_b.bn3.bias",
                    "tnet_input.convs.bn3.bias", "tnet_feature.convs.bn3.bias")


# ------------------------------------------------------------ the layers

def _flax_layer(kind, x, seed):
    """(output, d output / d input and params, new batch stats) of one flax
    layer at dtype=bf16 on x, with its variables."""
    mod = fnn.Dense(24, dtype=jnp.bfloat16) if kind == "dense" else \
        fnn.BatchNorm(use_running_average=kind == "bn-eval", momentum=0.9,
                      dtype=jnp.bfloat16)
    v = _perturb(mod.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    rs = np.random.RandomState(seed)
    if kind == "dense":
        v = {"params": {"kernel": v["params"]["kernel"],
                        "bias": (0.1 * rs.randn(24)).astype(np.float32)}}
    else:                      # BN's affine off the identity too
        c = x.shape[-1]
        v = {**v, "params": {
            "scale": (1 + 0.1 * rs.randn(c)).astype(np.float32),
            "bias": (0.1 * rs.randn(c)).astype(np.float32)}}
    g = np.random.RandomState(seed + 1).randn(
        *x.shape[:-1], 24 if kind == "dense" else x.shape[-1])

    def f(xx, params):
        out, upd = mod.apply({**v, "params": params}, xx,
                             mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * g), (out, upd)

    (_, (out, upd)), grads = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), v["params"])
    return v, np.asarray(out.astype(jnp.float32)), out.dtype, grads, upd, g


@pytest.mark.parametrize("kind", ["dense", "bn-train", "bn-eval"])
@pytest.mark.parametrize("shape", [(6, 32), (3, 10, 32)])
def test_dense_and_batchnorm_casts_match_flax(kind, shape):
    """One layer at dtype=bf16 on the same bf16 input: flax's output
    dtype, the output within one bf16 ulp at no more than 1 entry in 100
    (measured: 1 of 720 apart), d input within 1e-2 of scale (measured:
    equal) and d params within 2e-2 (measured 9.7e-3: the bias's sum of
    bf16 cotangents), and the running statistics (f32) within 1e-6."""
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    v, want, want_dtype, grads, upd, g = _flax_layer(kind, x, 3)
    tx = torch.from_numpy(x).to(BF16).requires_grad_(True)
    if kind == "dense":
        layer = layers.Linear(shape[-1], 24)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(
                np.asarray(v["params"]["kernel"]).T.copy()))
            layer.bias.copy_(torch.from_numpy(np.asarray(
                v["params"]["bias"])))
        out = layers.dense(layer, tx, BF16)
        pgrads = {"kernel": lambda: layer.weight.grad.t(),
                  "bias": lambda: layer.bias.grad}
    else:
        layer = layers.BatchNorm(shape[-1])
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(v["params"]["scale"]))
            layer.bias.copy_(torch.from_numpy(v["params"]["bias"]))
            layer.running_mean.copy_(torch.from_numpy(
                v["batch_stats"]["mean"]))
            layer.running_var.copy_(torch.from_numpy(
                v["batch_stats"]["var"]))
        out = layer(tx, kind == "bn-train", BF16)
        pgrads = {"scale": lambda: layer.weight.grad,
                  "bias": lambda: layer.bias.grad}
    assert str(out.dtype).endswith(str(want_dtype))
    (out.float() * torch.from_numpy(g).float()).sum().backward()
    got = out.detach().float().numpy()
    apart = got != want
    assert apart.mean() <= 1e-2
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
    assert _rel(tx.grad.float(), grads[0]) <= 1e-2
    for name, read in pgrads.items():
        assert _rel(read(), grads[1][name]) <= 2e-2, name
    if kind == "bn-train":
        new = upd["batch_stats"]
        assert layer.running_mean.dtype == torch.float32
        np.testing.assert_allclose(layer.running_mean, new["mean"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(layer.running_var, new["var"],
                                   rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ the models

def _x(seed=1):
    return np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)


def _flax_model(variant, dtype=jnp.bfloat16):
    if variant == "samplenet":
        model = JaxSampleNet(num_out_points=8, bottleneck_size=32,
                             group_size=4, sigma_mode="tf", dtype=dtype)
        v = model.init(jax.random.PRNGKey(0), jnp.asarray(_x()),
                       training=False)
    else:
        model = jm.PointNetClassifier(num_classes=CLASSES,
                                      use_tnets=variant == "tnet",
                                      dropout_rate=0.0, dtype=dtype)
        v = model.init(jax.random.PRNGKey(0), jnp.zeros((2, N, 3)),
                       training=False)
    return model, _perturb(v, 2)


def _to_sd(variant, v):
    fn = samplenet_state_dict_from_jax if variant == "samplenet" \
        else pointnet_state_dict_from_jax
    return fn(v)


def _port_model(variant, v, dtype=BF16):
    if variant == "samplenet":
        port = SampleNet(8, 32, 4, sigma_mode="tf", dtype=dtype)
    else:
        port = pm.PointNetClassifier(CLASSES, use_tnets=variant == "tnet",
                                     dropout_rate=0.0, dtype=dtype)
    port.load_state_dict(_sd(_to_sd(variant, v)))
    return port


def _outputs(variant, out):
    """Named outputs of a model call (flax's or the port's)."""
    if variant == "samplenet":
        return {"simplified": out[0], "projected": out[1]}
    logits, ends = out
    return {"logits": logits, **ends}


def _run(variant):
    """flax's train forward, the gradients of a loss of its outputs and its
    new statistics, and its eval forward; the port's at bf16 and at f32
    on the same weights."""
    model, v = _flax_model(variant)
    x = _x()
    key = "simplified" if variant == "samplenet" else "logits"

    def f(params):
        out, upd = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(x), training=True, mutable=["batch_stats"])
        outs = _outputs(variant, out)
        return jnp.sum(outs[key] * 1.5) + jnp.sum(
            outs.get("projected", outs[key]) ** 2), (outs, upd)

    (_, (outs, upd)), grads = jax.value_and_grad(f, has_aux=True)(
        v["params"])
    if variant == "samplenet":
        eval_out = {"simplified": model.apply(
            v, jnp.asarray(x), training=False, method=JaxSampleNet.simplify)}
    else:
        eval_out = _outputs(variant, model.apply(v, jnp.asarray(x),
                                                 training=False))
    want = dict(outs={k: np.asarray(t.astype(jnp.float32))
                      for k, t in outs.items()},
                dtypes={k: str(t.dtype) for k, t in outs.items()},
                eval={k: np.asarray(t.astype(jnp.float32))
                      for k, t in eval_out.items()},
                grads=_to_sd(variant, {"params": _np(grads),
                                       "batch_stats": v["batch_stats"]}),
                new=_to_sd(variant, {"params": v["params"],
                                     "batch_stats": _np(upd["batch_stats"])}))
    got = {}
    for name, dtype in (("bf16", BF16), ("f32", None)):
        port = _port_model(variant, v, dtype)
        with torch.no_grad():
            ev = port.simplify(torch.from_numpy(x)) \
                if variant == "samplenet" else port(torch.from_numpy(x))
        ev = {"simplified": ev} if variant == "samplenet" \
            else _outputs(variant, ev)
        o = _outputs(variant, port(torch.from_numpy(x), training=True))
        loss = (o[key] * 1.5).sum() + (o.get("projected", o[key]) ** 2).sum()
        loss.backward()
        got[name] = dict(
            outs={k: t.detach().float().numpy() for k, t in o.items()},
            dtypes={k: str(t.dtype) for k, t in o.items()},
            eval={k: t.float().numpy() for k, t in ev.items()},
            grads={n: p.grad.numpy() for n, p in port.named_parameters()},
            new={k: t.numpy() for k, t in port.state_dict().items()
                 if "running_" in k},
            new_dtypes={t.dtype for k, t in port.state_dict().items()
                        if "running_" in k})
    return variant, want, got


@pytest.fixture(scope="module", params=VARIANTS)
def runs(request):
    return _run(request.param)


def _errors(variant, want, got):
    """Worst output (train, eval), statistic and per-tensor norm-wise
    gradient error."""
    outs = max(_rel(got["outs"][k], w) for k, w in want["outs"].items()
               if k != "critical_set_idx")
    evals = max(_rel(got["eval"][k], w) for k, w in want["eval"].items()
                if k != "critical_set_idx")
    stats = max(_rel(t, want["new"][k]) for k, t in got["new"].items())
    scale = max(float(np.abs(g).max()) for g in want["grads"].values())
    grads = max(_norm(g, want["grads"][n]) for n, g in got["grads"].items()
                if not _cancelled(variant, n)
                and np.abs(want["grads"][n]).max()
                > 1e-5 * scale)
    return outs, evals, stats, grads


def test_forward_gradients_and_statistics_match_flax(runs):
    variant, want, got = runs
    bf = got["bf16"]
    for k, dtype in want["dtypes"].items():
        if k != "critical_set_idx":
            assert bf["dtypes"][k] == f"torch.{dtype}", k
    outs, evals, stats, grads = _errors(variant, want, bf)
    assert outs <= OUT_RTOL and evals <= EVAL_RTOL
    assert stats <= STATS_RTOL and bf["new_dtypes"] == {torch.float32}
    assert grads <= GRAD_NORM


def test_the_port_in_f32_fails_the_bf16_comparison(runs):
    """The control: the port at dtype None against flax at bf16 fails each
    of the train output, statistics and gradient tolerances."""
    variant, want, got = runs
    outs, _, stats, grads = _errors(variant, want, got["f32"])
    assert outs > OUT_RTOL and stats > STATS_RTOL and grads > GRAD_NORM


# ------------------------------------------------------------ train steps

def _classifier_step(use_tnets):
    """One ClassifierConfig(bf16=True) step on both packages from the same
    state (dropout 0, no augmentation): loss, accuracy, gradients, new
    parameters and statistics."""
    x = _x()
    y = np.random.RandomState(10).randint(0, CLASSES, B).astype(np.int32)
    kw = dict(num_classes=CLASSES, batch_size=B, use_tnets=use_tnets,
              augment=False, bf16=True)
    jcfg = jc.ClassifierConfig(**kw, num_points=N)
    jmodel, state = jc.create_classifier_state(jcfg, jax.random.PRNGKey(0))
    jmodel = jmodel.clone(dropout_rate=0.0)
    v0 = _perturb({"params": state.params,
                   "batch_stats": state.batch_stats}, 2)
    state = JaxTrainState.create(params=v0["params"],
                                 batch_stats=v0["batch_stats"], tx=state.tx)

    def loss_fn(params):               # classification.py:110-117
        (logits, ends), _ = jmodel.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jnp.asarray(x), training=True, mutable=["batch_stats"])
        return jm.pointnet_loss(logits, jnp.asarray(y), ends)

    jgrads = _np(jax.grad(loss_fn)(state.params))
    jnew, jloss, jacc = jc.make_classifier_train_step(jmodel, jcfg)(
        state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(2))
    cfg = pc.ClassifierConfig(**kw)
    port, pstate = pc.create_classifier_state(cfg, device="cpu")
    assert port.dtype == BF16
    port.load_state_dict(_sd(pointnet_state_dict_from_jax(v0)))
    port.dropout_rate = 0.0
    loss, acc = pc.make_classifier_train_step(port, cfg)(
        pstate, torch.from_numpy(x), torch.from_numpy(y).long())
    return dict(
        variant="tnet" if use_tnets else "vanilla", loss=loss, acc=acc,
        jloss=jloss, jacc=jacc, port=port,
        jgrads=pointnet_state_dict_from_jax(
            {"params": jgrads, "batch_stats": v0["batch_stats"]}),
        jnew=pointnet_state_dict_from_jax(
            {"params": _np(jnew.params),
             "batch_stats": _np(jnew.batch_stats)}))


def _sampler_step():
    """One SampleNetConfig(bf16=True) step against the frozen f32
    classifier on both packages from the same state."""
    from samplenet_tpu.train.classification import (
        SampleNetConfig as JaxSampleNetConfig,
    )
    x = _x()
    y = np.random.RandomState(10).randint(0, 4, B).astype(np.int32)
    kw = dict(num_out_points=8, bottleneck_size=32, group_size=4,
              batch_size=B, bf16=True)
    cls = jm.PointNetClassifier(num_classes=4)
    cv = cls.init(jax.random.PRNGKey(1), jnp.asarray(x[:, :8]),
                  training=False)
    jcfg = JaxSampleNetConfig(**kw)
    sampler, state = jc.create_samplenet_state(jcfg, N, jax.random.PRNGKey(0))
    v0 = _perturb({"params": state.params,
                   "batch_stats": state.batch_stats}, 2)
    state = JaxTrainState.create(params=v0["params"],
                                 batch_stats=v0["batch_stats"], tx=state.tx)

    def loss_fn(params):          # classification.py:199-218
        variables = {"params": params, "batch_stats": state.batch_stats}
        (simp, proj), _ = sampler.apply(variables, jnp.asarray(x),
                                        training=True,
                                        mutable=["batch_stats"])
        logits, _ = cls.apply(cv, proj, training=False)
        return (jm.classification_loss(logits, jnp.asarray(y))
                + 30.0 * sampler.apply(
                    variables, jnp.asarray(x), simp, 8, 1.0, 0.0,
                    method=JaxSampleNet.get_simplification_loss)
                + sampler.apply(variables,
                                method=JaxSampleNet.get_projection_loss))

    jgrads = _np(jax.grad(loss_fn)(state.params))
    jnew, jm_ = jc.make_samplenet_train_step(sampler, cls, cv, jcfg,
                                             augment_data=False)(
        state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(2))
    cfg = pc.SampleNetConfig(**kw)
    port, pstate = pc.create_samplenet_state(cfg, device="cpu")
    assert port.dtype == BF16
    port.load_state_dict(_sd(samplenet_state_dict_from_jax(v0)))
    classifier = pm.PointNetClassifier(4)
    classifier.load_state_dict(_sd(pointnet_state_dict_from_jax(_np(cv))))
    pm_ = pc.make_samplenet_train_step(port, classifier, cfg,
                                       augment_data=False)(
        pstate, torch.from_numpy(x), torch.from_numpy(y).long())
    return dict(
        variant="samplenet", loss=pm_["loss"], acc=pm_["acc"],
        jloss=jm_["loss"], jacc=jm_["acc"], port=port,
        jgrads=samplenet_state_dict_from_jax(
            {"params": jgrads, "batch_stats": v0["batch_stats"]}),
        jnew=samplenet_state_dict_from_jax(
            {"params": _np(jnew.params),
             "batch_stats": _np(jnew.batch_stats)}),
        classifier_dtype=classifier.dtype)


@pytest.fixture(scope="module", params=["vanilla", "tnet", "samplenet"])
def steps(request):
    if request.param == "samplenet":
        return _sampler_step()
    return _classifier_step(request.param == "tnet")


def test_bf16_train_step_matches_jax(steps):
    """The loss within rtol 1e-4 (measured: 3e-7), the accuracy equal,
    each gradient within GRAD_NORM norm-wise, the new running statistics
    within STATS_RTOL of scale, and the new parameters within 1e-6 where
    both packages' Adam steps take the same sign: where JAX's gradient is
    above 5e-2 of its tensor's largest entry (some entry of each tensor
    is), as Adam's first step moves each entry by +-lr."""
    variant = steps["variant"]
    np.testing.assert_allclose(float(steps["loss"]), float(steps["jloss"]),
                               rtol=1e-4)
    assert float(steps["acc"]) == float(steps["jacc"])
    port, jgrads, jnew = steps["port"], steps["jgrads"], steps["jnew"]
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, p in port.named_parameters():
        want = jgrads[name]
        if _cancelled(variant, name) or np.abs(want).max() <= 1e-5 * scale:
            continue
        assert _norm(p.grad, want) <= GRAD_NORM, name
    for name, t in port.state_dict().items():
        if "running_" in name:
            assert _rel(t, jnew[name]) <= STATS_RTOL, name
        elif not name.endswith("num_batches_tracked") \
                and not _cancelled(variant, name):
            g = np.abs(jgrads[name])
            same = g > 5e-2 * g.max()
            assert same.any(), name
            np.testing.assert_allclose(t.numpy()[same], jnew[name][same],
                                       atol=1e-6, err_msg=name)
    if variant == "samplenet":
        assert steps["classifier_dtype"] is None     # the frozen one: f32


# ------------------------------------------------------------ the rules

@pytest.mark.parametrize("dtype", [None, "bf16"])
@pytest.mark.parametrize("fused_train", [None, False, True])
@pytest.mark.parametrize("fused_mode", ["ghost", "exact"])
@pytest.mark.parametrize("fused_bf16", [None, False, True])
@pytest.mark.parametrize("shape,widths,training,pool_max", [
    ((32, 1024, 3), (64, 64, 64, 128, 128), True, True),
    ((4, 200, 3), (64, 64, 64, 128, 128), True, True),   # N % 128 != 0
    ((4, 256, 3), (16,), True, True),                     # one layer
    ((4, 256, 3), (64, 64, 64, 128, 128), False, True),   # eval
    ((4, 256, 3), (64, 64, 64, 128, 128), True, False),   # no pool
])
def test_fused_mode_rule_matches_jax_on_its_tpu(
        monkeypatch, dtype, fused_train, fused_mode, fused_bf16, shape,
        widths, training, pool_max):
    """The port's rule against PointMLP._resolve_fused_mode as it decides
    on a TPU (pallas_backend_ok True): JAX's "ghost" is the port's
    "ghost"; its exact kernel is "exact_bf16" where its precision
    (`_fused_bf16("exact")`) is bf16, else "exact"; its XLA chain (None)
    is "plain" with a compute dtype, else "exact"."""
    monkeypatch.setattr("samplenet_tpu.ops.dispatch.pallas_backend_ok",
                        lambda: True)
    jmod = JaxPointMLP(features=widths, fused_train=fused_train,
                       fused_mode=fused_mode, fused_bf16=fused_bf16,
                       dtype=jnp.bfloat16 if dtype else None)
    jax_mode = jmod._resolve_fused_mode(jnp.zeros(shape), training,
                                        pool_max)
    if jax_mode == "exact":
        want = "exact_bf16" if jmod._fused_bf16("exact") else "exact"
    elif jax_mode is None:
        want = "plain" if dtype else "exact"
    else:
        want = jax_mode
    got = layers.resolve_fused_mode(
        torch.zeros(shape), widths, training=training, pool_max=pool_max,
        fused_train=fused_train, fused_mode=fused_mode,
        fused_bf16=fused_bf16, dtype=BF16 if dtype else None)
    assert got == want


@pytest.mark.parametrize("dtype", [None, "bf16"])
@pytest.mark.parametrize("shape,training,pool_max", [
    ((4, 256, 3), False, True), ((4, 100, 3), False, True),
    ((4, 256, 3), True, True), ((4, 256, 3), False, False)])
def test_eval_kernel_rule_matches_jax_on_its_tpu(monkeypatch, dtype, shape,
                                                  training, pool_max):
    monkeypatch.setattr("samplenet_tpu.ops.dispatch.pallas_backend_ok",
                        lambda: True)
    jmod = JaxPointMLP(features=(8, 16),
                       dtype=jnp.bfloat16 if dtype else None)
    want = jmod._fused_ok(jnp.zeros(shape), training, pool_max)
    got = layers.use_eval_kernel(torch.zeros(shape), training=training,
                                 pool_max=pool_max,
                                 dtype=BF16 if dtype else None)
    assert got == want


def test_compute_dtype_launches_no_kernel(monkeypatch):
    """With a dtype the conv chain is tensor ops, train or eval, even with
    fused_train and at N >= 128, as in the JAX package."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel's wrapper was called")

    for name in ("point_mlp_exact_train_max", "point_mlp_train_max",
                 "point_mlp_max"):
        monkeypatch.setattr(layers, name, refuse)
    net = SampleNet(8, 32, 4, dtype=BF16, fused_train=True)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 128, 3)
                         .astype(np.float32))
    simp, proj = net(x, training=True)
    assert simp.dtype == proj.dtype == torch.float32
    with torch.no_grad():
        assert net.simplify(x).dtype == torch.float32


# ------------------------------------------------------------ the CLIs

CLI = ["--device", "cpu", "--num-points", "128", "--train-size", "16",
       "--test-size", "6", "--batch-size", "4", "--epochs", "1",
       "--steps-per-epoch", "2"]


@pytest.mark.parametrize("cli", ["train_classifier", "train_samplenet"])
def test_bf16_cli_trains(cli, tmp_path, capsys):
    """--bf16 trains the model in bf16 (the sampler against a frozen f32
    classifier) and publishes f32 weights; the sampler's config records
    the flag, as the JAX CLI's vars(args) does."""
    log = tmp_path / "log"
    if cli == "train_classifier":
        state = train_classifier.main(CLI + ["--bf16", "--log-dir",
                                             str(log)])
        weights = log / "ckpt" / "classifier.pth"
    else:
        cls_path = tmp_path / "classifier.pth"
        torch.save(pm.PointNetClassifier(24).state_dict(), cls_path)
        state = train_samplenet.main(CLI + [
            "--bf16", "--num-out-points", "8", "--classifier-weights",
            str(cls_path), "--log-dir", str(log)])
        weights = log / "ckpt" / "sampler.pth"
        import json
        assert json.loads((log / "ckpt" / "config.json").read_text())[
            "bf16"] is True
    assert state.step == 2 and state.model.dtype == BF16
    assert "epoch 0:" in capsys.readouterr().out
    sd = torch.load(weights, weights_only=True)
    assert {t.dtype for k, t in sd.items()
            if not k.endswith("num_batches_tracked")} == {torch.float32}
