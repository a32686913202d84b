"""Wide and odd widths: the port against the JAX package on the CPU, and
the wrappers' padding of widths that are not multiples of 4.

At a bottleneck of 1024 the JAX package trains with its XLA chain
wherever its exact kernel's VMEM plan does not fit (`auto_block_b_exact`
None; off the TPU always), and the port with its exact chain, whose
plain version runs here (on the card the kernels, `pmt_bwd_dz` in
chunks of output channels). Three checks at B=16, N=128, from numpy
seeds: the exact chain 3-16-32-1024 against `PointMLP(fused_train=False)`
(forward, running statistics, every gradient); SampleNet's train step at
bottleneck 1024 against `make_samplenet_train_step`; the AE step at
bottleneck 1024 (Chamfer loss) against `make_ae_train_step`.

The padding (`point_mlp_train_kernel.padded_call`,
`point_mlp_kernel.padded_pairs`) runs on the card where an output width
is not a multiple of 4; here it runs with the plain versions as its body,
at a bottleneck of 130 and an inner width of 18, against the same chains
unpadded: pooled features, statistics and every gradient, for the exact
chain (f32 and bf16), the ghost chain (f32 and bf16) and point_mlp_max
(f32 and bf16).

Tolerances, those of tests/test_torch_port_train_step.py and
test_torch_port_train_layers.py: loss terms rtol 1e-5; forward rtol 1e-5
/ atol 1e-6; gradients rtol 1e-3 with an atol of 1e-4 of the tensor's
largest entry; running statistics rtol 1e-4 / atol 1e-6. The padded
chains add exact zeros to every sum of a real channel, so they are held
to the unpadded ones at f32 round-off (rtol 1e-6 / atol 1e-7: the
matmuls' blocking may move with the padded shapes), bf16 included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu.models.pointnet_cls import (
    PointNetClassifier as JaxPointNetClassifier,
)
from samplenet_tpu.nn.layers import PointMLP as JaxPointMLP
from samplenet_tpu.train import reconstruction as jr
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
    autoencoder_state_dict_from_jax,
    pointnet_state_dict_from_jax,
    samplenet_state_dict_from_jax,
)
from samplenet_tpu_torch.models import PointNetClassifier
from samplenet_tpu_torch.nn import PointMLP
from samplenet_tpu_torch.nn.layers import resolve_fused_mode
from samplenet_tpu_torch.ops.cuda import point_mlp_kernel as pmk
from samplenet_tpu_torch.ops.cuda import point_mlp_plan as plan
from samplenet_tpu_torch.ops.cuda.point_mlp_exact_kernel import (
    point_mlp_exact_train_max,
)
from samplenet_tpu_torch.ops.cuda.point_mlp_train_kernel import (
    padded_call,
    point_mlp_train_max,
)
from samplenet_tpu_torch.train import reconstruction as pr
from samplenet_tpu_torch.train.classification import (
    SampleNetConfig,
    create_samplenet_state,
    make_samplenet_train_step,
)

torch.set_num_threads(1)

B, N = 16, 128
WIDE = 1024
FEATS = (16, 32, WIDE)
CANCELLED = {f"conv{i}.bias" for i in range(1, 6)} | {
    "bn5.bias", "fc1.bias", "fc2.bias", "fc3.bias"}
AE_CANCELLED = {f"encoder.conv{i}.bias" for i in range(1, 6)}


def _sd(tree):
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_grads(model, jgrads, cancelled):
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, p in model.named_parameters():
        got, want = p.grad.numpy(), jgrads[name]
        if name in cancelled:
            assert float(np.abs(got).max()) < 1e-5 * scale, name
            assert float(np.abs(want).max()) < 1e-5 * scale, name
            continue
        np.testing.assert_allclose(
            got, want, rtol=1e-3, atol=1e-4 * float(np.abs(want).max()),
            err_msg=name)


def _assert_running(model, jnew):
    for name, v in model.state_dict().items():
        if "running_" in name:
            np.testing.assert_allclose(v.numpy(), jnew[name], rtol=1e-4,
                                       atol=1e-6, err_msg=name)


# ------------------------------------------- bottleneck 1024 against JAX

def test_jax_runs_its_xla_chain_where_the_port_runs_the_exact_kernel():
    """At N=1024 the JAX exact kernel's VMEM plan has no block for a
    1024-wide chain, so the JAX package trains it with its XLA chain; the
    port's rule picks "exact", which on a CUDA tensor is the kernel and
    computes what the XLA chain computes."""
    from samplenet_tpu.ops.pallas.point_mlp_exact_kernel import (
        auto_block_b_exact,
    )

    widths = (64, 64, 64, 128, WIDE)
    assert auto_block_b_exact(32, 1024, widths) is None
    x = torch.zeros(32, 1024, 3)
    assert resolve_fused_mode(x, widths, training=True, pool_max=True) \
        == "exact"


def test_exact_chain_at_bottleneck_1024_matches_xla_chain():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(B, N, 3), jnp.float32)
    jm = JaxPointMLP(features=FEATS, fused_train=False)
    v = jm.init(jax.random.PRNGKey(0), x[:2], training=False)
    r = np.random.RandomState(1)
    v = jax.tree.map(
        lambda a: a + 0.1 * r.randn(*a.shape).astype(np.float32), v)

    def loss(params, xx):
        out, upd = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, xx,
            training=True, pool_max=True, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(out)), (out, upd)

    (_, (want, upd)), (g, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], x)
    port = PointMLP(3, FEATS)
    p, s = v["params"], v["batch_stats"]
    sd = {}
    for i in range(len(FEATS)):
        sd[f"conv{i + 1}.weight"] = np.asarray(
            p[f"dense_{i}"]["kernel"]).T[:, :, None]
        sd[f"conv{i + 1}.bias"] = np.asarray(p[f"dense_{i}"]["bias"])
        sd[f"bn{i + 1}.weight"] = np.asarray(p[f"bn_{i}"]["scale"])
        sd[f"bn{i + 1}.bias"] = np.asarray(p[f"bn_{i}"]["bias"])
        sd[f"bn{i + 1}.running_mean"] = np.asarray(s[f"bn_{i}"]["mean"])
        sd[f"bn{i + 1}.running_var"] = np.asarray(s[f"bn_{i}"]["var"])
        sd[f"bn{i + 1}.num_batches_tracked"] = np.asarray(0)
    port.load_state_dict(_sd(sd))
    xt = torch.tensor(np.asarray(x), requires_grad=True)
    got = port(xt, training=True, pool_max=True)
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-3,
                               atol=1e-4 * float(np.abs(gx).max()))
    for i in range(len(FEATS)):
        conv, bn = getattr(port, f"conv{i + 1}"), getattr(port, f"bn{i + 1}")
        for got_g, want_g in ((conv.weight.grad[:, :, 0].T,
                               g[f"dense_{i}"]["kernel"]),
                              (bn.weight.grad, g[f"bn_{i}"]["scale"]),
                              (bn.bias.grad, g[f"bn_{i}"]["bias"])):
            want_g = np.asarray(want_g)
            np.testing.assert_allclose(
                got_g.numpy(), want_g, rtol=1e-3,
                atol=1e-4 * float(np.abs(want_g).max()))
        assert not conv.bias.grad.any()
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(bn, ours).numpy(),
                np.asarray(upd["batch_stats"][f"bn_{i}"][theirs]),
                rtol=1e-4, atol=1e-6)


def test_samplenet_step_at_bottleneck_1024_matches_jax():
    kw = dict(num_out_points=8, bottleneck_size=WIDE, group_size=4,
              batch_size=B)
    rng = np.random.RandomState(0)
    x = rng.randn(B, N, 3).astype(np.float32)
    y = rng.randint(0, 4, B).astype(np.int32)
    cls = JaxPointNetClassifier(num_classes=4)
    cv = cls.init(jax.random.PRNGKey(1), jnp.asarray(x[:, :8]),
                  training=False)
    jcfg = JaxSampleNetConfig(**kw)
    sampler, state = jax_create_samplenet_state(jcfg, N,
                                                jax.random.PRNGKey(0))
    v0 = {"params": _np(state.params), "batch_stats": _np(state.batch_stats)}
    jstep = jax_make_samplenet_train_step(sampler, cls, cv, jcfg,
                                          augment_data=False)

    def loss_fn(params):
        from samplenet_tpu.models.pointnet_cls import classification_loss
        from samplenet_tpu.models.samplenet import SampleNet

        variables = {"params": params, "batch_stats": state.batch_stats}
        (simp, proj), _ = sampler.apply(variables, jnp.asarray(x),
                                        training=True,
                                        mutable=["batch_stats"])
        logits, _ = cls.apply(cv, proj, training=False)
        return (classification_loss(logits, jnp.asarray(y))
                + 30.0 * sampler.apply(
                    variables, jnp.asarray(x), simp, 8, 1.0, 0.0,
                    method=SampleNet.get_simplification_loss)
                + sampler.apply(variables,
                                method=SampleNet.get_projection_loss))

    jgrads = samplenet_state_dict_from_jax(
        {"params": _np(jax.grad(loss_fn)(state.params)),
         "batch_stats": v0["batch_stats"]})
    jnew, jm = jstep(state, jnp.asarray(x), jnp.asarray(y),
                     jax.random.PRNGKey(2))
    jnewsd = samplenet_state_dict_from_jax(
        {"params": _np(jnew.params), "batch_stats": _np(jnew.batch_stats)})

    cfg = SampleNetConfig(**kw)
    port, pstate = create_samplenet_state(cfg, device="cpu")
    port.load_state_dict(_sd(samplenet_state_dict_from_jax(v0)))
    assert port.conv5.weight.shape[0] == WIDE
    classifier = PointNetClassifier(4)
    classifier.load_state_dict(_sd(pointnet_state_dict_from_jax(_np(cv))))
    pm = make_samplenet_train_step(port, classifier, cfg,
                                   augment_data=False)(
        pstate, torch.from_numpy(x), torch.from_numpy(y).long())
    for k in ("loss", "task", "simplification", "projection", "acc"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    _assert_grads(port, jgrads, CANCELLED)
    _assert_running(port, jnewsd)


def test_ae_step_at_bottleneck_1024_matches_jax():
    x = np.random.RandomState(3).randn(B, N, 3).astype(np.float32)
    kw = dict(num_points=N, bottleneck_size=WIDE, batch_size=B,
              n_sample_points=N, loss="chamfer")
    jcfg = jr.AEConfig(**kw)
    jmodel, jstate = jr.create_ae_state(jcfg, jax.random.PRNGKey(0))
    v0 = {"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)}
    inner = jr._ae_loss_fn("chamfer", False, jcfg.emd_kernel)

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

    cfg = pr.AEConfig(**kw)
    model, state = pr.create_ae_state(cfg, device="cpu")
    model.load_state_dict(_sd(autoencoder_state_dict_from_jax(v0)))
    assert model.encoder.conv5.weight.shape[0] == WIDE
    got = pr.make_ae_train_step(model, cfg)(state, torch.from_numpy(x))
    np.testing.assert_allclose(float(got), float(jloss), rtol=1e-5)
    _assert_grads(model, jgrads, AE_CANCELLED)
    _assert_running(model, jnewsd)


# ----------------------------------------------- widths padded to 4

ODD = (3, 18, 64, 130)       # an inner and a last width not multiples of 4


def _chain_inputs(widths, seed=5, b=8, n=64):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, n, widths[0]))
                         .astype(np.float32))
    groups = [[], [], [], []]
    for cin, cout in zip(widths[:-1], widths[1:]):
        vals = (rng.standard_normal((cin, cout)) / np.sqrt(cin),
                0.1 * rng.standard_normal(cout),
                1 + 0.1 * rng.standard_normal(cout),
                0.1 * rng.standard_normal(cout))
        for grp, val in zip(groups, vals):
            grp.append(torch.from_numpy(val.astype(np.float32)))
    g = torch.from_numpy(rng.standard_normal((b, widths[-1]))
                         .astype(np.float32))
    return x, groups, g


def _run(chain, x, groups, g, padded):
    """(pooled, statistics, gradients of x and every parameter) of
    `chain`, called through `padded_call` where `padded`."""
    x = x.clone().requires_grad_(True)
    groups = [[t.clone().requires_grad_(True) for t in grp]
              for grp in groups]
    widths = [x.shape[-1], *(w.shape[1] for w in groups[0])]
    if padded:
        pooled, means, vars_ = padded_call(
            lambda *p: chain(x, *p), widths, *groups)
    else:
        pooled, means, vars_ = chain(x, *groups)
    (pooled * g).sum().backward()
    return ([pooled.detach(), *means, *vars_],
            [x.grad, *(t.grad for grp in groups for t in grp)])


CHAINS = {
    "exact": lambda x, *p: point_mlp_exact_train_max(x, *p),
    "exact bf16": lambda x, *p: point_mlp_exact_train_max(x, *p, bf16=True),
    "ghost": lambda x, *p: point_mlp_train_max(x, *p, block_b=2,
                                               bf16=False),
    "ghost bf16": lambda x, *p: point_mlp_train_max(x, *p, block_b=2,
                                                    bf16=True),
}


@pytest.mark.parametrize("name", list(CHAINS))
def test_padding_leaves_the_train_chains_unchanged(name):
    x, groups, g = _chain_inputs(ODD)
    outs_p, grads_p = _run(CHAINS[name], x, groups, g, padded=True)
    outs, grads = _run(CHAINS[name], x, groups, g, padded=False)
    for a, c in zip(outs_p, outs):
        assert a.shape == c.shape
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)
    for a, c in zip(grads_p, grads):
        assert a.shape == c.shape
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)
    # the dense biases get exact zeros, padded or not
    nl = len(ODD) - 1
    assert not any(t.any() for t in grads_p[1 + nl:1 + 2 * nl])


def test_padded_call_runs_the_kernel_widths():
    """The body sees every output width rounded up to 4, zero weight
    rows and columns, zero bias, gamma = beta = 0 in the padding."""
    x, groups, _ = _chain_inputs(ODD)
    seen = {}

    def body(ws, bs, gs, betas):
        seen.update(ws=ws, bs=bs, gs=gs, betas=betas)
        return point_mlp_exact_train_max(x, ws, bs, gs, betas)

    pooled, means, vars_ = padded_call(body, list(ODD), *groups)
    kw = plan.kernel_widths(ODD)
    assert kw == (3, 20, 64, 132)
    assert [tuple(w.shape) for w in seen["ws"]] == list(zip(kw[:-1], kw[1:]))
    for i, (w, c) in enumerate(zip(groups[0], ODD[1:])):
        assert torch.equal(seen["ws"][i][:w.shape[0], :c], w)
        assert not seen["ws"][i][:, c:].any()
        assert not seen["ws"][i][w.shape[0]:].any()
        for key in ("bs", "gs", "betas"):
            assert not seen[key][i][c:].any()
    assert pooled.shape == (8, 130)
    assert [m.shape[0] for m in means] == [v.shape[0] for v in vars_] \
        == list(ODD[1:])


@pytest.mark.parametrize("bf16", [False, True])
def test_padding_leaves_point_mlp_max_unchanged(bf16):
    x, (ws, bs, _, _), _ = _chain_inputs(ODD)
    pairs = list(zip(ws, bs))
    padded, kw = pmk.padded_pairs(pairs, list(ODD))
    assert kw == plan.kernel_widths(ODD)
    got = pmk.point_mlp_max_plain(x, [t for p in padded for t in p], bf16)
    want = pmk.point_mlp_max_plain(x, [t for p in pairs for t in p], bf16)
    assert got.shape == (8, 132)
    torch.testing.assert_close(got[:, :130], want, rtol=1e-6, atol=1e-7)
    assert not got[:, 130:].any()          # relu(0) in the padding


# ------------------------------------- other kernels' caps against JAX's

def test_emd_cap_is_below_what_the_jax_kernel_takes_on_its_tpu():
    """The EMD block holds xyz2's whole state: 44 bytes a column and 7
    floats a 32-column chunk, so the H100's 232,448 bytes take m <= 5094
    and refuse m = 8192 (`train_reconstruction --num-points 8192`). The
    JAX kernel's own VMEM rule (`_auto_nt`: 8 live [nt, m_pad] f32
    intermediates, nt at least 128) needs 32 MiB there, twice the 16 MiB
    of scoped VMEM it runs under (it sets no vmem limit): it does not take
    m = 8192 either, and at 4096 its intermediates alone fill the 16 MiB."""
    from samplenet_tpu.ops.pallas import emd_kernel as jax_emd

    from samplenet_tpu_torch.ops.cuda import emd_kernel as emd

    scoped = 16 * 2 ** 20
    for m, jax_bytes in ((2048, 8 * 2 ** 20), (4096, scoped),
                         (8192, 32 * 2 ** 20)):
        nt = jax_emd._auto_nt(m, m)
        assert 8 * nt * m * 4 == jax_bytes, m
    assert emd.max_columns(232448) == 5094
    assert emd.emd_smem(5094) <= 232448 < emd.emd_smem(5095)
    assert emd.emd_smem(8192) > 232448
    # the reconstruction track's 2048 points fit with room
    assert 2 * emd.emd_smem(2048) < 232448


def test_nn_grid_cap_is_beyond_what_either_card_holds():
    """The 1-NN kernel's one cap is its flat grid, 2**31 - 1 blocks of 32
    queries or more: x alone would then pass 800 GB, beyond both the
    H100's 80 GB and a TPU's HBM, so the JAX kernel never meets that shape
    either; the planner's message names the limit."""
    from samplenet_tpu_torch.ops.cuda import nn_plan

    with pytest.raises(ValueError, match=r"flat grid \(2147483647 blocks\)"):
        nn_plan.plan(2 ** 30, 100_000, 10, 132)
    assert 32 * nn_plan.MAX_GRID * 12 > 800e9


def _top_layer(x, w, gamma, beta, g, bf16):
    """The one-layer exact chain's saved state and its top layer's
    pmt_bwd_dz arguments (r1, r2 from the plain sums, as the plain
    backward forms them)."""
    from samplenet_tpu_torch.ops.cuda.point_mlp_exact_kernel import (
        point_mlp_exact_fwd_plain,
    )

    b, n, _ = x.shape
    zs, mus, rstds, argmax = point_mlp_exact_fwd_plain(
        x, [w], [gamma], [beta], 1e-5, bf16)[3]
    cout = w.shape[1]
    dh = torch.zeros((b, n, cout))
    dh.scatter_(1, argmax[:, None, :], g[:, None, :])
    xhat = (zs[0] - mus[0]) * rstds[0]
    dy = torch.where(torch.relu(gamma * xhat + beta) > 0, dh.reshape(-1, cout),
                     torch.zeros(()))
    r1 = gamma * dy.sum(0) / (b * n)
    r2 = gamma * (dy * xhat).sum(0) / (b * n)
    bn = (mus[0], rstds[0], gamma, beta)
    return (zs, mus, rstds, argmax), (zs[0], bn, rstds[0][None], r1[None],
                                      r2[None])


@pytest.mark.parametrize("bf16", [False, True])
def test_dz_layer_plain_is_the_chains_top_layer(bf16):
    """`dz_layer_plain`, the plain version of pmt_bwd_dz_chunked (the top
    layer at 1024 outputs), gives the one-layer exact chain's dx: in f32
    (mode 0) against the JAX package's XLA chain (the tolerances above),
    and in f32 and bf16 (mode 2) against the port's plain backward (rtol
    1e-6: the same operations)."""
    from samplenet_tpu_torch.ops.cuda.point_mlp_exact_kernel import (
        point_mlp_exact_bwd_plain,
    )
    from samplenet_tpu_torch.ops.cuda.point_mlp_train_kernel import (
        dz_layer_plain,
    )

    rng = np.random.RandomState(3)
    b, n, cin, cout = 4, 96, 16, WIDE
    x = torch.tensor(rng.randn(b, n, cin), dtype=torch.float32)
    w = torch.tensor(rng.randn(cin, cout) / 4.0, dtype=torch.float32)
    gamma = torch.tensor(1 + 0.1 * rng.randn(cout), dtype=torch.float32)
    beta = torch.tensor(0.1 * rng.randn(cout), dtype=torch.float32)
    g = torch.tensor(rng.randn(b, cout), dtype=torch.float32)
    saved, (z, bn, rstd2, r1, r2) = _top_layer(x, w, gamma, beta, g, bf16)
    mode = 2 if bf16 else 0
    dz, dh_prev = dz_layer_plain(z, bn, rstd2, r1, r2, None, g, saved[3],
                                 pmk.round_op(w, bf16), b, n, mode)
    dx = point_mlp_exact_bwd_plain(x, [w], [gamma], [beta], saved, g,
                                   bf16)[0]
    np.testing.assert_allclose(dh_prev.reshape(b, n, cin).numpy(),
                               dx.numpy(), rtol=1e-6,
                               atol=1e-6 * float(dx.abs().max()))
    if bf16:
        return
    jm = JaxPointMLP(features=(cout,), fused_train=False)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x.numpy()[:1]),
                training=False)
    params = {"dense_0": {"kernel": jnp.asarray(w.numpy()),
                          "bias": jnp.zeros(cout)},
              "bn_0": {"scale": jnp.asarray(gamma.numpy()),
                       "bias": jnp.asarray(beta.numpy())}}

    def loss(xx):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          xx, training=True, pool_max=True,
                          mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(g.numpy()))

    gx = np.asarray(jax.grad(loss)(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(dh_prev.reshape(b, n, cin).numpy(), gx,
                               rtol=1e-3, atol=1e-4 * float(np.abs(gx).max()))
