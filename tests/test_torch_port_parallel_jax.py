"""Data parallelism of the port against the JAX package's on a mesh.

* The classification sampler step on 2 gloo ranks of the port against
  the JAX package's `make_samplenet_train_step` jitted over a 2-device
  ('data', 'model') mesh with the batch sharded P('data') (conftest gives
  8 virtual CPU devices), with JAX-initialised weights carried into the
  port by interop/jax_import.py and augmentation off (no generator gives
  both packages the same draws), at B = 16, N = 64. Tolerances and the
  parameters left out are those of test_torch_port_train_step.py: loss
  terms rtol 1e-5; gradients rtol 1e-3 with atol 1e-4 times the tensor's
  largest entry, the round-off gradients held below 1e-5 of the model's
  largest on both sides; running statistics rtol 1e-4 / atol 1e-6;
  updated parameters atol 1e-6 where JAX's gradient is resolved.
* The ghost chain where its block straddles the ranks: the JAX package
  picks the block from the global batch at trace time (B = 4, N = 128,
  widths (8, 16): block 4, where each half would pick 2), and GSPMD
  gathers the block across the two devices, so its result on the mesh is
  the single device's (checked here too). The port's 2 ranks must give
  it: the pooled features and the EMA statistics rtol 1e-5 / atol 1e-6,
  the gradients at the step's tolerance (rtol 1e-3, atol 1e-4 of the
  tensor's largest entry; f32 sums over 512 points).
* The input pipeline: each rank's rows of `global_batches` and its
  `host_shard` equal what the JAX package's process of that index feeds
  (its functions run here with the process count and index patched, and
  the array assembly replaced by the process-local rows it is given).

The ranks import this module, so it imports jax only inside the tests.
"""

import numpy as np
import pytest
import torch

from samplenet_tpu_torch.interop import (
    pointnet_state_dict_from_jax,
    samplenet_state_dict_from_jax,
)
from samplenet_tpu_torch.parallel import input_pipeline
from samplenet_tpu_torch.parallel.launch import spawn
from samplenet_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

B, N, W = 16, 64, 2
KW = dict(num_out_points=8, bottleneck_size=32, group_size=4, batch_size=B)
CANCELLED = {f"conv{i}.bias" for i in range(1, 6)} | {
    "bn5.bias", "fc1.bias", "fc2.bias", "fc3.bias"}
GHOST_B, GHOST_WIDTHS = 4, (8, 16)


def _sd(tree):
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


def _ghost_inputs():
    rng = np.random.RandomState(7)
    x = rng.randn(GHOST_B, 128, 3).astype(np.float32)
    ws, cin = [], 3
    for f in GHOST_WIDTHS:
        ws.append((rng.randn(cin, f) * 0.2).astype(np.float32))
        cin = f
    bs = [(0.1 * rng.randn(f)).astype(np.float32) for f in GHOST_WIDTHS]
    gm = [(1 + 0.2 * rng.randn(f)).astype(np.float32) for f in GHOST_WIDTHS]
    bt = [(0.2 * rng.randn(f)).astype(np.float32) for f in GHOST_WIDTHS]
    g = rng.randn(GHOST_B, GHOST_WIDTHS[-1]).astype(np.float32)
    return x, ws, bs, gm, bt, g


def _ranks(mesh, sampler_sd, classifier_sd, x, y):
    """One rank: the 2-rank sampler step and the straddling ghost chain."""
    from samplenet_tpu_torch.models import PointNetClassifier
    from samplenet_tpu_torch.ops.cuda.point_mlp_train_kernel import (
        auto_block_b,
        point_mlp_train_max,
    )
    from samplenet_tpu_torch.parallel.mesh import (
        all_reduce_,
        batch_blocks,
        data_parallel,
        global_mean,
        shard_batch,
    )
    from samplenet_tpu_torch.train.classification import (
        SampleNetConfig,
        create_samplenet_state,
        make_samplenet_train_step,
    )

    cfg = SampleNetConfig(**KW)
    port, state = create_samplenet_state(cfg, device="cpu")
    port.load_state_dict(sampler_sd)
    classifier = PointNetClassifier(4)
    classifier.load_state_dict(classifier_sd)
    data_parallel(state, mesh)
    step = make_samplenet_train_step(port, classifier, cfg,
                                     augment_data=False)
    xs, ys = shard_batch(mesh, (x, y))
    metrics = global_mean(step(state, xs, ys), mesh)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {k: p.grad.clone() for k, p in port.named_parameters()},
           "state": {k: v.clone() for k, v in port.state_dict().items()}}

    x, ws, bs, gm, bt, g = (torch.tensor(np.asarray(a)) if not
                            isinstance(a, list) else
                            [torch.tensor(t, requires_grad=True) for t in a]
                            for a in _ghost_inputs())
    xs = shard_batch(mesh, x).clone().requires_grad_(True)
    block_b = auto_block_b(len(x), x.shape[1], GHOST_WIDTHS, False)
    pooled, means, vars_ = point_mlp_train_max(
        xs, ws, [b.detach() for b in bs], gm, bt, bf16=False,
        blocks=batch_blocks(mesh, len(xs), block_b))
    (pooled * shard_batch(mesh, g)).sum().backward()
    out["ghost"] = {
        "pooled": pooled.detach(), "means": [m.clone() for m in means],
        "vars": [v.clone() for v in vars_], "dx": xs.grad,
        "dws": [all_reduce_(w.grad.clone(), mesh) for w in ws],
        "dgammas": [all_reduce_(t.grad.clone(), mesh) for t in gm],
        "dbetas": [all_reduce_(t.grad.clone(), mesh) for t in bt]}
    return out


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from samplenet_tpu.models.pointnet_cls import (
        PointNetClassifier as JaxPointNetClassifier,
    )
    from samplenet_tpu.models.pointnet_cls import (
        classification_loss as jax_classification_loss,
    )
    from samplenet_tpu.models.samplenet import SampleNet as JaxSampleNet
    from samplenet_tpu.ops.pallas.point_mlp_train_kernel import (
        point_mlp_train_max as jax_point_mlp_train_max,
    )
    from samplenet_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from samplenet_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from samplenet_tpu.train.classification import (
        SampleNetConfig as JaxSampleNetConfig,
    )
    from samplenet_tpu.train.classification import (
        create_samplenet_state as jax_create_samplenet_state,
    )
    from samplenet_tpu.train.classification import (
        make_samplenet_train_step as jax_make_samplenet_train_step,
    )

    rng = np.random.RandomState(0)
    x = rng.randn(B, N, 3).astype(np.float32)
    y = rng.randint(0, 4, B).astype(np.int32)
    cls = JaxPointNetClassifier(num_classes=4)
    cv = cls.init(jax.random.PRNGKey(1), jnp.asarray(x[:, :8]),
                  training=False)
    jcfg = JaxSampleNetConfig(**KW)
    sampler, state = jax_create_samplenet_state(jcfg, N,
                                                jax.random.PRNGKey(0))
    v0 = {"params": jax.tree.map(np.asarray, state.params),
          "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}

    def loss_fn(params, xs, ys):          # classification.py:199-218
        variables = {"params": params, "batch_stats": state.batch_stats}
        (simp, proj), _ = sampler.apply(variables, xs, training=True,
                                        mutable=["batch_stats"])
        logits, _ = cls.apply(cv, proj, training=False)
        return (jax_classification_loss(logits, ys)
                + 30.0 * sampler.apply(
                    variables, xs, simp, 8, 1.0, 0.0,
                    method=JaxSampleNet.get_simplification_loss)
                + sampler.apply(variables,
                                method=JaxSampleNet.get_projection_loss))

    mesh = jax_make_mesh(devices=jax.devices()[:W])
    rep = NamedSharding(mesh, P())
    put = lambda t: jax.tree_util.tree_map(    # noqa: E731
        lambda a: jax.device_put(a, rep) if hasattr(a, "shape") else a, t)
    jstep = jax_make_samplenet_train_step(sampler, cls, put(cv), jcfg,
                                          augment_data=False)
    with mesh:
        xs, ys = jax_shard_batch(mesh, (jnp.asarray(x), jnp.asarray(y)))
        mstate = state.replace(params=put(state.params),
                               batch_stats=put(state.batch_stats),
                               opt_state=put(state.opt_state))
        jgrads = jax.jit(jax.grad(loss_fn))(mstate.params, xs, ys)
        jnew, jm = jstep(mstate, xs, ys, jax.random.PRNGKey(2))

        gx, gws, gbs, ggm, gbt, gg = _ghost_inputs()

        def ghost(x, ws, gm, bt):
            return jax_point_mlp_train_max(x, tuple(ws), tuple(gbs),
                                           tuple(gm), tuple(bt), bf16=False,
                                           interpret=True)

        def ghost_loss(x, ws, gm, bt):
            return jnp.sum(ghost(x, ws, gm, bt)[0] * gg)

        gxs = jax_shard_batch(mesh, jnp.asarray(gx))
        jghost = jax.jit(ghost)(gxs, gws, ggm, gbt)
        jghost_grads = jax.jit(jax.grad(ghost_loss, argnums=(0, 1, 2, 3)))(
            gxs, gws, ggm, gbt)
    jghost_single = jax.jit(ghost)(jnp.asarray(gx), gws, ggm, gbt)

    ranks = spawn(_ranks, W, _sd(samplenet_state_dict_from_jax(v0)),
                  _sd(pointnet_state_dict_from_jax(
                      jax.tree.map(np.asarray, cv))),
                  torch.from_numpy(x), torch.from_numpy(y).long(),
                  timeout=120.0)
    jgsd = samplenet_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jgrads),
         "batch_stats": v0["batch_stats"]})
    jnewsd = samplenet_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jnew.params),
         "batch_stats": jax.tree.map(np.asarray, jnew.batch_stats)})
    return dict(jm=jm, jgrads=jgsd, jnew=jnewsd, ranks=ranks,
                jghost=jghost, jghost_grads=jghost_grads,
                jghost_single=jghost_single)


@pytest.mark.parametrize("rank", range(W))
def test_loss_terms_match_jax_on_a_mesh(setup, rank):
    got = setup["ranks"][rank]["metrics"]
    for k in ("loss", "task", "simplification", "projection", "acc"):
        np.testing.assert_allclose(got[k], float(setup["jm"][k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("rank", range(W))
def test_gradients_match_jax_on_a_mesh(setup, rank):
    jgrads = setup["jgrads"]
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, g in setup["ranks"][rank]["grads"].items():
        got, want = g.numpy(), jgrads[name]
        if name in CANCELLED:
            assert float(np.abs(got).max()) < 1e-5 * scale, name
            assert float(np.abs(want).max()) < 1e-5 * scale, name
            continue
        np.testing.assert_allclose(
            got, want, rtol=1e-3, atol=1e-4 * float(np.abs(want).max()),
            err_msg=name)


@pytest.mark.parametrize("rank", range(W))
def test_new_batch_stats_and_params_match_jax_on_a_mesh(setup, rank):
    for name, v in setup["ranks"][rank]["state"].items():
        if name.endswith("num_batches_tracked") or name in CANCELLED:
            continue
        want = setup["jnew"][name]
        if "running_" in name:
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-4,
                                       atol=1e-6, err_msg=name)
            continue
        g = np.abs(setup["jgrads"][name])
        resolved = g > 1e-4 * g.max()
        assert resolved.mean() > 0.9, name
        np.testing.assert_allclose(v.numpy()[resolved], want[resolved],
                                   atol=1e-6, err_msg=name)


def test_jax_ghost_block_straddling_devices_is_the_single_device_one(setup):
    import jax

    for a, b in zip(jax.tree.leaves(setup["jghost"]),
                    jax.tree.leaves(setup["jghost_single"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("rank", range(W))
def test_ghost_block_straddling_ranks_matches_jax(setup, rank):
    got = setup["ranks"][rank]["ghost"]
    pooled, means, vars_ = setup["jghost"]
    dx, dws, dgm, dbt = setup["jghost_grads"]
    rows = slice(rank * GHOST_B // W, (rank + 1) * GHOST_B // W)

    def close(a, b, err):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=err)

    def close_grad(a, b, err):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(b).max()),
                                   err_msg=err)

    close(got["pooled"], np.asarray(pooled)[rows], "pooled")
    close_grad(got["dx"], np.asarray(dx)[rows], "dx")
    for i in range(len(GHOST_WIDTHS)):
        close(got["means"][i], means[i], f"mean {i}")
        close(got["vars"][i], vars_[i], f"var {i}")
        close_grad(got["dws"][i], dws[i], f"dW {i}")
        close_grad(got["dgammas"][i], dgm[i], f"dgamma {i}")
        close_grad(got["dbetas"][i], dbt[i], f"dbeta {i}")


def _jax_process_rows(monkeypatch, rank, size, *args, **kwargs):
    """What the JAX package's process `rank` of `size` feeds as its rows
    of each global batch."""
    import jax

    from samplenet_tpu.parallel import input_pipeline as jax_pipeline
    from samplenet_tpu.parallel.mesh import make_mesh as jax_make_mesh

    monkeypatch.setattr(jax, "process_count", lambda: size)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "make_array_from_process_local_data",
                        lambda sharding, local: local)
    mesh = jax_make_mesh(devices=jax.devices()[:size])
    return list(jax_pipeline.global_batches(mesh, *args, **kwargs))


@pytest.mark.parametrize("size,shuffle", [(2, False), (2, True),
                                          (4, True)])
def test_global_batches_rows_are_the_jax_processes(monkeypatch, size,
                                                   shuffle):
    import jax

    from samplenet_tpu.parallel import input_pipeline as jax_pipeline

    rng = np.random.RandomState(1)
    total = 4 * 8 + 3                # a remainder host_shard drops
    data = rng.randn(total, 5, 3).astype(np.float32)
    labels = np.arange(total, dtype=np.int32)
    for rank in range(size):
        mesh = Mesh(group=None, rank=rank, size=size, device=torch.device(
            "cpu"), distributed=False)
        got = list(input_pipeline.global_batches(
            mesh, data, labels, 2 * size, shuffle=shuffle, seed=3))
        want = _jax_process_rows(monkeypatch, rank, size, data, labels,
                                 2 * size, shuffle=shuffle, seed=3)
        assert len(got) == len(want) > 1
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
        monkeypatch.setattr(jax, "process_count", lambda: size)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        for a, b in zip(input_pipeline.host_shard(data, labels, mesh),
                        jax_pipeline.host_shard(data, labels)):
            np.testing.assert_array_equal(a, b)
        monkeypatch.undo()
