"""Tensor parallelism of the port against the JAX package, and its I/O.

  * the sharding rule (parallel/mesh.py::param_sharding_rules) shards, by
    name, exactly the leaves that samplenet_tpu.parallel.mesh.
    param_sharding_rules shards, for each model the port trains, at
    model = 2 and 4: the JAX rule is applied to the flax variables' shapes
    and carried to the port's names by the interop converters;
  * the vanilla classifier's logits on a 2 x 2 mesh of gloo ranks equal
    the JAX package's on make_mesh(model=2) over four CPU devices
    (tests/test_parallel.py:76-92, atol 2e-4, rtol 1e-4);
  * the mesh's layout: rank = data index * M + model index, the model
    group's all-gather in model-index order, the data group's all-reduce;
  * save_sharded of a 2 x 2 state (each sharded leaf a DTensor, Shard(0))
    restores bit for bit into the 2 x 2 mesh, into one process and into
    a 4 x 1 mesh;
  * the dry run's model axis follows __graft_entry__.py:72.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplenet_tpu_torch.parallel.launch import spawn
from samplenet_tpu_torch.parallel.mesh import Mesh, param_sharding_rules

torch.set_num_threads(1)

TIMEOUT = 180.0


def _jax_sharded(model, init_args, m: int, convert) -> set[str]:
    """The port names of the leaves that the JAX rule shards over a model
    axis of m (a mesh of four CPU devices)."""
    from jax.sharding import PartitionSpec as P

    from samplenet_tpu.parallel.mesh import make_mesh, param_sharding_rules

    rule = param_sharding_rules(make_mesh(model=m,
                                          devices=jax.devices()[:4]))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               *init_args))

    def marker(path, leaf):
        sharded = rule(path, leaf).spec != P()
        return np.full(leaf.shape, float(sharded), np.float32)

    sd = convert(jax.tree_util.tree_map_with_path(marker, dict(shapes)))
    return {k for k, v in sd.items() if np.size(v) and np.all(v == 1.0)}


def _models():
    """(name, flax model, init args, converter, port model) of each model
    the port trains, at its published widths; SampleNet also at the dry
    run's and the classification defaults' widths, where nothing is wide
    enough to shard."""
    from samplenet_tpu.models import SampleNet as JaxSampleNet
    from samplenet_tpu.models.autoencoder import PointNetAE as JaxAE
    from samplenet_tpu.models.pcrnet import PCRNet as JaxPCRNet
    from samplenet_tpu.models.pointnet_cls import (
        PointNetClassifier as JaxClassifier,
    )
    from samplenet_tpu_torch.interop.jax_import import (
        autoencoder_state_dict_from_jax,
        pcrnet_state_dict_from_jax,
        pointnet_state_dict_from_jax,
        samplenet_state_dict_from_jax,
    )
    from samplenet_tpu_torch.models import (
        PCRNet,
        PointNetAE,
        PointNetClassifier,
        SampleNet,
    )

    x = jnp.zeros((2, 512, 3))
    out = [
        ("classifier", JaxClassifier(40), (x, False),
         pointnet_state_dict_from_jax, PointNetClassifier(40)),
        ("classifier_tnets", JaxClassifier(40, use_tnets=True), (x, False),
         pointnet_state_dict_from_jax, PointNetClassifier(40, use_tnets=True)),
        ("pcrnet", JaxPCRNet(), (x, x), pcrnet_state_dict_from_jax,
         PCRNet()),
        ("ae", JaxAE(2048), (x, False), autoencoder_state_dict_from_jax,
         PointNetAE(2048)),
    ]
    for m, b in ((256, 512), (16, 64), (32, 128)):
        out.append((f"samplenet_m{m}_b{b}",
                    JaxSampleNet(num_out_points=m, bottleneck_size=b,
                                 group_size=8), (x, False),
                    samplenet_state_dict_from_jax,
                    SampleNet(m, b, group_size=8)))
    return out


MODELS = [m[0] for m in _models()]


@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("name", MODELS)
def test_rule_shards_the_leaves_jax_shards(name, m):
    _, jax_model, init_args, convert, port_model = next(
        t for t in _models() if t[0] == name)
    want = _jax_sharded(jax_model, init_args, m, convert)
    mesh = Mesh(group=None, rank=0, size=m, device=torch.device("cpu"),
                distributed=False, model=m)
    rule = param_sharding_rules(mesh)
    got = {k for k, v in port_model.state_dict().items()
           if rule(k, v) is not None}
    assert got == want
    wide = {"classifier": 12, "classifier_tnets": 38, "pcrnet": 10, "ae": 2,
            "samplenet_m256_b512": 8}
    assert len(got) == wide.get(name, 0), sorted(got)


# -------------------------------------------- the 2 x 2 ranks: JAX, the I/O

def _jax_classifier():
    """(variables, x, the JAX package's logits on a 2 x 2 mesh)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from samplenet_tpu.models.pointnet_cls import PointNetClassifier
    from samplenet_tpu.parallel.mesh import make_mesh, shard_params

    model = PointNetClassifier(num_classes=10)
    x = np.random.RandomState(1).randn(8, 64, 3).astype(np.float32)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(x[:2]), training=False)
    mesh = make_mesh(model=2, devices=jax.devices()[:4])
    with mesh:
        params = shard_params(mesh, v["params"])
        bs = shard_params(mesh, v["batch_stats"])
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
        out, _ = jax.jit(lambda p, b, x: model.apply(
            {"params": p, "batch_stats": b}, x, training=False))(
                params, bs, xs)
    return v, x, np.asarray(out)


def _ranks(mesh, sd, x, path):
    """One rank of 2 x 2: the layout, the JAX classifier's logits on its
    rows, then a trained vanilla classifier saved sharded and restored on
    this mesh and on a 4 x 1 mesh of the same ranks."""
    import torch.distributed as dist

    from samplenet_tpu_torch.models import PointNetClassifier
    from samplenet_tpu_torch.parallel.mesh import (
        all_gather,
        all_reduce_,
        data_parallel,
        full_state_dict,
        make_mesh,
        shard_batch,
        shard_params,
        sharded_state_dict,
    )
    from samplenet_tpu_torch.train import checkpoints, classification

    out = {"layout": (mesh.rank, mesh.data_rank, mesh.model_rank,
                      mesh.shape)}
    r = torch.tensor([float(mesh.rank)])
    out["model group"] = all_gather(r, mesh, 0).tolist()
    out["data group"] = float(all_reduce_(r.clone(), mesh))
    with pytest.raises(ValueError, match="mesh 3x2 != 4 ranks"):
        make_mesh(data=3, model=2)

    model = PointNetClassifier(10)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    shard_params(mesh, model)
    with torch.no_grad():
        out["logits"] = model(torch.from_numpy(shard_batch(mesh, x)))[0]

    cfg = classification.ClassifierConfig(num_classes=10, batch_size=8)
    model, state = classification.create_classifier_state(cfg, device="cpu")
    shard_params(mesh, data_parallel(state, mesh))
    y = torch.arange(8) % 10
    step = classification.make_classifier_train_step(model, cfg)
    step(state, *shard_batch(mesh, (torch.from_numpy(x), y)),
         torch.Generator().manual_seed(2), torch.Generator().manual_seed(3))
    checkpoints.save_sharded(path, {"model": sharded_state_dict(model),
                                    "step": torch.tensor(state.step)})
    out["saved"] = full_state_dict(model)

    again, _ = classification.create_classifier_state(cfg, device="cpu",
                                                      seed=9)
    shard_params(mesh, again)
    target = {"model": sharded_state_dict(again), "step": torch.tensor(0)}
    checkpoints.restore_sharded(path, target)
    out["restored 2x2"] = full_state_dict(again)
    out["step"] = int(target["step"])

    flat = make_mesh(model=1)                 # the same 4 ranks as 4 x 1
    whole, _ = classification.create_classifier_state(cfg, device="cpu",
                                                      seed=9)
    checkpoints.restore_sharded(path, {"model": whole.state_dict()})
    out["restored 4x1"] = (flat.shape, whole.state_dict())
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def jax_classifier():
    return _jax_classifier()


@pytest.fixture(scope="module")
def ranks(jax_classifier, tmp_path_factory):
    from samplenet_tpu_torch.interop.jax_import import (
        pointnet_state_dict_from_jax,
    )

    v, x, _ = jax_classifier
    path = str(tmp_path_factory.mktemp("tp") / "sharded")
    return path, spawn(_ranks, 4, pointnet_state_dict_from_jax(v), x, path,
                       model=2, timeout=TIMEOUT)


def test_mesh_layout(ranks):
    _, outs = ranks
    for r, out in enumerate(outs):
        d, m = divmod(r, 2)
        assert out["layout"] == (r, d, m, {"data": 2, "model": 2})
        assert out["model group"] == [2.0 * d, 2.0 * d + 1]
        assert out["data group"] == float(m + (m + 2))


def test_logits_match_the_jax_package_on_a_2x2_mesh(ranks, jax_classifier):
    _, _, want = jax_classifier
    _, outs = ranks
    for r, out in enumerate(outs):
        rows = slice((r // 2) * 4, (r // 2 + 1) * 4)
        np.testing.assert_allclose(out["logits"].numpy(), want[rows],
                                   atol=2e-4, rtol=1e-4)


def test_sharded_checkpoint_restores_on_the_mesh(ranks):
    _, outs = ranks
    for out in outs:
        assert out["step"] == 1
        for k, v in out["saved"].items():
            assert torch.equal(out["restored 2x2"][k], v), k


def test_sharded_checkpoint_restores_in_one_process(ranks):
    from samplenet_tpu_torch.train import checkpoints, classification

    path, outs = ranks
    cfg = classification.ClassifierConfig(num_classes=10, batch_size=8)
    model, _ = classification.create_classifier_state(cfg, device="cpu",
                                                      seed=9)
    target = {"model": model.state_dict(), "step": torch.tensor(0)}
    checkpoints.restore_sharded(path, target)
    assert int(target["step"]) == 1
    assert os.path.isdir(path)
    for k, v in outs[0]["saved"].items():
        assert torch.equal(model.state_dict()[k], v), k


def test_sharded_checkpoint_restores_on_a_4x1_mesh(ranks):
    _, outs = ranks
    for out in outs:
        shape, sd = out["restored 4x1"]
        assert shape == {"data": 4, "model": 1}
        for k, v in outs[0]["saved"].items():
            assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("n", range(1, 9))
def test_dryrun_model_axis_is_the_jax_dry_runs(n):
    from samplenet_tpu_torch.parallel.dryrun import model_axis

    assert model_axis(n) == (2 if n % 2 == 0 and n >= 4 else 1)
