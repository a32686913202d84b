"""The port's host modules against the JAX package's, on the CPU.

  * runtime/: the port's own build of the native loader (g++ at first
    use) against samplenet_tpu.runtime on the same data and seed: equal
    batches with one worker, with and without augmentation, and equal
    sets of clouds with two; `load_ply_native` against the JAX function
    and against plyio on binary and ascii files; data/shapenet.py's
    load_point_clouds (the native parser) against the JAX one;
  * data/ingest.py: the manifests of a synthetic ModelNet40 and ShapeNet
    tree, written by the test, equal the JAX module's;
  * utils/args.py and utils/config.py, as tests/test_evaluate.py:119-130
    and :300-320 hold the JAX modules, and a Configuration file written by
    either package read by the other;
  * no module under samplenet_tpu_torch/ops imports samplenet_tpu_torch.
    parallel (the kernel wrappers take a reducer, not a mesh).
"""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest

from samplenet_tpu import runtime as jax_runtime
from samplenet_tpu_torch import runtime
from samplenet_tpu_torch.data.plyio import load_ply, save_ply

PKG = Path(runtime.__file__).resolve().parents[1]


def test_the_loader_builds_into_the_checkout():
    assert runtime.native_available()
    path = runtime.loader.library_path()
    assert path.exists()
    assert path.parents[1] == PKG.parent / "build" / "native"


@pytest.mark.parametrize("binary", [True, False])
def test_load_ply_native_matches_jax_and_plyio(tmp_path, binary):
    pts = np.random.RandomState(0).randn(200, 3).astype(np.float32)
    path = str(tmp_path / "t.ply")
    save_ply(path, pts, binary=binary)
    got = runtime.load_ply_native(path)
    assert got.shape == (200, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_runtime.load_ply_native(path))
    np.testing.assert_array_equal(got, load_ply(path)[:, :3])


def test_load_ply_native_refuses_what_it_cannot_read(tmp_path):
    path = tmp_path / "bad.ply"
    path.write_bytes(b"ply\nformat ascii 1.0\nend_header\n")
    with pytest.raises(ValueError, match="failed to parse"):
        runtime.load_ply_native(str(path))


def _epoch(loader_cls, data, labels, batch, **kw):
    with loader_cls(data, labels, batch, **kw) as it:
        return it.epoch_batches, list(it)


@pytest.mark.parametrize("augment", [False, True])
def test_native_loader_batches_equal_jax(augment):
    rng = np.random.RandomState(1)
    data = rng.randn(40, 64, 3).astype(np.float32)
    labels = (np.arange(40) % 7).astype(np.int32)
    kw = dict(augment=augment, seed=3, num_workers=1)
    n, got = _epoch(runtime.NativeLoader, data, labels, 8, **kw)
    m, want = _epoch(jax_runtime.NativeLoader, data, labels, 8, **kw)
    assert n == m == len(got) == len(want) == 5
    for (gp, gl), (wp, wl) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gl, wl)
    if not augment:
        lookup = {data[i].tobytes(): labels[i] for i in range(40)}
        assert all(lookup[c.tobytes()] == lab
                   for p, ls in got for c, lab in zip(p, ls))


def test_native_loader_workers_share_one_epoch():
    """With two workers the batches race into the queue: the epoch holds
    the JAX loader's clouds, in some order."""
    data = np.random.RandomState(2).randn(48, 16, 3).astype(np.float32)
    kw = dict(augment=False, seed=5, num_workers=2)
    _, got = _epoch(runtime.NativeLoader, data, None, 8, **kw)
    _, want = _epoch(jax_runtime.NativeLoader, data, None, 8, **kw)
    assert sorted(p.tobytes() for p, _ in got) == \
        sorted(p.tobytes() for p, _ in want)


def test_load_point_clouds_is_the_native_parser(tmp_path):
    from samplenet_tpu.data.shapenet import (
        load_point_clouds as jax_load_point_clouds,
    )
    from samplenet_tpu_torch.data.shapenet import load_point_clouds

    rng = np.random.RandomState(3)
    files = []
    for i in range(5):
        files.append(str(tmp_path / f"c{i}.ply"))
        save_ply(files[-1], rng.randn(50, 3), binary=i % 2 == 0)
    got = load_point_clouds(files, num_points=40, threads=2)
    assert got.shape == (5, 40, 3)
    np.testing.assert_array_equal(
        got, jax_load_point_clouds(files, num_points=40, threads=2))


# ---------------------------------------------------------------- ingest

def _modelnet_tree(root: Path, rng) -> None:
    from samplenet_tpu_torch.data.modelnet import save_h5

    d = root / "modelnet40_ply_hdf5_2048"
    d.mkdir(parents=True)
    for split, shards in (("train", 2), ("test", 1)):
        names = []
        for i in range(shards):
            name = f"ply_data_{split}{i}.h5"
            save_h5(str(d / name), rng.randn(3, 2048, 3).astype(np.float32),
                    rng.randint(0, 40, (3, 1)).astype(np.uint8))
            names.append(f"data/modelnet40_ply_hdf5_2048/{name}")
        (d / f"{split}_files.txt").write_text("\n".join(names) + "\n")


def test_ingest_modelnet40_manifest_equals_jax(tmp_path):
    from samplenet_tpu.data import ingest as jax_ingest
    from samplenet_tpu_torch.data import ingest

    _modelnet_tree(tmp_path, np.random.RandomState(4))
    want = jax_ingest.validate_modelnet40(str(tmp_path))
    got = ingest.validate_modelnet40(str(tmp_path))
    assert got == want
    assert got["splits"] == {"train": 6, "test": 3}
    assert got["official_counts"] is False
    with open(os.path.join(got["root"], ingest.MANIFEST)) as f:
        assert json.load(f) == want
    with pytest.raises(ValueError, match="official split"):
        ingest.validate_modelnet40(str(tmp_path), strict=True)


def test_ingest_modelnet40_refuses_a_wrong_tree(tmp_path):
    from samplenet_tpu_torch.data import ingest
    from samplenet_tpu_torch.data.modelnet import save_h5

    with pytest.raises(FileNotFoundError, match="no download"):
        ingest.validate_modelnet40(str(tmp_path))
    _modelnet_tree(tmp_path, np.random.RandomState(5))
    bad = tmp_path / "modelnet40_ply_hdf5_2048" / "ply_data_test0.h5"
    save_h5(str(bad), np.zeros((2, 1024, 3), np.float32),
            np.zeros((2, 1), np.uint8))
    with pytest.raises(ValueError, match="2048 points"):
        ingest.validate_modelnet40(str(tmp_path))


def test_ingest_shapenet_manifest_equals_jax(tmp_path):
    from samplenet_tpu.data import ingest as jax_ingest
    from samplenet_tpu_torch.data import ingest

    rng = np.random.RandomState(6)
    for syn, n in (("02691156", 3), ("03001627", 2)):
        (tmp_path / syn).mkdir()
        for i in range(n):
            save_ply(str(tmp_path / syn / f"{i}.ply"),
                     rng.randn(64 + 8 * (i % 2), 3), binary=i % 2 == 0)
    want = jax_ingest.validate_shapenet(str(tmp_path))
    got = ingest.validate_shapenet(str(tmp_path))
    assert got == want
    assert set(got["classes"]) == {"airplane", "chair"}
    assert got["classes"]["airplane"]["uniform_points"] is False
    assert ingest.main(["shapenet", "--data-dir", str(tmp_path)]) == want
    with pytest.raises(FileNotFoundError, match="no ShapeNet synset"):
        ingest.validate_shapenet(str(tmp_path / "02691156"))


# --------------------------------------------------------- args, config

def test_parser_defaults_match_jax():
    from samplenet_tpu.utils.args import get_parser as jax_get_parser
    from samplenet_tpu_torch.utils.args import get_parser

    args = get_parser().parse_args([])
    assert args.num_in_points == 1024
    assert args.num_out_points == 64
    assert args.bottleneck_size == 128
    assert args.alpha == 0.01 and args.lmbda == 0.01
    assert args.gamma == 1.0 and args.delta == 0.0
    assert args.group_size == 8
    assert vars(args) == vars(jax_get_parser().parse_args([]))


@pytest.mark.parametrize("argv", [
    ["--projection-group-size", "16"], ["--group-size", "4"],
    ["--skip-projection", "--num-out-points", "32", "--alpha", "30",
     "--lmbda", "1", "--bottleneck-size", "256", "--delta", "0.5"]])
def test_parser_flags_and_aliases_match_jax(argv):
    from samplenet_tpu.utils.args import get_parser as jax_get_parser
    from samplenet_tpu_torch.utils.args import get_parser

    assert vars(get_parser().parse_args(argv)) == \
        vars(jax_get_parser().parse_args(argv))


def test_add_sampler_args_takes_track_defaults():
    import argparse

    from samplenet_tpu.utils.args import add_sampler_args as jax_add
    from samplenet_tpu_torch.utils.args import add_sampler_args

    kw = dict(num_out_points=32, group_size=7, alpha=30.0, lmbda=1.0,
              gamma=2.0, delta=0.1)
    got = add_sampler_args(argparse.ArgumentParser(), **kw).parse_args([])
    want = jax_add(argparse.ArgumentParser(), **kw).parse_args([])
    assert vars(got) == vars(want)
    assert (got.num_out_points, got.group_size) == (32, 7)


def test_configuration_round_trip_and_jax_format(tmp_path):
    from samplenet_tpu.utils.config import Configuration as JaxConfiguration
    from samplenet_tpu_torch.utils.config import Configuration

    c = Configuration(batch_size=50, loss="chamfer", alpha=0.01)
    c.extra = [1, 2, 3]
    path = c.save(str(tmp_path))
    c2 = Configuration.load(str(tmp_path))
    assert c2.batch_size == 50 and c2.loss == "chamfer"
    assert c2.extra == [1, 2, 3]
    assert c2.exists_and_is_not_none("alpha")
    assert not c2.exists_and_is_not_none("missing")
    assert "loss" in c2 and "missing" not in c2
    with pytest.raises(AttributeError):
        c2.missing
    j = JaxConfiguration(batch_size=50, loss="chamfer", alpha=0.01)
    j.extra = [1, 2, 3]
    jpath = j.save(str(tmp_path), name="jax")
    assert Path(path).read_text() == Path(jpath).read_text()
    assert Configuration.load(str(tmp_path), "jax").as_dict() == c.as_dict()
    assert JaxConfiguration.load(str(tmp_path)).as_dict() == c.as_dict()
    assert repr(c2) == repr(j) == "Configuration(alpha, batch_size, extra, " \
        "loss)"
    assert c2.update(alpha=0.5) is c2 and c2.alpha == 0.5


# ------------------------------------------------------------- layering

def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_ops_import_nothing_of_parallel():
    files = sorted((PKG / "ops").rglob("*.py"))
    assert any(f.name == "point_mlp_train_kernel.py" for f in files)
    for f in files:
        bad = {m for m in _imports(f)
               if m.startswith("samplenet_tpu_torch.parallel")}
        assert not bad, (f, bad)
