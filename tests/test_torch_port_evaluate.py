"""The port's evaluation protocols (train/evaluate.py), EMD hard matching
and the evaluation CLI, against the JAX package on the CPU.

The same seeded numpy weights (JAX-initialised classifiers and a
classification-track SampleNet, their BN parameters and statistics moved
off their initial values) go through the JAX functions and, mapped by
`pointnet_state_dict_from_jax` and `samplenet_state_dict_from_jax`,
through the port's, on the same 10 clouds of 128 points (4 classes; the
sampler m = 16, bottleneck 32, k = 4, sigma = t^2).

Tolerances: accuracies, per-class accuracies, mean unique NN counts and
prefix accuracies exactly; the mean NLL rtol 1e-5; the FPS baseline's
points exactly and the random baseline's indices equal to JAX's draws;
the simplified and soft-projected clouds rtol 1e-4 / atol 1e-5 (as
tests/test_torch_port_progressive.py), hard-projected and matched points
exactly on clouds without a near-tie (1e-4 relative); EMD matching
indices equal wherever the best transport weight exceeds the second by
more than 1e-4 relative, and elsewhere (full points saturated at their
whole capacity tie) a pick whose JAX weight is within 1e-4 of the best.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from samplenet_tpu.data.modelnet import load_h5 as jax_load_h5
from samplenet_tpu.models.pointnet_cls import (
    PointNetClassifier as JaxPointNetClassifier,
)
from samplenet_tpu.models.samplenet import SampleNet as JaxSampleNet
from samplenet_tpu.ops import matching as jax_matching
from samplenet_tpu.train import evaluate as je
from samplenet_tpu.train.state import TrainState as JaxTrainState
from samplenet_tpu_torch.interop import (
    pointnet_state_dict_from_jax,
    samplenet_state_dict_from_jax,
)
from samplenet_tpu_torch.models import PointNetClassifier, SampleNet
from samplenet_tpu_torch.ops import matching
from samplenet_tpu_torch.train import evaluate as pe
from samplenet_tpu_torch.train import (
    evaluate_cli,
    train_classifier,
    train_progressive,
    train_samplenet,
)
from tests.test_torch_port_samplenet import _near_tie

torch.set_num_threads(1)

N, M, CLASSES = 128, 16, 4
SAMPLER = dict(num_out_points=M, bottleneck_size=32, group_size=4,
               sigma_mode="tf")


def _sd(tree):
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


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
    return jax.tree_util.tree_map_with_path(
        f, jax.tree.map(np.asarray, variables))


@pytest.fixture(scope="module")
def nets():
    out = {}
    for name, use_tnets in (("vanilla", False), ("tnet", True)):
        jc = JaxPointNetClassifier(num_classes=CLASSES, use_tnets=use_tnets)
        cv = _perturb(jc.init(jax.random.PRNGKey(1), jnp.zeros((2, N, 3)),
                              training=False), 2)
        pc = PointNetClassifier(CLASSES, use_tnets=use_tnets)
        pc.load_state_dict(_sd(pointnet_state_dict_from_jax(cv)))
        out[name] = (jc, cv, pc)
    js = JaxSampleNet(**SAMPLER)
    sv = _perturb(js.init(jax.random.PRNGKey(0), jnp.zeros((2, N, 3)),
                          training=False), 3)
    ps = SampleNet(**SAMPLER)
    ps.load_state_dict(_sd(samplenet_state_dict_from_jax(sv)))
    rs = np.random.RandomState(0)
    data = rs.randn(10, N, 3).astype(np.float32)
    labels = rs.randint(0, CLASSES, 10).astype(np.int32)
    return dict(cls=out, js=js, sv=sv, ps=ps, data=data, labels=labels)


@pytest.mark.parametrize("variant", ["vanilla", "tnet"])
def test_voting_matches_jax(nets, variant):
    jc, cv, pc = nets["cls"][variant]
    data, labels = nets["data"], nets["labels"]
    want = je.evaluate_classifier_voting(jc, cv, data, labels, 4,
                                         num_votes=3)
    for bs in (4, 3):
        got = pe.evaluate_classifier_voting(pc, data, labels, bs, 3,
                                            device="cpu")
        assert got["accuracy"] == want["accuracy"]
        np.testing.assert_array_equal(got["per_class_accuracy"],
                                      want["per_class_accuracy"])


@pytest.mark.parametrize("matching_,match_output", [
    ("nn", True), ("nn", False), ("emd", True)])
def test_matched_eval_matches_jax(nets, matching_, match_output):
    jc, cv, pc = nets["cls"]["vanilla"]
    data, labels = nets["data"], nets["labels"]
    want = je.evaluate_samplenet_matched(
        nets["js"], nets["sv"], jc, cv, data, labels, 4,
        match_output=match_output, matching=matching_)
    reports = [pe.evaluate_samplenet_matched(
        nets["ps"], pc, data, labels, bs, match_output=match_output,
        matching=matching_, device="cpu") for bs in (4, 3, 10)]
    for got in reports:
        assert got["accuracy"] == want["accuracy"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["mean_unique_nn"] == want["mean_unique_nn"]
        np.testing.assert_array_equal(got["per_class_accuracy"],
                                      want["per_class_accuracy"])
        assert got["sampled"].shape == (10, M, 3)
        np.testing.assert_array_equal(got["sampled"],
                                      reports[0]["sampled"])
    r = reports[0]
    np.testing.assert_allclose(r["nll"].mean(), r["loss"], rtol=1e-6)
    assert r["correct"].mean() == r["accuracy"]
    assert r["unique_nn"].mean() == r["mean_unique_nn"]


def test_matched_eval_refuses_another_matching(nets):
    with pytest.raises(ValueError, match="matching"):
        pe.evaluate_samplenet_matched(nets["ps"], nets["cls"]["vanilla"][2],
                                      nets["data"], nets["labels"], 4,
                                      matching="knn", device="cpu")


@pytest.mark.parametrize("sampler", ["fps", "random"])
def test_baseline_matches_jax(nets, sampler):
    jc, cv, pc = nets["cls"]["tnet"]
    data, labels = nets["data"], nets["labels"]
    want = je.evaluate_baseline_sampler(jc, cv, data, labels, 3, M,
                                        sampler=sampler, seed=5)
    got = pe.evaluate_baseline_sampler(pc, data, labels, 3, M,
                                       sampler=sampler, seed=5, device="cpu")
    assert got["accuracy"] == want["accuracy"]
    assert (got["sampler"], got["m"]) == (sampler, M)
    if sampler == "fps":
        from samplenet_tpu.ops.fps import farthest_point_sample_with_points

        pts = np.asarray(farthest_point_sample_with_points(
            M, jnp.asarray(data))[1])
    else:        # JAX's draws: one RandomState across the padded batches
        rng = np.random.RandomState(5)
        idx = np.concatenate([np.stack(
            [rng.choice(N, M, replace=False) for _ in range(3)])
            for _ in range(4)])[:10]
        pts = np.take_along_axis(data, idx[..., None], axis=1)
    np.testing.assert_array_equal(got["sampled"], pts)


def test_baseline_refuses_another_sampler(nets):
    with pytest.raises(ValueError, match="baseline sampler"):
        pe.evaluate_baseline_sampler(nets["cls"]["vanilla"][2], nets["data"],
                                     nets["labels"], 4, M, sampler="grid",
                                     device="cpu")


def test_emd_matching_matches_jax():
    rs = np.random.RandomState(7)
    full = rs.randn(6, 96, 3).astype(np.float32)
    simp = rs.randn(6, 12, 3).astype(np.float32) * 0.8
    want = np.asarray(jax_matching.emd_matching(jnp.asarray(full),
                                                jnp.asarray(simp)))
    match = np.asarray(jax_matching.approx_match(jnp.asarray(full),
                                                 jnp.asarray(simp)))
    top2 = np.sort(match, axis=1)[:, -2:]                     # [B, 2, m]
    clear = top2[:, 1] - top2[:, 0] > 1e-4 * top2[:, 1]       # [B, m]
    # saturated full points tie at their whole capacity
    assert clear.mean() > 0.4
    idx = matching.emd_match_indices(torch.from_numpy(full),
                                     torch.from_numpy(simp)).numpy()
    np.testing.assert_array_equal(idx[clear], match.argmax(1)[clear])
    # elsewhere the port's pick is one of JAX's tied best
    picked = np.take_along_axis(match, idx[:, None].astype(np.int64), 1)
    assert (picked[:, 0] >= (1 - 1e-4) * top2[:, 1]).all()
    got = matching.emd_matching(torch.from_numpy(full),
                                torch.from_numpy(simp)).numpy()
    np.testing.assert_array_equal(got[clear], want[clear])
    # the full-cloud axis: the indices reach past the first m points
    assert idx.max() >= 12


def _state(nets):
    return JaxTrainState.create(params=nets["sv"]["params"],
                                batch_stats=nets["sv"]["batch_stats"],
                                tx=optax.identity())


def test_infer_ordered_and_dumps_match_jax(nets, tmp_path):
    pytest.importorskip("h5py")
    data, labels = nets["data"], nets["labels"]
    paths = je.infer_and_dump(nets["js"], _state(nets), data, labels,
                              str(tmp_path / "jax"), num_out_points=M,
                              batch_size=4)
    outs, kept = pe.infer_ordered(nets["ps"], data, labels,
                                  num_out_points=M, batch_size=3,
                                  device="cpu")
    np.testing.assert_array_equal(kept, labels)
    want = {k: jax_load_h5(p)[0] for k, p in paths.items()}
    for k in ("simplified", "soft_projected"):
        np.testing.assert_allclose(outs[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    _, midx = jax_matching.nn_match_from_clouds(
        jnp.asarray(data), jnp.asarray(outs["simplified"]), M)
    clear = ~_near_tie(data, outs["simplified"], np.asarray(midx), M)
    assert clear.sum() >= 8
    for k in ("hard_projected", "sampled"):
        np.testing.assert_array_equal(outs[k][clear], want[k][clear],
                                      err_msg=k)
    mine = pe.infer_and_dump(nets["ps"], data, labels, str(tmp_path / "port"),
                             num_out_points=M, batch_size=4, device="cpu")
    assert sorted(mine) == sorted(pe.DUMP_TREES)
    for k, p in mine.items():
        d, lab = jax_load_h5(p)
        np.testing.assert_array_equal(d, outs[k])
        np.testing.assert_array_equal(lab, labels)


def test_prefix_accuracy_and_from_files_match_jax(nets, tmp_path):
    pytest.importorskip("h5py")
    jc, cv, pc = nets["cls"]["vanilla"]
    data, labels = nets["data"], nets["labels"]
    outs, kept = pe.infer_ordered(nets["ps"], data, labels,
                                  num_out_points=M, batch_size=4,
                                  device="cpu")
    paths = pe.write_dumps(str(tmp_path), outs, kept)
    sizes = [4, 8, 16]
    want = je.evaluate_from_files(jc, cv, paths["sampled"], sizes,
                                  batch_size=4)
    assert pe.evaluate_from_files(pc, paths["sampled"], sizes, 3,
                                  device="cpu") == want
    assert pe.evaluate_prefix_accuracy(pc, outs["sampled"], kept, sizes, 4,
                                       device="cpu") == want


# ------------------------------------------------------------ the CLIs

COMMON = ["--device", "cpu", "--num-points", "128", "--train-size", "16",
          "--test-size", "6", "--batch-size", "4"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """train_classifier --use-tnets, then train_samplenet and
    train_progressive against its checkpoint."""
    log = tmp_path_factory.mktemp("cli")
    train = COMMON + ["--epochs", "1", "--steps-per-epoch", "2"]
    train_classifier.main(train + ["--use-tnets", "--log-dir",
                                   str(log / "cls")])
    cls = str(log / "cls" / "ckpt")
    train_samplenet.main(train + ["--num-out-points", "8",
                                  "--classifier-ckpt", cls,
                                  "--log-dir", str(log / "sn")])
    train_progressive.main(train + ["--max-num-out-points", "16",
                                    "--classifier-ckpt", cls,
                                    "--log-dir", str(log / "prog")])
    return log


def _eval(mode, log, *extra):
    return evaluate_cli.main([mode, *COMMON, "--log-dir", str(log / "eval"),
                              *extra])


@pytest.mark.parametrize("extra", [
    ["--num-votes", "2"], ["--matching", "nn"], ["--matching", "emd"],
    ["--sampler", "fps"], ["--sampler", "random"]],
    ids=["classifier", "samplenet-nn", "samplenet-emd", "baseline-fps",
         "baseline-random"])
def test_evaluate_cli_modes(ckpts, extra, capsys):
    cls = str(ckpts / "cls" / "ckpt")
    if "--num-votes" in extra:
        report = _eval("classifier", ckpts, "--ckpt", cls, *extra)
        assert "voting accuracy (2 votes)" in capsys.readouterr().out
    elif "--matching" in extra:
        report = _eval("samplenet", ckpts, "--ckpt", str(ckpts / "sn/ckpt"),
                       "--classifier-ckpt", cls, *extra)
        assert f"matched accuracy@8 ({extra[1]} matching)" in \
            capsys.readouterr().out
        assert report["sampled"].shape == (6, 8, 3)
    else:
        report = _eval("baseline", ckpts, "--classifier-ckpt", cls,
                       "--num-out-points", "8", *extra)
        assert report["sampled"].shape == (6, 8, 3)
    assert 0.0 <= report["accuracy"] <= 1.0


def test_evaluate_cli_infer_then_from_files(ckpts, capsys):
    pytest.importorskip("h5py")
    paths = _eval("infer", ckpts, "--ckpt", str(ckpts / "prog/ckpt"),
                  "--out-dir", str(ckpts / "dumps"))
    assert sorted(paths) == sorted(pe.DUMP_TREES)
    assert jax_load_h5(paths["sampled"])[0].shape == (6, 16, 3)
    accs = _eval("from-files", ckpts, "--dump", paths["sampled"],
                 "--classifier-ckpt", str(ckpts / "cls" / "ckpt"),
                 "--sizes", "4", "16")
    assert sorted(accs) == [4, 16]
    assert "prefix 16: accuracy=" in capsys.readouterr().out


def test_evaluate_cli_infer_needs_a_progressive_checkpoint(ckpts):
    with pytest.raises(KeyError, match="max_num_out_points"):
        _eval("infer", ckpts, "--ckpt", str(ckpts / "sn/ckpt"))


def test_evaluate_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_cli.main(["classifier", "--log-dir", str(tmp_path)])


@pytest.mark.parametrize("cli", [train_samplenet, train_progressive])
def test_train_clis_take_exactly_one_classifier(ckpts, cli):
    cls = str(ckpts / "cls" / "ckpt")
    with pytest.raises(SystemExit):
        cli.main(COMMON)
    with pytest.raises(SystemExit):
        cli.main(COMMON + ["--classifier-ckpt", cls,
                           "--classifier-weights", cls])


def test_classifier_weights_take_a_tnet_state_dict(ckpts, tmp_path):
    """--classifier-weights reads the variant off the state_dict's keys."""
    state = train_samplenet.main(
        COMMON + ["--epochs", "1", "--steps-per-epoch", "1",
                  "--num-out-points", "8", "--classifier-weights",
                  str(ckpts / "cls" / "ckpt" / "classifier.pth"),
                  "--log-dir", str(tmp_path)])
    assert state.step == 1
