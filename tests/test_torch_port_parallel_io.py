"""Data parallelism of the port: the sharded checkpoint, the input
pipeline across ranks, the dry run, the `--data-parallel` CLIs, the mesh
and the launcher.

* `save_sharded` from 4 gloo ranks after a classification sampler step,
  `restore_sharded` in 2 ranks and in this process (a world of one, no
  process group): every tensor back bit for bit, then one more step.
* `global_batches(process_local=True)` on 4 ranks holding 4, 5, 6 and 7
  rows at a local batch of 2 stops every rank at min(2, 2, 3, 3) = 2
  batches (JAX tests/test_parallel.py::test_uneven_host_data_counts),
  each yielding its own rows.
* `dryrun_multichip` on 2 and 4 ranks: every track finite, every rank
  reporting the same global values.
* `train_classifier --data-parallel` and `train_samplenet
  --data-parallel` in a 2-rank gloo group on the CPU against the same
  runs in one process without the flag, one step each, at the tolerances
  of test_torch_port_train_step.py: the logged metrics (losses rtol 1e-5;
  the accuracies exactly, they are integer counts), the gradients (rtol
  1e-3, atol 1e-4 of the tensor's largest entry) and the published
  checkpoints (running statistics rtol 1e-4 / atol 1e-6, parameters atol
  1e-6 where the gradient is resolved, above 1e-4 of its tensor's
  largest entry, leaving out those whose gradient is zero in exact
  arithmetic, whose round-off Adam's first step turns into +-lr), and
  only rank 0 writing. One step: from the second on, the +-lr of the
  round-off elements moves the losses past rtol 1e-5 in float32.
"""

import json
import math
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from samplenet_tpu_torch.models import PointNetClassifier
from samplenet_tpu_torch.parallel import dryrun
from samplenet_tpu_torch.parallel.input_pipeline import global_batches
from samplenet_tpu_torch.parallel.launch import spawn
from samplenet_tpu_torch.parallel.mesh import (
    batch_rows,
    data_parallel,
    initialize_distributed,
    make_mesh,
    replicated,
    shard_batch,
)
from samplenet_tpu_torch.train import (
    checkpoints,
    train_classifier,
    train_samplenet,
)
from samplenet_tpu_torch.train.classification import (
    SampleNetConfig,
    create_samplenet_state,
    make_samplenet_train_step,
)

torch.set_num_threads(1)

B, N = 8, 64
CFG = dict(num_out_points=8, bottleneck_size=32, group_size=4, batch_size=B)
# parameters whose gradient is zero in exact arithmetic
SAMPLER_CANCELLED = {f"conv{i}.bias" for i in range(1, 6)} | {
    "bn5.bias", "fc1.bias", "fc2.bias", "fc3.bias"}
CLASSIFIER_CANCELLED = {f"conv{i}.bias" for i in range(1, 6)} | {
    "bn5.bias", "fc1.bias", "fc2.bias"}


def _sampler_step(mesh, state, sampler, seed):
    classifier = PointNetClassifier(
        4, generator=torch.Generator().manual_seed(1))
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, 3).astype(np.float32)
    y = rng.randint(0, 4, B).astype(np.int64)
    xs, ys = (torch.from_numpy(a) for a in shard_batch(mesh, (x, y)))
    step = make_samplenet_train_step(sampler, classifier,
                                     SampleNetConfig(**CFG))
    return step(state, xs, ys, torch.Generator().manual_seed(seed))


def _tree(sampler, state):
    return {"model": sampler.state_dict(),
            "step": torch.tensor(state.step)}


def _save_group(mesh, path):
    """4 ranks: a step, then save_sharded; and the uneven pipeline."""
    sampler, state = create_samplenet_state(SampleNetConfig(**CFG),
                                            device="cpu")
    data_parallel(state, mesh)
    _sampler_step(mesh, state, sampler, 0)
    checkpoints.save_sharded(path, _tree(sampler, state))
    saved = {k: v.clone() for k, v in sampler.state_dict().items()}

    local_batch = 2
    rows = 2 * local_batch + mesh.rank          # 4, 5, 6, 7
    data = (1000.0 * mesh.rank + np.arange(rows * 4 * 3, dtype=np.float32)
            ).reshape(rows, 4, 3)
    labels = np.arange(rows, dtype=np.int32) + 100 * mesh.rank
    batches = list(global_batches(mesh, data, labels,
                                  local_batch * mesh.size, shuffle=False,
                                  process_local=True))
    return {"saved": saved, "batches": batches, "data": data,
            "labels": labels}


def _restore(mesh, path):
    sampler, state = create_samplenet_state(SampleNetConfig(**CFG),
                                            device="cpu", seed=9)
    target = _tree(sampler, state)
    checkpoints.restore_sharded(path, target)
    state.step = int(target["step"])
    restored = {k: v.clone() for k, v in sampler.state_dict().items()}
    if mesh is not None:
        replicated(mesh, sampler, check=True)
        data_parallel(state, mesh)
    metrics = _sampler_step(mesh, state, sampler, 1)
    return {"restored": restored, "loss": float(metrics["loss"]),
            "step": state.step}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sharded") / "ckpt")
    return path, spawn(_save_group, 4, path, timeout=120.0)


def test_sharded_checkpoint_written_by_every_rank(saved):
    path, ranks = saved
    assert sorted(f for f in os.listdir(path) if f.endswith(".distcp")) \
        == [f"__{r}_0.distcp" for r in range(4)]
    for out in ranks[1:]:              # the ranks held equal parameters
        for k, v in out["saved"].items():
            assert torch.equal(v, ranks[0]["saved"][k]), k


def test_sharded_checkpoint_restores_in_two_ranks(saved):
    path, ranks = saved
    for out in spawn(_restore, 2, path, timeout=120.0):
        for k, v in ranks[0]["saved"].items():
            assert torch.equal(out["restored"][k], v), k
        assert out["step"] == 2 and math.isfinite(out["loss"])


def test_sharded_checkpoint_restores_in_one_process(saved):
    path, ranks = saved
    out = _restore(None, path)
    for k, v in ranks[0]["saved"].items():
        assert torch.equal(out["restored"][k], v), k
    assert out["step"] == 2 and math.isfinite(out["loss"])


def test_uneven_process_local_data_stops_at_the_minimum(saved):
    _, ranks = saved
    for out in ranks:
        assert len(out["batches"]) == 2           # min(2, 2, 3, 3)
        for i, (bx, by) in enumerate(out["batches"]):
            np.testing.assert_array_equal(bx, out["data"][2 * i:2 * i + 2])
            np.testing.assert_array_equal(by, out["labels"][2 * i:2 * i + 2])


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, capsys):
    results = dryrun.dryrun_multichip(n, "cpu", timeout=120.0)
    assert set(results) == {"classification", "eval_fwd",
                            "eval_matching_m144", "registration",
                            "reconstruction", "progressive"}
    assert all(math.isfinite(v) for v in results.values())
    out = capsys.readouterr().out
    assert f"dryrun_multichip({n}): mesh={{'data': {n}, 'model': 1}}" in out


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch):
    """The CLI and the function default to the card: without one they
    raise before spawning a rank, and fall back to nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        dryrun.main(["2"])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        dryrun.dryrun_multichip(2)


# ----------------------------------------------------------------- the CLIs

def _argv(log_dir, cls_weights=None):
    common = ["--device", "cpu", "--epochs", "1", "--steps-per-epoch", "1",
              "--num-points", "128", "--train-size", "16", "--test-size",
              "6", "--batch-size", "4", "--log-dir", log_dir]
    if cls_weights is None:
        return common
    return common + ["--num-out-points", "8", "--classifier-weights",
                     cls_weights]


def _grads(state):
    """The last step's gradients, left on the parameters."""
    return {k: p.grad.clone() for k, p in state.model.named_parameters()
            if p.grad is not None}


def _clis(mesh, root, cls_weights):
    log = os.path.join(root, f"dp_rank{mesh.rank}" if mesh.rank else "dp")
    cls = train_classifier.main(_argv(os.path.join(log, "cls")) +
                                ["--data-parallel"])
    sn = train_samplenet.main(_argv(os.path.join(log, "sn"), cls_weights) +
                              ["--data-parallel"])
    return {"cls": _grads(cls), "sn": _grads(sn)}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cls_weights = str(root / "classifier.pth")
    torch.save(PointNetClassifier(24, generator=torch.Generator()
                                  .manual_seed(4)).state_dict(), cls_weights)
    ranks = spawn(_clis, 2, str(root), cls_weights, timeout=120.0)
    one = {"cls": _grads(train_classifier.main(
        _argv(str(root / "one" / "cls")))),
        "sn": _grads(train_samplenet.main(
            _argv(str(root / "one" / "sn"), cls_weights)))}
    return root, ranks, one


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("cli,name,ckpt,cancelled", [
    ("cls", "classifier", "ckpt_last/classifier.pth", CLASSIFIER_CANCELLED),
    ("sn", "samplenet", "ckpt/sampler.pth", SAMPLER_CANCELLED)])
def test_data_parallel_cli_matches_one_process(cli_runs, cli, name, ckpt,
                                               cancelled):
    root, ranks, one = cli_runs
    dp, ref = root / "dp" / cli, root / "one" / cli
    got, want = (_metrics(d / f"metrics_{name}.jsonl") for d in (dp, ref))
    assert len(got) == len(want) == 1
    assert got[0]["step"] == want[0]["step"] == 1
    for k, v in want[0].items():
        if k in ("time", "step"):
            continue
        if "acc" in k:
            assert got[0][k] == v, k
        else:
            np.testing.assert_allclose(got[0][k], v, rtol=1e-5, err_msg=k)
    grads = one[cli]
    for out in ranks:
        assert out[cli].keys() == grads.keys()
        for k, g in grads.items():
            if k not in cancelled:
                np.testing.assert_allclose(
                    out[cli][k].numpy(), g.numpy(), rtol=1e-3,
                    atol=1e-4 * float(g.abs().max()), err_msg=k)
    sd_got, sd_want = (torch.load(d / ckpt, weights_only=True)
                       for d in (dp, ref))
    assert sd_got.keys() == sd_want.keys()
    for k, v in sd_want.items():
        if "running_" in k:
            np.testing.assert_allclose(sd_got[k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        elif k in grads and k not in cancelled:
            g = grads[k].abs()
            resolved = (g > 1e-4 * g.max()).numpy()
            np.testing.assert_allclose(sd_got[k].numpy()[resolved],
                                       v.numpy()[resolved], rtol=0,
                                       atol=1e-6, err_msg=k)


def test_data_parallel_cli_writes_only_on_rank_0(cli_runs):
    root = cli_runs[0]
    assert (root / "dp" / "sn" / "ckpt" / "sampler.pth").exists()
    assert (root / "dp" / "cls" / "log_classifier.txt").exists()
    assert not (root / "dp_rank1").exists()


def test_data_parallel_without_torchrun_is_a_world_of_one(tmp_path,
                                                          monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    state = train_classifier.main(_argv(str(tmp_path / "dp1")) +
                                  ["--data-parallel"])
    assert state.step == 1 and state.mesh.size == 1
    assert not state.mesh.distributed


# ------------------------------------------------------- the mesh, the launch

def test_make_mesh_is_data_parallel_only():
    with pytest.raises(NotImplementedError, match="Queue 1 item 9b"):
        make_mesh(model=2)
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {"data": 1,
                                                          "model": 1})
    with pytest.raises(ValueError, match="2 != 1 ranks|mesh 2x1"):
        make_mesh(data=2)


def test_batch_rows_need_equal_shares():
    mesh = make_mesh()
    assert batch_rows(mesh, 6) == slice(0, 6)
    with pytest.raises(ValueError, match="not divisible"):
        batch_rows(mesh.__class__(None, 1, 4, torch.device("cpu"), False),
                   6)


def test_initialize_distributed_without_torchrun(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed("cpu") is False


def _raises_on_rank_1(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    return mesh.rank


def _hangs(mesh):
    import time
    time.sleep(600)


def test_spawn_fails_with_a_failed_rank():
    with pytest.raises(mp.ProcessRaisedException, match="rank 1 fails"):
        spawn(_raises_on_rank_1, 2, timeout=60.0)


def test_spawn_kills_a_group_that_does_not_end():
    with pytest.raises(TimeoutError, match="did not end"):
        spawn(_hangs, 2, timeout=15.0)
