"""Data parallelism of the port: W gloo ranks against one process.

Every train step of the port (the classification sampler step with
augmentation, the classifier step vanilla and with T-nets and dropout,
the registration PCRNet and sampler steps, the reconstruction AE and
sampler steps, the progressive step with the exact chain and with the
ghost chain, and the progressive AE step) runs on W = 2 and W = 4 gloo
ranks, each on its rows of a global batch of B = 16 (parallel/launch.py,
one thread a rank), and in this process on the whole batch. The ranks
must compute what the process computes: the loss terms (averaged over
the ranks), the gradients (after the optimiser's all-reduce), the
running statistics and the updated parameters, in float64 and float32.

Tolerances. float64: rtol 1e-10, with an atol of 1e-10 times each
tensor's largest entry (round-off-gradient parameters sit at 1e-17).
float32, those of test_torch_port_train_step.py: loss terms rtol 1e-5;
gradients rtol 1e-3 with atol 1e-4 times the tensor's largest entry;
running statistics rtol 1e-4 / atol 1e-6; updated parameters atol 1e-6
where the gradient is resolved (above 1e-4 of its tensor's largest
entry), and not at all for a tensor whose gradient is round-off (below
1e-5 of the model's largest): Adam's first step moves such an element by
about +-lr whichever sign its round-off takes.

Two float32 steps are ill-conditioned past those tolerances on one
process already: the reconstruction sampler step with the EMD loss (the
auction is chaotic in float32: the ranks' loss lands 3e-5 to 4e-4 from
float64, the process's 1.1e-3) and the T-net classifier step (a head's
running mean moves by 1.3e-6 at 2e-3, past atol 1e-6). A tensor or term
of theirs that misses the tolerance above is held as the card checks
hold such steps (chip_smoke.py, ROADMAP Queue 3): within 2x the
one-process float32 step's error against the one-process float64 step
(the largest entry of the difference; for the updated parameters, over
the entries whose gradient is resolved). Their float64 runs meet rtol
1e-10.

The ghost chain's block comes from the global batch, as the JAX package
chooses it: at B = 16 the progressive ghost step's block is 16 clouds,
which straddles the ranks (each rank's own choice would be 8 or 4). The
block statistics are also held on their own at shapes where blocks span
some ranks but not all (B = 32 over 4 ranks) and where neither a rank's
batch nor the block divides the other (B = 48 over 2 ranks, block 16).

Also on the ranks: the exact chain with bf16 operands (float64 sums)
equals one process at the float64 tolerance, and an AE step whose NaN
lies in one rank's rows is skipped by the guarded optimiser on every
rank (the gradients it reads are the averaged ones).

A control that must fail: the classification sampler step with the
statistics' all-reduce taken out of every BatchNorm and chain (each rank
normalising by its own rows, as DistributedDataParallel without
SyncBatchNorm would) differs from the one-process step beyond the
tolerance.
"""

import math

import numpy as np
import pytest
import torch

from samplenet_tpu_torch.parallel.launch import spawn
from samplenet_tpu_torch.parallel.mesh import (
    data_parallel,
    global_mean,
    replicated,
    shard_batch,
)

torch.set_num_threads(1)

B, N = 16, 64
TIMEOUT = 120.0
TRACKS = ("cls_sampler", "classifier", "classifier_tnets", "pcrnet",
          "reg_sampler", "ae", "recon_sampler", "progressive",
          "progressive_ghost", "progressive_ae")
DTYPES = ("float64", "float32")
# float32 steps held within 2x the one-process float32 error to float64
ILL_CONDITIONED_F32 = ("recon_sampler", "classifier_tnets")


def _global_inputs(n: int = N):
    rng = np.random.RandomState(0)
    return {"x": rng.randn(B, n, 3).astype(np.float32),
            "x1": rng.randn(B, n, 3).astype(np.float32),
            "y": rng.randint(0, 4, B).astype(np.int64),
            "igt": np.concatenate([
                rng.randn(B, 4) * 0.3 + np.array([1, 0, 0, 0]),
                rng.randn(B, 3) * 0.1], 1).astype(np.float32)}


def _build(track: str):
    """(model, state, step, frozen, batch keys, step args) of a track at a
    small size, every network seeded."""
    from samplenet_tpu_torch.models.pointnet_cls import PointNetClassifier
    from samplenet_tpu_torch.train import (
        classification as cls_lib,
        progressive as prog_lib,
        reconstruction as rec_lib,
        registration as reg_lib,
    )

    gen = torch.Generator().manual_seed(2)

    def classifier(seed=1, **kw):
        return PointNetClassifier(4, generator=torch.Generator().manual_seed(
            seed), **kw)

    if track == "cls_sampler":
        cfg = cls_lib.SampleNetConfig(num_out_points=8, bottleneck_size=32,
                                      group_size=4, batch_size=B)
        model, state = cls_lib.create_samplenet_state(cfg, device="cpu")
        frozen = classifier()
        step = cls_lib.make_samplenet_train_step(model, frozen, cfg)
        return model, state, step, [frozen], ("x", "y"), (gen,)
    if track in ("classifier", "classifier_tnets"):
        tnets = track == "classifier_tnets"
        cfg = cls_lib.ClassifierConfig(num_classes=4, batch_size=B,
                                       use_tnets=tnets, bn_schedule=tnets)
        model, state = cls_lib.create_classifier_state(cfg, device="cpu")
        step = cls_lib.make_classifier_train_step(model, cfg)
        return model, state, step, [], ("x", "y"), (
            gen, torch.Generator().manual_seed(3))
    if track in ("pcrnet", "reg_sampler"):
        cfg = reg_lib.RegistrationConfig(num_points=N, num_out_points=8,
                                         group_size=4, batch_size=B)
        pcrnet, pstate = reg_lib.create_pcrnet_state(cfg, device="cpu",
                                                     seed=3)
        if track == "pcrnet":
            return pcrnet, pstate, reg_lib.make_pcrnet_train_step(
                pcrnet, cfg), [], ("x", "x1", "igt"), ()
        model, state = reg_lib.create_sampler_state(cfg, device="cpu",
                                                    seed=4)
        step = reg_lib.make_sampler_train_step(model, pcrnet, cfg)
        return model, state, step, [pcrnet], ("x", "x1", "igt"), ()
    if track in ("ae", "recon_sampler", "progressive_ae"):
        acfg = rec_lib.AEConfig(num_points=N, bottleneck_size=32,
                                batch_size=B, n_sample_points=N)
        ae, astate = rec_lib.create_ae_state(acfg, device="cpu", seed=5)
        if track == "ae":
            return ae, astate, rec_lib.make_ae_train_step(ae, acfg), [], \
                ("x",), ()
        scfg = rec_lib.SampleNetAEConfig(num_out_points=16,
                                         bottleneck_size=32, group_size=4,
                                         batch_size=B)
        model, state = rec_lib.create_sampler_ae_state(scfg, device="cpu",
                                                       seed=6)
        if track == "recon_sampler":
            step = rec_lib.make_sampler_ae_train_step(model, ae, scfg,
                                                      ae_loss="emd")
        else:
            pcfg = prog_lib.ProgressiveAEConfig(
                max_num_out_points=16, min_num_out_points=4, group_size=4,
                batch_size=B)
            step = prog_lib.make_progressive_ae_train_step(model, ae, pcfg)
        return model, state, step, [ae], ("x",), ()
    ghost = track == "progressive_ghost"
    cfg = prog_lib.ProgressiveConfig(
        max_num_out_points=16, min_num_out_points=4, bottleneck_size=32,
        group_size=4, batch_size=B, fused_train=True if ghost else None,
        fused_bf16=False)
    model, state = prog_lib.create_progressive_state(cfg, device="cpu",
                                                     seed=7)
    frozen = classifier(8)
    step = prog_lib.make_progressive_train_step(model, frozen, cfg)
    return model, state, step, [frozen], ("x", "y"), ()


def _run(track: str, dtype_name: str, mesh=None, per_rank_bn=False):
    """One step of `track` on this rank's rows (all of them without a
    mesh): its global metrics, gradients, running statistics and
    parameters, as float64 CPU tensors."""
    dtype = getattr(torch, dtype_name)
    model, state, step, frozen, keys, extra = _build(track)
    for m in (model, *frozen):
        m.to(dtype)
    n = 128 if track == "progressive_ghost" else N
    inputs = _global_inputs(n)
    batch = shard_batch(mesh, tuple(inputs[k] for k in keys))
    args = [torch.from_numpy(a).to(dtype) if a.dtype == np.float32
            else torch.from_numpy(a) for a in batch]
    if mesh is not None:
        replicated(mesh, model, check=True)
        data_parallel(state, mesh)
        if per_rank_bn:                 # the control: no statistics sync
            data_parallel(model, None)
    metrics = step(state, *args, *extra)
    if not isinstance(metrics, dict):
        metrics = {"loss": metrics[0], "acc": metrics[1]} \
            if isinstance(metrics, tuple) else {"loss": metrics}
    metrics = global_mean({k: torch.as_tensor(v, dtype=torch.float64)
                           for k, v in metrics.items()}, mesh)
    grads = {k: p.grad.double().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    stats = {k: v.double().clone() for k, v in model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    params = {k: p.detach().double().clone()
              for k, p in model.named_parameters()}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "stats": stats, "params": params,
            "step": state.step, "count": state.optimizer.count}


def _ghost_blocks(mesh, cases):
    """The plain ghost chain's outputs and gradients under `mesh` for each
    (B, block_b) case, on this rank's rows."""
    from samplenet_tpu_torch.ops.cuda.point_mlp_train_kernel import (
        point_mlp_train_max,
    )
    return [_ghost_case(b, bb, point_mlp_train_max, mesh) for b, bb in cases]


def _ghost_case(b, block_b, fn, mesh=None):
    rng = np.random.RandomState(b)
    widths = (8, 16)
    x = rng.randn(b, 128, 3)
    ws, cin = [], 3
    for f in widths:
        ws.append(torch.tensor(rng.randn(cin, f) * 0.3, requires_grad=True))
        cin = f
    bs = [torch.tensor(rng.randn(f) * 0.1) for f in widths]
    gms = [torch.tensor(1 + 0.2 * rng.randn(f), requires_grad=True)
           for f in widths]
    bts = [torch.tensor(0.2 * rng.randn(f), requires_grad=True)
           for f in widths]
    g = torch.tensor(rng.randn(b, widths[-1]))
    xs = torch.tensor(shard_batch(mesh, x), requires_grad=True)
    pooled, means, vars_ = fn(xs, ws, bs, gms, bts, block_b=block_b,
                              bf16=False, mesh=mesh)
    (pooled * shard_batch(mesh, g)).sum().backward()
    out = {"pooled": pooled.detach(), "dx": xs.grad,
           "means": torch.cat(means), "vars": torch.cat(vars_)}
    grads = [t.grad for t in (*ws, *gms, *bts)]
    if mesh is not None:
        from samplenet_tpu_torch.parallel.mesh import all_reduce_
        grads = [all_reduce_(t.clone(), mesh) for t in grads]
    out["param_grads"] = torch.cat([t.reshape(-1) for t in grads])
    return out


GHOST_CASES = {2: [(16, 16), (48, 16)], 4: [(16, 16), (32, 16)]}


def _exact_bf16(mesh=None):
    """The exact chain with bf16 operands (float64 otherwise) on this
    rank's rows: pooled, statistics, dx and the summed parameter
    gradients."""
    from samplenet_tpu_torch.ops.cuda.point_mlp_exact_kernel import (
        point_mlp_exact_train_max,
    )
    return _ghost_case(16, None, lambda *a, block_b, bf16, mesh: (
        point_mlp_exact_train_max(*a, bf16=True, **(
            {} if mesh is None else {"mesh": mesh}))), mesh)


def _guard(mesh):
    """An AE step whose NaN lies in rank 1's rows only: every rank reads
    the averaged, non-finite gradients and skips the update."""
    model, state, step, _, _, _ = _build("ae")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    x = _global_inputs()["x"]
    x[B - 1, 0, 0] = np.nan
    data_parallel(state, mesh)
    step(state, torch.from_numpy(shard_batch(mesh, x)))
    return {"count": state.optimizer.count, "skipped":
            state.optimizer.total_notfinite, "same": all(
                torch.equal(p, before[k])
                for k, p in model.named_parameters())}


def _group(mesh):
    out = {(t, d): _run(t, d, mesh) for d in DTYPES for t in TRACKS}
    if mesh.size == 2:
        out["control"] = _run("cls_sampler", "float64", mesh,
                              per_rank_bn=True)
        out["guard"] = _guard(mesh)
    out["ghost"] = _ghost_blocks(mesh, GHOST_CASES[mesh.size])
    out["exact_bf16"] = _exact_bf16(mesh)
    return out


@pytest.fixture(scope="module")
def ranks():
    return {w: spawn(_group, w, timeout=TIMEOUT) for w in (2, 4)}


@pytest.fixture(scope="module")
def reference():
    return {(t, d): _run(t, d) for d in DTYPES for t in TRACKS}


def _close(a, b, dtype, *, rtol=None, scale_atol=None, err=""):
    f64 = dtype == "float64"
    rtol = 1e-10 if f64 else rtol
    atol = (1e-10 if f64 else scale_atol) * float(b.abs().max())
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol,
                               err_msg=err)


CASES = [(w, t, d) for w in (2, 4) for d in DTYPES for t in TRACKS]
IDS = [f"W{w}-{t}-{d}" for w, t, d in CASES]


@pytest.mark.parametrize("w,track,dtype", CASES, ids=IDS)
def test_loss_terms_equal_one_process(ranks, reference, w, track, dtype):
    ref = reference[(track, dtype)]
    ref64 = reference[(track, "float64")]
    for r, out in enumerate(ranks[w]):
        got = out[(track, dtype)]
        assert got["metrics"].keys() == ref["metrics"].keys()
        for k, v in ref["metrics"].items():
            def close():
                assert math.isclose(got["metrics"][k], v,
                                    rel_tol=1e-10 if dtype == "float64"
                                    else 1e-5, abs_tol=1e-12), (r, k)
            _check(close, track, dtype, *(torch.tensor(t["metrics"][k]) for t
                                          in (got, ref, ref64)), k)
        assert got["step"] == ref["step"] == 1
        assert got["count"] == ref["count"]


def _within_twice(got, ref32, ref64, err=""):
    """got's error against ref64 at most twice ref32's (largest entries)."""
    e_got = float((got - ref64).abs().max())
    e_ref = float((ref32 - ref64).abs().max())
    assert e_got <= 2 * e_ref, (err, e_got, e_ref)


def _ill(track, dtype) -> bool:
    return dtype == "float32" and track in ILL_CONDITIONED_F32


def _check(close, track, dtype, got, ref32, ref64, err=""):
    """close() (the tolerance), or for an ill-conditioned float32 step
    where it fails, the 2x rule against float64."""
    try:
        close()
    except AssertionError:
        if not _ill(track, dtype):
            raise
        _within_twice(got, ref32, ref64, err)


def _roundoff(g, top, dtype) -> bool:
    """Whether a gradient is round-off, zero in exact arithmetic (every
    dense bias before a BatchNorm, the last conv BN's beta)."""
    return float(g.abs().max()) < (1e-12 if dtype == "float64"
                                   else 1e-5) * top


@pytest.mark.parametrize("w,track,dtype", CASES, ids=IDS)
def test_gradients_equal_one_process(ranks, reference, w, track, dtype):
    ref = reference[(track, dtype)]["grads"]
    ref64 = reference[(track, "float64")]["grads"]
    assert ref
    top = max(float(g.abs().max()) for g in ref.values())
    for out in ranks[w]:
        got = out[(track, dtype)]["grads"]
        assert got.keys() == ref.keys()
        for k in ref:
            if _roundoff(ref[k], top, dtype):
                assert _roundoff(got[k], top, dtype), k
                continue
            _check(lambda: _close(got[k], ref[k], dtype, rtol=1e-3,
                                  scale_atol=1e-4, err=k),
                   track, dtype, got[k], ref[k], ref64[k], k)


@pytest.mark.parametrize("w,track,dtype", CASES, ids=IDS)
def test_running_stats_equal_one_process(ranks, reference, w, track, dtype):
    ref = reference[(track, dtype)]["stats"]
    ref64 = reference[(track, "float64")]["stats"]
    for out in ranks[w]:
        got = out[(track, dtype)]["stats"]
        assert got.keys() == ref.keys()
        for k in ref:
            if dtype == "float64":
                _close(got[k], ref[k], dtype, err=k)
                continue
            _check(lambda: np.testing.assert_allclose(
                got[k].numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-6,
                err_msg=k), track, dtype, got[k], ref[k], ref64[k], k)


@pytest.mark.parametrize("w,track,dtype", CASES, ids=IDS)
def test_updated_params_equal_one_process(ranks, reference, w, track,
                                          dtype):
    ref = reference[(track, dtype)]
    top = max(float(g.abs().max()) for g in ref["grads"].values())
    for out in ranks[w]:
        got = out[(track, dtype)]["params"]
        for k, g in ref["grads"].items():
            if _roundoff(g, top, dtype):
                continue
            resolved = g.abs() > 1e-4 * float(g.abs().max())
            a, b = got[k][resolved], ref["params"][k][resolved]
            _check(lambda: np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=0,
                atol=1e-10 if dtype == "float64" else 1e-6, err_msg=k),
                track, dtype, a, b,
                reference[(track, "float64")]["params"][k][resolved], k)
        for k in ref["params"].keys() - ref["grads"].keys():
            assert torch.equal(got[k], ref["params"][k]), k


@pytest.mark.parametrize("w", (2, 4))
def test_ranks_hold_equal_parameters(ranks, w):
    for track in TRACKS:
        first = ranks[w][0][(track, "float32")]["params"]
        for out in ranks[w][1:]:
            for k, v in out[(track, "float32")]["params"].items():
                assert torch.equal(v, first[k]), (track, k)


@pytest.mark.parametrize("w,case", [(w, i) for w in (2, 4)
                                    for i in range(2)])
def test_ghost_blocks_of_the_global_batch(ranks, w, case):
    from samplenet_tpu_torch.ops.cuda.point_mlp_train_kernel import (
        point_mlp_train_max,
    )
    b, block_b = GHOST_CASES[w][case]
    ref = _ghost_case(b, block_b, point_mlp_train_max)
    rows = slice(None)
    for r, out in enumerate(ranks[w]):
        got = out["ghost"][case]
        rows = slice(r * b // w, (r + 1) * b // w)
        for k in ("pooled", "dx"):
            _close(got[k], ref[k][rows], "float64", err=k)
        for k in ("means", "vars", "param_grads"):
            _close(got[k], ref[k], "float64", err=k)


def test_ghost_blocks_differ_from_rank_local_blocks():
    """The case above is not vacuous: at B = 16 over 2 ranks the rank's
    own choice of block (8) gives other outputs than the global one."""
    from samplenet_tpu_torch.ops.cuda.point_mlp_train_kernel import (
        auto_block_b,
        point_mlp_train_max,
    )
    assert auto_block_b(16, 128, (8, 16), False) == 16
    assert auto_block_b(8, 128, (8, 16), False) == 8
    glob = _ghost_case(16, 16, point_mlp_train_max)["pooled"]
    local = _ghost_case(16, 8, point_mlp_train_max)["pooled"]
    assert float((glob - local).abs().max()) > 1e-3


def test_per_rank_bn_control_differs(ranks, reference):
    ref = reference[("cls_sampler", "float64")]
    got = ranks[2][0]["control"]
    with pytest.raises(AssertionError):
        for k in ref["grads"]:
            _close(got["grads"][k], ref["grads"][k], "float64", err=k)
    with pytest.raises(AssertionError):
        for k in ref["stats"]:
            _close(got["stats"][k], ref["stats"][k], "float64", err=k)


def _collectives_of_a_step(mesh):
    from samplenet_tpu_torch.parallel.mesh import (
        collective_counts,
        reset_collective_counts,
    )
    model, state, step, _, keys, extra = _build("cls_sampler")
    inputs = _global_inputs()
    args = [torch.from_numpy(a) for a in shard_batch(
        mesh, tuple(inputs[k] for k in keys))]
    data_parallel(state, mesh)
    reset_collective_counts()
    step(state, *args, *extra)
    return collective_counts()


def test_a_classification_step_issues_17_all_reduces():
    """5 conv layers x 2 (statistics in the forward, rows in the
    backward), 3 head BatchNorms x 2 (their sums and the sums' cotangent)
    and 1 gradient all-reduce; the frozen classifier runs at eval."""
    counts = spawn(_collectives_of_a_step, 2, timeout=TIMEOUT)
    for c in counts:
        assert c["all_reduce"] == 5 * 2 + 3 * 2 + 1, c


@pytest.mark.parametrize("w", (2, 4))
def test_exact_chain_in_bf16_under_a_mesh(ranks, w):
    """The exact chain's bf16 mode (operands rounded, float64 sums here)
    on W ranks equals one process: the statistics the roundings follow
    are global, and each rounding takes the same value."""
    ref = _exact_bf16()
    b = 16
    for r, out in enumerate(ranks[w]):
        got = out["exact_bf16"]
        rows = slice(r * b // w, (r + 1) * b // w)
        for k in ("pooled", "dx"):
            _close(got[k], ref[k][rows], "float64", err=k)
        for k in ("means", "vars", "param_grads"):
            _close(got[k], ref[k], "float64", err=k)


def test_nonfinite_guard_skips_on_every_rank(ranks):
    for out in ranks[2]:
        assert out["guard"] == {"count": 0, "skipped": 1, "same": True}
