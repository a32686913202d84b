"""The multi-device dry run: one real optimiser step of every track, and
the eval forward and hard matching, on an n-rank ('data', 'model') mesh.

The counterpart of __graft_entry__.py::dryrun_multichip (:34-211), at its
sizes: a global batch of 2n clouds of 128 points, the classification
sampler step (with augmentation) against a frozen PointNet, the eval
forward, `nn_match_from_clouds` at N=256, m=144 (the sort-based paths),
the registration sampler step against a frozen PCRNet, the
reconstruction sampler step against a frozen AE and the progressive
(8/16/32) step. The n ranks are gloo processes on one host
(parallel/launch.py), sharing one card (the default) or on the CPU
(`--device cpu`). As in the JAX dry run (:72-107) the mesh takes 'model'
= 2 where n is even and n >= 4 (n // 2 x 2), else n x 1; the
classification sampler's parameters and batch statistics are placed by
`shard_params` (at its width nothing is wide enough to shard, as in
JAX), the frozen networks and the other tracks' samplers replicated, and
the global batch of 2n clouds is split over the data axis.

Every result must be finite, and every rank must report the same global
values (each a mean over the global batch, averaged over the ranks).

    python -m samplenet_tpu_torch.parallel.dryrun 2                # the card
    python -m samplenet_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from samplenet_tpu_torch.parallel.launch import spawn
from samplenet_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    data_parallel,
    global_mean,
    replicated,
    shard_batch,
    shard_params,
)

NUM_POINTS = 128


def _tracks(mesh: Mesh) -> dict[str, float]:
    """One rank's share of the dry run: the global value of each track."""
    from samplenet_tpu_torch.models.pointnet_cls import PointNetClassifier
    from samplenet_tpu_torch.ops.matching import nn_match_from_clouds
    from samplenet_tpu_torch.train.classification import (
        SampleNetConfig,
        create_samplenet_state,
        make_samplenet_eval_step,
        make_samplenet_train_step,
    )
    from samplenet_tpu_torch.train.progressive import (
        ProgressiveConfig,
        create_progressive_state,
        make_progressive_train_step,
    )
    from samplenet_tpu_torch.train.reconstruction import (
        AEConfig,
        SampleNetAEConfig,
        create_ae_state,
        create_sampler_ae_state,
        make_sampler_ae_train_step,
    )
    from samplenet_tpu_torch.train.registration import (
        RegistrationConfig,
        create_pcrnet_state,
        create_sampler_state,
        make_sampler_train_step,
    )

    dev = mesh.device
    batch = 2 * mesh.size
    rng = np.random.RandomState(0)        # the same global batch everywhere
    points = rng.randn(batch, NUM_POINTS, 3).astype(np.float32)
    labels = rng.randint(0, 10, batch).astype(np.int64)
    big_full = rng.randn(batch, 256, 3).astype(np.float32)
    big_simp = rng.randn(batch, 144, 3).astype(np.float32)
    p1 = rng.randn(batch, NUM_POINTS, 3).astype(np.float32)
    igt = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (batch, 1))
    x, y, full, simp, x1, gt = (
        torch.from_numpy(a).to(dev) for a in shard_batch(
            mesh, (points, labels, big_full, big_simp, p1, igt)))

    def under_mesh(model, state):
        replicated(mesh, model)
        return data_parallel(state, mesh)

    def loss(metrics: dict) -> float:
        return float(global_mean({"loss": metrics["loss"]}, mesh)["loss"])

    results: dict[str, float] = {}
    classifier = PointNetClassifier(
        10, generator=torch.Generator().manual_seed(1)).to(dev)
    scfg = SampleNetConfig(num_out_points=16, bottleneck_size=64,
                           group_size=4, batch_size=batch)
    sampler, state = create_samplenet_state(scfg, device=dev, seed=0)
    step = make_samplenet_train_step(sampler, classifier, scfg,
                                     augment_data=True)
    results["classification"] = loss(step(
        shard_params(mesh, data_parallel(state, mesh)), x, y,
        torch.Generator(device=dev).manual_seed(2)))

    correct = make_samplenet_eval_step(sampler, classifier)(state, x, y)
    results["eval_fwd"] = float(all_reduce_(
        correct.sum().to(torch.int64), mesh)) / batch

    matched = nn_match_from_clouds(full, simp, 144)[0]
    results["eval_matching_m144"] = float(global_mean(
        {"m": (matched.double() ** 2).mean()}, mesh)["m"])

    rcfg = RegistrationConfig(num_points=NUM_POINTS, num_out_points=16,
                              group_size=4, batch_size=batch)
    pcrnet, _ = create_pcrnet_state(rcfg, device=dev, seed=3)
    rsampler, rstate = create_sampler_state(rcfg, device=dev, seed=4)
    rstep = make_sampler_train_step(rsampler, pcrnet, rcfg)
    results["registration"] = loss(rstep(under_mesh(rsampler, rstate),
                                         x, x1, gt))

    acfg = AEConfig(num_points=NUM_POINTS, bottleneck_size=64,
                    batch_size=batch, n_sample_points=NUM_POINTS)
    ae, _ = create_ae_state(acfg, device=dev, seed=5)
    sacfg = SampleNetAEConfig(num_out_points=16, bottleneck_size=64,
                              group_size=4, batch_size=batch)
    asampler, astate = create_sampler_ae_state(sacfg, device=dev, seed=6)
    astep = make_sampler_ae_train_step(asampler, ae, sacfg)
    results["reconstruction"] = loss(astep(under_mesh(asampler, astate), x))

    pcfg = ProgressiveConfig(max_num_out_points=32, min_num_out_points=8,
                             bottleneck_size=64, group_size=4,
                             batch_size=batch)
    psampler, pstate = create_progressive_state(pcfg, device=dev, seed=7)
    pclassifier = PointNetClassifier(
        10, generator=torch.Generator().manual_seed(8)).to(dev)
    pstep = make_progressive_train_step(psampler, pclassifier, pcfg)
    results["progressive"] = loss(pstep(under_mesh(psampler, pstate), x, y))
    tracks = " ".join(f"{k}={v:.6f}" for k, v in results.items())
    print(f"rank {mesh.rank}/{mesh.size} {mesh.shape}: {tracks}", flush=True)
    return results


def model_axis(n: int) -> int:
    """The dry run's 'model' axis for n ranks (__graft_entry__.py:72)."""
    return 2 if n % 2 == 0 and n >= 4 else 1


def dryrun_multichip(n: int, device: str = "cuda",
                     timeout: float = 300.0) -> dict[str, float]:
    """Runs the dry run on n ranks on `device` (all ranks share it; the
    card unless the caller asks for the CPU) and returns the global
    values; raises without a card, and unless every value is finite and
    every rank reports the same ones."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"dryrun_multichip(device={device!r}) needs a "
                           f"CUDA device; pass device='cpu' for the CPU")
    model = model_axis(n)
    per_rank = spawn(_tracks, n, device=device, timeout=timeout, model=model)
    results = per_rank[0]
    bad = {k: v for k, v in results.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"non-finite dry run results: {bad}")
    for r, other in enumerate(per_rank):
        if other != results:
            raise AssertionError(f"rank {r} reports {other}, rank 0 "
                                 f"{results}")
    tracks = " ".join(f"{k}={v:.4f}" for k, v in results.items())
    mesh = {"data": n // model, "model": model}
    print(f"dryrun_multichip({n}): mesh={mesh} device={device} {tracks} ok",
          flush=True)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dryrun")
    p.add_argument("n", type=int)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
