"""CLI: the reconstruction track on the port. Phase 1 trains the AE; phase
2 trains SampleNet against the frozen AE and reports NRE
(reconstruction/autoencoder/train_ae.py + sampler/train_samplenet.py).

    python -m samplenet_tpu_torch.train.train_reconstruction --phase ae \\
        --device cuda --loss emd --log-dir log/ae
    python -m samplenet_tpu_torch.train.train_reconstruction \\
        --phase samplenet --device cuda --ae-ckpt log/ae/ckpt --fps-baseline

Phase 1 writes `--log-dir`/ckpt (ae.pth + config.json with the AE's
num_points, bottleneck_size, loss, denoising_sigma and outlier_ratio);
phase 2 reads the AE's shape and its loss from there, and writes
`--log-dir`/ckpt (sampler.pth + config.json). `--init-ckpt` loads a
published checkpoint of the phase's model first; with `--epochs 0` the run
only evaluates it.

Flags of the JAX CLI left out or refused: `--progressive` (the
progressive track) and `--fused-train` (in ghost mode its kernel,
point_mlp_train_max; the exact-BN chain of its exact mode is the port's
only train chain) raise NotImplementedError; `--no-emd-kernel` and
`--emd-fast` (the XLA-scan EMD, in bf16 with the latter) raise ValueError,
since the port's EMD is its kernel; `--no-fused-train` and `--fused-f32`
select TPU code paths and are left out.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from samplenet_tpu_torch.data import augment, iterate_batches, make_dataset
from samplenet_tpu_torch.models.autoencoder import PointNetAE
from samplenet_tpu_torch.train import checkpoints
from samplenet_tpu_torch.train.reconstruction import (
    AEConfig,
    SampleNetAEConfig,
    create_ae_state,
    create_sampler_ae_state,
    evaluate_nre,
    make_ae_eval_step,
    make_ae_train_step,
    make_fps_ae_eval_step,
    make_sampler_ae_eval_step,
    make_sampler_ae_train_step,
)
from samplenet_tpu_torch.utils import Logger


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_reconstruction")
    p.add_argument("--phase", choices=["ae", "samplenet"], default="ae")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--dataset", default="procedural",
                   choices=["procedural", "shapenet"],
                   help="shapenet: one category's PLYs under --data-dir, "
                        "split 85/5/10; --train-size/--test-size are ignored")
    p.add_argument("--data-dir", default="data",
                   help="root holding shape_net_core_uniform_samples_2048/")
    p.add_argument("--category", default="chair",
                   help="ShapeNet category or synset id (shapenet only)")
    p.add_argument("--num-points", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--train-size", type=int, default=500)
    p.add_argument("--test-size", type=int, default=100)
    p.add_argument("--loss", choices=["chamfer", "emd", "softassign"],
                   default="chamfer", help="the AE loss")
    p.add_argument("--emd-fast", action="store_true",
                   help="the JAX package's bf16 XLA-scan EMD (refused)")
    p.add_argument("--no-emd-kernel", action="store_true",
                   help="the JAX package's XLA-scan EMD (refused)")
    p.add_argument("--bottleneck-size", type=int, default=128)
    p.add_argument("--num-out-points", type=int, default=64)
    p.add_argument("--group-size", type=int, default=16)
    p.add_argument("--alpha", type=float, default=0.01)
    p.add_argument("--lmbda", type=float, default=0.0001)
    p.add_argument("--ae-ckpt", default="log/ae/ckpt")
    p.add_argument("--denoising-sigma", type=float, default=0.0,
                   help="gaussian input-corruption sigma; > 0 trains "
                        "noisy -> clean and, in the samplenet phase, doubles "
                        "the size-scaled simplification weight")
    p.add_argument("--outlier-ratio", type=float, default=0.0,
                   help="share of point slots replaced by uniform [-1, 1] "
                        "outliers on the model input")
    p.add_argument("--fps-baseline", action="store_true",
                   help="samplenet phase: also report the FPS-baseline NRE "
                        "at --num-out-points through the frozen AE")
    p.add_argument("--progressive", action="store_true",
                   help="nested-size sampler training (not ported yet)")
    p.add_argument("--fused-train", action="store_true",
                   help="the --fused-mode fused train chain (not ported)")
    p.add_argument("--fused-mode", choices=("ghost", "exact"),
                   default="ghost")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init-ckpt", default=None,
                   help="published checkpoint of the phase's model to start "
                        "from; with --epochs 0 only evaluate it")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    if args.progressive:
        raise NotImplementedError(
            "--progressive: the progressive track (train/progressive.py and "
            "the nn_snap kernel) is not ported yet; see ROADMAP.md, Queue 1 "
            "item 9 and Queue 2 item 6")
    if args.fused_train:
        raise NotImplementedError(
            f"--fused-train --fused-mode {args.fused_mode}: the ghost-BN "
            "train kernel point_mlp_train_max is not ported yet (see "
            "ROADMAP.md, Queue 2 item 8), and the exact-BN chain is the "
            "port's only train chain, taken without the flag")
    if args.no_emd_kernel or args.emd_fast:
        raise ValueError(
            "--no-emd-kernel / --emd-fast select the JAX package's XLA-scan "
            "EMD; the port computes the emd loss with its EMD kernel only")


def load_data(args):
    if args.dataset == "shapenet":
        from samplenet_tpu_torch.data.shapenet import load_category_split

        train, val, test = load_category_split(
            args.data_dir, args.category, args.num_points, seed=args.seed)
        return train, test, (f"shapenet {args.category}: {len(train)} train "
                             f"/ {len(val)} val / {len(test)} test clouds")
    train, _ = make_dataset(args.train_size, args.num_points, seed=args.seed)
    test, _ = make_dataset(args.test_size, args.num_points,
                           seed=args.seed + 1)
    return train, test, (f"procedural: {len(train)} train / {len(test)} "
                         f"test clouds of {args.num_points} points")


def _tensor(bx: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bx)).to(device)


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    log_dir = args.log_dir or f"log/reconstruction_{args.phase}"
    logger = Logger(log_dir, args.phase)
    train_data, test_data, what = load_data(args)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    logger.log(f"{what}; device={name}")
    np_rng = np.random.RandomState(0)
    dummy_labels = np.zeros(len(train_data), np.int32)
    sigma, outlier = args.denoising_sigma, args.outlier_ratio
    corrupting = sigma > 0 or outlier > 0

    def make_corrupt(rng_):
        def corrupt(bx):
            if sigma > 0:
                bx = augment.jitter_point_cloud(bx, rng_, sigma=sigma,
                                                clip=1.0)
            if outlier > 0:
                bx = augment.noisy_point_cloud(bx, rng_, ratio=outlier)
            return bx
        return corrupt

    corrupt = make_corrupt(np_rng)

    def train_batches():
        for bi, (bx, _) in enumerate(iterate_batches(
                train_data, dummy_labels, args.batch_size, rng=np_rng)):
            if args.steps_per_epoch and bi >= args.steps_per_epoch:
                break
            if corrupting:
                yield _tensor(corrupt(bx), device), _tensor(bx, device)
            else:
                yield _tensor(bx, device), None

    if args.phase == "ae":
        cfg = AEConfig(num_points=args.num_points, loss=args.loss,
                       batch_size=args.batch_size,
                       bottleneck_size=args.bottleneck_size,
                       n_sample_points=args.num_points)
        model, state = create_ae_state(cfg, device=device, seed=args.seed)
        if args.init_ckpt:
            sd, _ = checkpoints.load_published(args.init_ckpt, "ae.pth")
            model.load_state_dict(sd)
            logger.log(f"restored {args.init_ckpt}")
        step = make_ae_train_step(model, cfg)
        eval_step = make_ae_eval_step(model)

        def test_loss() -> float:
            return float(np.mean([
                float(eval_step(state, _tensor(bx, device)).mean())
                for bx, _ in iterate_batches(
                    test_data, np.zeros(len(test_data), np.int32),
                    args.batch_size, shuffle=False)]))

        if args.epochs == 0:
            test = test_loss()
            logger.log(f"eval-only: test={test:.5f}")
            logger.metrics(0, test=test)
        for epoch in range(args.epochs):
            losses = [step(state, x, gt) for x, gt in train_batches()]
            train = float(torch.stack(losses).mean())
            test = test_loss()
            logger.log(f"epoch {epoch}: train={train:.5f} test={test:.5f}")
            logger.metrics(state.step, train=train, test=test)
        ckpt = os.path.join(log_dir, "ckpt")
        checkpoints.save_published(
            ckpt, model.state_dict(),
            {"num_points": args.num_points,
             "bottleneck_size": args.bottleneck_size, "loss": args.loss,
             "denoising_sigma": sigma, "outlier_ratio": outlier},
            filename="ae.pth")
        logger.log(f"saved checkpoint to {ckpt}")
        logger.close()
        return state

    # phase == samplenet
    ae_sd, ae_cfg = checkpoints.load_published(args.ae_ckpt, "ae.pth")
    ae = PointNetAE(int(ae_cfg["num_points"]), int(ae_cfg["bottleneck_size"]))
    ae.load_state_dict(ae_sd)
    ae = ae.to(device)
    logger.log(f"frozen AE from {args.ae_ckpt}: {ae_cfg}")
    scfg = SampleNetAEConfig(
        num_out_points=args.num_out_points, group_size=args.group_size,
        alpha=args.alpha, lmbda=args.lmbda, batch_size=args.batch_size,
        is_denoising=corrupting)
    sampler, state = create_sampler_ae_state(scfg, device=device,
                                             seed=args.seed)
    if args.init_ckpt:
        sd, _ = checkpoints.load_published(args.init_ckpt, "sampler.pth")
        sampler.load_state_dict(sd)
        logger.log(f"restored {args.init_ckpt}")
    step = make_sampler_ae_train_step(sampler, ae, scfg,
                                      ae_loss=str(ae_cfg["loss"]))
    eval_step = make_sampler_ae_eval_step(sampler, ae)

    def nre(step_fn) -> dict:
        eval_rng = np.random.RandomState(123)
        return evaluate_nre(
            step_fn, state, test_data, args.batch_size, device=device,
            noise_fn=make_corrupt(eval_rng) if corrupting else None)

    def report_fps_baseline():
        if not args.fps_baseline:
            return
        rep = nre(make_fps_ae_eval_step(ae, args.num_out_points))
        logger.log(f"FPS baseline @{args.num_out_points}: "
                   f"NRE={rep['nre']:.4f} (cd={rep['loss_sampled_mean']:.5f} "
                   f"vs full={rep['loss_full_mean']:.5f})")
        logger.metrics(state.step, fps_nre=rep["nre"])

    if args.epochs == 0:
        report = nre(eval_step)
        logger.log(f"eval-only: NRE={report['nre']:.4f}")
        logger.metrics(0, nre=report["nre"])
        report_fps_baseline()
    for epoch in range(args.epochs):
        agg: dict[str, list] = {}
        for x, gt in train_batches():
            for k, v in step(state, x, gt).items():
                agg.setdefault(k, []).append(v)
        mean = {k: float(torch.stack(v).mean()) for k, v in agg.items()}
        report = nre(eval_step)
        logger.log(f"epoch {epoch}: " +
                   " ".join(f"{k}={v:.5f}" for k, v in mean.items()) +
                   f" | NRE={report['nre']:.4f}")
        logger.metrics(state.step, nre=report["nre"], **mean)
    if args.epochs:
        report_fps_baseline()
    ckpt = os.path.join(log_dir, "ckpt")
    checkpoints.save_published(ckpt, sampler.state_dict(), vars(args))
    logger.log(f"saved checkpoint to {ckpt}")
    logger.close()
    return state


if __name__ == "__main__":
    main()
