"""CLI: the registration track on the port. Phase 1 trains PCRNet; phase 2
trains SampleNet against the frozen PCRNet (registration/main.py).

    python -m samplenet_tpu_torch.train.train_registration --phase pcrnet \\
        --device cuda --log-dir log/pcrnet
    python -m samplenet_tpu_torch.train.train_registration \\
        --phase samplenet --device cuda --pcrnet-ckpt log/pcrnet/ckpt

The flags are those of samplenet_tpu/train/train_registration.py:33-86,
and `--device` (cuda unless asked for cpu). The data are procedural
clouds under fixed random rotations (`QuaternionFixedDataset`);
`--category` keeps one procedural class, the analogue of the reference's
ModelNet40 "car" subset, and `--h5-dir` reads single-class
<name>_train.h5 / <name>_test.h5 shards instead.

Phase 1 validates after every epoch at `--train-iterations` passes and
keeps the best snapshot (or the last state, with `--epochs 0` or when
every validation is NaN). That snapshot is scored on full clouds and on
FPS samples of the configured m and each `--fps-eval-sizes` size, at 1
and at `--iterations` passes, and published as `--log-dir`/ckpt
(pcrnet.pth + config.json). Phase 2 freezes that PCRNet, trains the
sampler, evaluates it after every epoch and publishes the best snapshot
as `--log-dir`/ckpt (sampler.pth + config.json). Each phase writes its
reports to `--log-dir`/report.json.

`--fused-train` takes the `--fused-mode` train chain for the sampler's
conv layers, as train_samplenet resolves it: ghost BN (the ghost-BN
kernel, bf16 operands unless `--fused-f32`) where the shapes allow it,
else the exact-BN chain, which is also the chain without the flag and
with `--no-fused-train`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from samplenet_tpu_torch.data import (
    QuaternionFixedDataset,
    load_h5,
    make_dataset,
)
from samplenet_tpu_torch.models.pcrnet import PCRNet
from samplenet_tpu_torch.models.samplenet import FPSSampler
from samplenet_tpu_torch.train import checkpoints
from samplenet_tpu_torch.train.registration import (
    RegistrationConfig,
    create_pcrnet_state,
    create_sampler_state,
    evaluate,
    make_eval_step,
    make_pcrnet_train_step,
    make_sampler_train_step,
)
from samplenet_tpu_torch.utils import Logger


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_registration")
    p.add_argument("--phase", choices=["pcrnet", "samplenet"],
                   default="pcrnet")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--num-points", type=int, default=1024)
    p.add_argument("--num-out-points", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--train-size", type=int, default=256)
    p.add_argument("--test-size", type=int, default=64)
    p.add_argument("--repeat", type=int, default=2)
    p.add_argument("--alpha", type=float, default=0.01)
    p.add_argument("--lmbda", type=float, default=0.01)
    p.add_argument("--group-size", type=int, default=8)
    p.add_argument("--num-sampled-clouds", type=int, default=2,
                   choices=[1, 2])
    p.add_argument("--apply-noise", action="store_true")
    p.add_argument("--iterations", type=int, default=1,
                   help="refinement passes of the final test report (the "
                        "original PCRNet protocol; the reference uses 1)")
    p.add_argument("--train-iterations", type=int, default=1,
                   help="refinement passes composed inside the train loss; "
                        "validation and selection use the same count")
    p.add_argument("--category", type=int, default=None,
                   help="keep one procedural class (the reference trains "
                        "registration on the ModelNet40 'car' subset)")
    p.add_argument("--h5-dir", default=None,
                   help="directory of single-class <name>_train.h5 / "
                        "<name>_test.h5 shards; overrides the procedural "
                        "data (--train-size, --test-size and --category "
                        "are then ignored)")
    p.add_argument("--fused-train", action="store_true", default=None,
                   help="the --fused-mode train chain for the sampler's "
                        "conv layers (samplenet phase)")
    p.add_argument("--no-fused-train", dest="fused_train",
                   action="store_false",
                   help="the exact-BN chain (also the default)")
    p.add_argument("--fused-mode", choices=("ghost", "exact"),
                   default="ghost",
                   help="ghost (statistics per block of clouds) or exact "
                        "(global statistics, the default chain)")
    p.add_argument("--fused-f32", action="store_true",
                   help="f32 matmul operands in the ghost chain (default "
                        "bf16)")
    p.add_argument("--pcrnet-ckpt", default="log/pcrnet/ckpt")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fps-eval-sizes", default="",
                   help="comma list of m values; phase pcrnet also reports "
                        "the FPS baseline at each")
    return p.parse_args(argv)


def build_datasets(args):
    """(train, test) QuaternionFixedDataset of procedural clouds, one
    procedural class, or the h5 shards under --h5-dir; the JAX CLI's
    clouds and twists for the same flags."""
    if args.h5_dir is not None:
        def one(split):
            paths = sorted(glob.glob(os.path.join(args.h5_dir,
                                                  f"*_{split}.h5")))
            if not paths:
                raise FileNotFoundError(
                    f"no *_{split}.h5 under {args.h5_dir}")
            data = np.concatenate([load_h5(p)[0] for p in paths])
            return data[:, :args.num_points, :]

        base_train, base_test = one("train"), one("test")
    elif args.category is not None:
        # over-generate, then keep one class
        d, lab = make_dataset(args.train_size * 12, args.num_points,
                              seed=args.seed)
        base_train = d[lab == args.category][:args.train_size]
        d, lab = make_dataset(args.test_size * 12, args.num_points,
                              seed=args.seed + 1)
        base_test = d[lab == args.category][:args.test_size]
    else:
        base_train, _ = make_dataset(args.train_size, args.num_points,
                                     seed=args.seed)
        base_test, _ = make_dataset(args.test_size, args.num_points,
                                    seed=args.seed + 1)
    train = QuaternionFixedDataset(base_train, repeat=args.repeat, seed=0,
                                   apply_noise=args.apply_noise)
    test = QuaternionFixedDataset(base_test, repeat=1, seed=1,
                                  apply_noise=args.apply_noise,
                                  fixed_noise=args.apply_noise)
    return train, test


def _snapshot(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}


def _train_epoch(step, state, train, args, np_rng, device) -> dict:
    """One epoch of shuffled batches; the mean of each metric."""
    agg: dict[str, list] = {}
    for bi, batch in enumerate(train.batches(args.batch_size, rng=np_rng)):
        if args.steps_per_epoch and bi >= args.steps_per_epoch:
            break
        p0, p1, tw = (torch.from_numpy(a).to(device) for a in batch)
        for k, v in step(state, p0, p1, tw).items():
            agg.setdefault(k, []).append(v)
    return {k: float(torch.stack(v).mean()) for k, v in agg.items()}


def _write_report(log_dir: str, reports: dict) -> None:
    with open(os.path.join(log_dir, "report.json"), "w") as f:
        json.dump(reports, f, indent=1)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    log_dir = args.log_dir or f"log/registration_{args.phase}"
    logger = Logger(log_dir, args.phase)
    train, test = build_datasets(args)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    logger.log(f"{len(train)} train / {len(test)} test pairs of "
               f"{train.data.shape[1]} points; device={name}")
    cfg = RegistrationConfig(
        num_points=args.num_points,
        num_out_points=args.num_out_points,
        group_size=args.group_size,
        alpha=args.alpha, lmbda=args.lmbda,
        num_sampled_clouds=args.num_sampled_clouds,
        batch_size=args.batch_size,
        train_iterations=args.train_iterations,
        fused_train=True if args.fused_train else None,
        fused_mode=args.fused_mode,
        fused_bf16=False if args.fused_f32 else None,
    )
    np_rng = np.random.RandomState(0)
    ckpt = os.path.join(log_dir, "ckpt")

    if args.phase == "pcrnet":
        model, state = create_pcrnet_state(cfg, device=device,
                                           seed=args.seed)
        step = make_pcrnet_train_step(model, cfg)
        # validation and selection at the trained pass count
        val_step = make_eval_step(None, model, cfg,
                                  iterations=args.train_iterations)
        best = {"rot": float("inf"), "sd": None, "epoch": -1}
        for epoch in range(args.epochs):
            mean = _train_epoch(step, state, train, args, np_rng, device)
            val = evaluate(val_step, test, args.batch_size, device=device)
            logger.log(f"epoch {epoch}: " +
                       " ".join(f"{k}={v:.4f}" for k, v in mean.items()) +
                       f" val_rot={val['rot_err_mean']:.2f}deg")
            logger.metrics(state.step, val_rot=val["rot_err_mean"], **mean)
            if val["rot_err_mean"] < best["rot"]:
                best.update(rot=val["rot_err_mean"], epoch=epoch,
                            sd=_snapshot(model))
        if best["sd"] is None:
            # --epochs 0, or every validation NaN (NaN < inf is False)
            best.update(sd=_snapshot(model), epoch=-1)
        logger.log(f"best epoch {best['epoch']}: "
                   f"val_rot={best['rot']:.2f}deg")
        pcrnet = PCRNet().to(device)
        pcrnet.load_state_dict(best["sd"])
        fps_sizes = sorted({cfg.num_out_points} | {
            int(s) for s in args.fps_eval_sizes.split(",") if s.strip()})
        reports: dict[str, dict | float] = {"best_val_rot": best["rot"],
                                            "best_epoch": best["epoch"]}
        for its in sorted({1, args.iterations}):
            report = evaluate(make_eval_step(None, pcrnet, cfg,
                                             iterations=its),
                              test, args.batch_size, device=device)
            logger.log(f"test (full clouds, iterations={its}): {report}")
            reports[f"full_iter{its}"] = report
            for m in fps_sizes:
                fps = FPSSampler(num_out_points=m, permute=False)
                report = evaluate(make_eval_step(fps, pcrnet, cfg,
                                                 iterations=its),
                                  test, args.batch_size, device=device)
                logger.log(f"test (FPS-sampled {m}, iterations={its}): "
                           f"{report}")
                reports[f"fps{m}_iter{its}"] = report
        checkpoints.save_published(
            ckpt, best["sd"],
            {"bottleneck_size": pcrnet.bottleneck_size,
             "num_points": args.num_points, "best_epoch": best["epoch"],
             "best_val_rot": best["rot"]},
            filename=checkpoints.PCRNET_FILE)
        logger.log(f"saved checkpoint to {ckpt}")
        _write_report(log_dir, reports)
        logger.close()
        return state

    # phase == samplenet
    pcrnet = checkpoints.load_pcrnet(args.pcrnet_ckpt, device)
    logger.log(f"frozen PCRNet from {args.pcrnet_ckpt}")
    sampler, state = create_sampler_state(cfg, device=device, seed=args.seed)
    step = make_sampler_train_step(sampler, pcrnet, cfg)
    # validation and selection at the trained pass count
    eval_step = make_eval_step(sampler, pcrnet, cfg,
                               iterations=args.train_iterations)
    best = {"rot": float("inf"), "sd": None, "epoch": -1, "report": None}
    for epoch in range(args.epochs):
        mean = _train_epoch(step, state, train, args, np_rng, device)
        logger.log(f"epoch {epoch}: " +
                   " ".join(f"{k}={v:.4f}" for k, v in mean.items()))
        logger.metrics(state.step, **mean)
        report = evaluate(eval_step, test, args.batch_size, device=device)
        logger.log(f"  eval: rot_err={report['rot_err_mean']:.2f}deg "
                   f"auc={report['auc']:.4f} "
                   f"consistency={report['consistency_mean']:.5f}")
        if report["rot_err_mean"] < best["rot"]:
            best.update(rot=report["rot_err_mean"], epoch=epoch,
                        report=report, sd=_snapshot(sampler))
    if best["sd"] is None:
        # --epochs 0, or every validation NaN: the final state
        best.update(sd=_snapshot(sampler), epoch=-1,
                    report=evaluate(eval_step, test, args.batch_size,
                                    device=device))
    logger.log(f"best epoch {best['epoch']}: {best['report']}")
    reports = {"best": best["report"], "best_epoch": best["epoch"]}
    if args.iterations != 1:
        best_sampler, _ = create_sampler_state(cfg, device=device)
        best_sampler.load_state_dict(best["sd"])
        report = evaluate(make_eval_step(best_sampler, pcrnet, cfg,
                                         iterations=args.iterations),
                          test, args.batch_size, device=device)
        logger.log(f"best snapshot at iterations={args.iterations}: "
                   f"{report}")
        reports[f"best_iter{args.iterations}"] = report
    checkpoints.save_published(ckpt, best["sd"], vars(args))
    logger.log(f"saved checkpoint to {ckpt}")
    _write_report(log_dir, reports)
    logger.close()
    return state


if __name__ == "__main__":
    main()
