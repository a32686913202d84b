"""CLI: evaluation and inference dumps of the classification track, on the
port.

    python -m samplenet_tpu_torch.train.evaluate_cli classifier \\
        --ckpt log/classifier/ckpt
    python -m samplenet_tpu_torch.train.evaluate_cli samplenet \\
        --ckpt log/samplenet/ckpt --classifier-ckpt log/classifier/ckpt
    python -m samplenet_tpu_torch.train.evaluate_cli baseline --sampler fps \\
        --classifier-ckpt log/classifier/ckpt
    python -m samplenet_tpu_torch.train.evaluate_cli infer \\
        --ckpt log/progressive/ckpt --out-dir log/dumps
    python -m samplenet_tpu_torch.train.evaluate_cli from-files \\
        --dump log/dumps/sampled/dump.h5 --classifier-ckpt log/classifier/ckpt

Mirrors samplenet_tpu/train/evaluate_cli.py on the port's checkpoints:
the classifier is `train_classifier`'s ckpt (classifier.pth +
config.json, vanilla or T-net); the sampler is the published ckpt of
`train_samplenet` (samplenet mode) or `train_progressive` (infer mode),
sampler.pth + config.json. The sampler's widths and m are read off its
weights and its group size off its config (sigma = t^2, the
classification track's), so the JAX CLI's --bottleneck-size and
--group-size are left out; infer runs the sampler at the config's
max_num_out_points, which `train_progressive` writes, and refuses a
checkpoint without it. infer and from-files need h5py.
"""

from __future__ import annotations

import argparse

import torch

from samplenet_tpu_torch.interop.jax_import import infer_samplenet_config
from samplenet_tpu_torch.models.samplenet import SampleNet
from samplenet_tpu_torch.train import checkpoints
from samplenet_tpu_torch.train.evaluate import (
    evaluate_baseline_sampler,
    evaluate_classifier_voting,
    evaluate_from_files,
    evaluate_samplenet_matched,
    infer_and_dump,
)
from samplenet_tpu_torch.train.train_samplenet import load_data
from samplenet_tpu_torch.utils import Logger


def parse_args(argv=None):
    p = argparse.ArgumentParser("evaluate")
    p.add_argument("mode", choices=["classifier", "samplenet", "baseline",
                                    "infer", "from-files"])
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--sampler", choices=["fps", "random"], default="fps",
                   help="baseline mode: non-learned sampler to evaluate")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--classifier-ckpt", default="log/classifier/ckpt")
    p.add_argument("--dataset", default="procedural",
                   choices=["procedural", "modelnet40"])
    p.add_argument("--data-dir", default="data")
    p.add_argument("--num-points", type=int, default=1024)
    p.add_argument("--num-out-points", type=int, default=32,
                   help="baseline mode: points sampled a cloud")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-votes", type=int, default=12)
    p.add_argument("--matching", choices=["nn", "emd"], default="nn",
                   help="samplenet mode: hard-matching flavour; 'nn' is "
                        "unique-NN + FPS completion, 'emd' takes each "
                        "simplified point's strongest approx-EMD transport "
                        "partner (ops/matching.py::emd_matching)")
    p.add_argument("--test-size", type=int, default=400)
    p.add_argument("--train-size", type=int, default=16)  # unused
    p.add_argument("--sizes", type=int, nargs="+",
                   default=[8, 16, 32, 64, 128, 256])
    p.add_argument("--dump", default=None)
    p.add_argument("--out-dir", default="log/dumps")
    p.add_argument("--log-dir", default="log/eval")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def load_sampler(path: str, device, *, max_out: bool = False) -> SampleNet:
    """The classification-track sampler of a published checkpoint, its
    widths and m read off the weights and its group size off the config;
    with `max_out`, one of train_progressive's, at its
    max_num_out_points."""
    sd, config = checkpoints.load_published(path)
    kw = infer_samplenet_config(sd)
    if max_out:
        if "max_num_out_points" not in config:
            raise KeyError(f"{path}/config.json has no max_num_out_points: "
                           f"infer takes train_progressive's checkpoint")
        if int(config["max_num_out_points"]) != kw["num_out_points"]:
            raise ValueError(f"{path}: config max_num_out_points "
                             f"{config['max_num_out_points']}, the weights "
                             f"emit {kw['num_out_points']} points")
    sampler = SampleNet(**kw, group_size=int(config["group_size"]),
                        sigma_mode="tf")
    sampler.load_state_dict(sd)
    return sampler.to(device)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    logger = Logger(args.log_dir, f"eval_{args.mode}")
    _, test, _ = load_data(args)

    if args.mode == "classifier":
        classifier = checkpoints.load_classifier(
            args.ckpt or args.classifier_ckpt, device)
        report = evaluate_classifier_voting(
            classifier, test[0], test[1], args.batch_size, args.num_votes,
            device=device)
        logger.log(f"voting accuracy ({args.num_votes} votes): "
                   f"{report['accuracy']:.4f}")
        for ci, acc in enumerate(report["per_class_accuracy"]):
            logger.log(f"  class {ci}: {acc:.4f}")
    elif args.mode == "baseline":
        classifier = checkpoints.load_classifier(args.classifier_ckpt, device)
        report = evaluate_baseline_sampler(
            classifier, test[0], test[1], args.batch_size,
            args.num_out_points, sampler=args.sampler, seed=args.seed,
            device=device)
        logger.log(f"{args.sampler} baseline accuracy@{args.num_out_points}: "
                   f"{report['accuracy']:.4f}")
    elif args.mode == "samplenet":
        classifier = checkpoints.load_classifier(args.classifier_ckpt, device)
        sampler = load_sampler(args.ckpt, device)
        report = evaluate_samplenet_matched(
            sampler, classifier, test[0], test[1], args.batch_size,
            matching=args.matching, device=device)
        logger.log(f"matched accuracy@{sampler.num_out_points} "
                   f"({args.matching} matching): {report['accuracy']:.4f} "
                   f"(mean unique NN {report['mean_unique_nn']:.1f})")
        for ci, acc in enumerate(report["per_class_accuracy"]):
            logger.log(f"  class {ci}: {acc:.4f}")
    elif args.mode == "infer":
        sampler = load_sampler(args.ckpt, device, max_out=True)
        report = infer_and_dump(sampler, test[0], test[1], args.out_dir,
                                num_out_points=sampler.num_out_points,
                                batch_size=args.batch_size, device=device)
        for key, path in report.items():
            logger.log(f"dumped {key} -> {path}")
    else:
        classifier = checkpoints.load_classifier(args.classifier_ckpt, device)
        report = evaluate_from_files(classifier, args.dump, args.sizes,
                                     args.batch_size, device=device)
        for size, acc in report.items():
            logger.log(f"prefix {size}: accuracy={acc:.4f}")
    logger.close()
    return report


if __name__ == "__main__":
    main()
