"""CLI: train the PointNet classifier (the frozen task network of the
classification SampleNet pipeline), on the port.

    python -m samplenet_tpu_torch.train.train_classifier --device cuda \\
        --use-tnets --bn-schedule --epochs 50 --log-dir log/classifier

Mirrors samplenet_tpu/train/train_classifier.py. The snapshot of the best
test accuracy is published as `--log-dir`/ckpt and the last epoch's as
`--log-dir`/ckpt_last, each classifier.pth + config.json (num_classes,
use_tnets; ckpt also best_epoch and best_test_acc). `train_samplenet`
and `train_progressive` take ckpt with `--classifier-ckpt`, and
`evaluate_cli` with `--classifier-ckpt` or `--ckpt`. `--bf16` (ROADMAP
Queue 1 item 11) and `--data-parallel` (item 9) are not ported yet and
raise.
"""

from __future__ import annotations

import argparse
import copy
import os

import torch

from samplenet_tpu_torch.train import checkpoints
from samplenet_tpu_torch.train.classification import (
    ClassifierConfig,
    create_classifier_state,
    train_classifier_loop,
)
from samplenet_tpu_torch.train.train_samplenet import load_data
from samplenet_tpu_torch.utils import Logger


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_classifier")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--dataset", default="procedural",
                   choices=["procedural", "modelnet40"])
    p.add_argument("--data-dir", default="data")
    p.add_argument("--num-points", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=0.001)
    p.add_argument("--use-tnets", action="store_true")
    p.add_argument("--bn-schedule", action="store_true",
                   help="TF-style scheduled BN decay 0.5->0.99")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute dtype (parameters stay f32)")
    p.add_argument("--train-size", type=int, default=2000,
                   help="procedural dataset size")
    p.add_argument("--test-size", type=int, default=400)
    p.add_argument("--log-dir", default="log/classifier")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-parallel", action="store_true",
                   help="not ported yet (ROADMAP Queue 1 item 9)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.data_parallel:
        raise ValueError("--data-parallel is not ported yet (ROADMAP Queue 1 "
                         "item 9)")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    logger = Logger(args.log_dir, "classifier")
    train, test, num_classes = load_data(args)
    cfg = ClassifierConfig(
        num_classes=num_classes,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        use_tnets=args.use_tnets,
        bn_schedule=args.bn_schedule,
        bf16=args.bf16,
    )
    model, state = create_classifier_state(cfg, device=device,
                                           seed=args.seed)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    logger.log(f"training classifier on {len(train[1])} clouds, "
               f"{num_classes} classes, use_tnets={args.use_tnets}, "
               f"device={name}")
    # the classifier becomes the FROZEN task network, so the best epoch,
    # not the last (which can dip from one noisy BN batch), is published
    best = {"acc": -1.0, "state": None, "epoch": -1}

    def on_epoch(epoch, st, test_acc):
        if test_acc > best["acc"]:
            best.update(acc=test_acc, epoch=epoch,
                        state=copy.deepcopy(st.model.state_dict()))

    state = train_classifier_loop(
        model, state, cfg, train, test, epochs=args.epochs, logger=logger,
        device=device, seed=args.seed, steps_per_epoch=args.steps_per_epoch,
        epoch_callback=on_epoch)
    config = {"num_classes": num_classes, "use_tnets": args.use_tnets}
    ckpt_path = os.path.join(args.log_dir, "ckpt")
    checkpoints.save_published(
        ckpt_path, best["state"],
        {**config, "best_epoch": best["epoch"], "best_test_acc": best["acc"]},
        filename=checkpoints.CLASSIFIER_FILE)
    checkpoints.save_published(
        os.path.join(args.log_dir, "ckpt_last"), model.state_dict(), config,
        filename=checkpoints.CLASSIFIER_FILE)
    logger.log(f"saved best (epoch {best['epoch']}, acc {best['acc']:.4f}) "
               f"to {ckpt_path}; last to ckpt_last")
    logger.close()
    return state


if __name__ == "__main__":
    main()
