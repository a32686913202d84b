"""CLI: SampleNetProgressive training and prefix evaluation
(classification), on the port.

    python -m samplenet_tpu_torch.train.train_progressive --device cuda \\
        --classifier-weights classifier.pth --max-num-out-points 256

`--classifier-weights` is a `PointNetClassifier` state_dict of the port
(torch.save), as for train_samplenet; the JAX CLI's `--classifier-ckpt`
(orbax, possibly the T-net classifier) becomes it, and the T-net variant
is not ported yet. The evaluation logs `eval_acc@s` for every prefix size
s and writes the published checkpoint `--log-dir`/ckpt (sampler.pth +
config.json), at the end and every `--eval-every` epochs.

`--fused-train` takes the `--fused-mode` train chain for the sampler's
conv layers: ghost BN (the ghost-BN kernel, bf16 operands unless
`--fused-f32`) where the shapes allow it, else the exact-BN chain.
Without the flag the chain is the exact-BN one, which is what the JAX
CLI's `--no-fused-train` selects, so that flag is left out.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from samplenet_tpu_torch.data import iterate_batches
from samplenet_tpu_torch.train import checkpoints
from samplenet_tpu_torch.train.classification import _to_device
from samplenet_tpu_torch.train.progressive import (
    ProgressiveConfig,
    create_progressive_state,
    evaluate_prefixes,
    make_progressive_infer_step,
    make_progressive_train_step,
)
from samplenet_tpu_torch.train.train_samplenet import (
    load_classifier,
    load_data,
)
from samplenet_tpu_torch.utils import Logger


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_progressive")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--dataset", default="procedural",
                   choices=["procedural", "modelnet40"])
    p.add_argument("--data-dir", default="data")
    p.add_argument("--num-points", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--max-num-out-points", type=int, default=256)
    p.add_argument("--min-num-out-points", type=int, default=8)
    p.add_argument("--bottleneck-size", type=int, default=128)
    p.add_argument("--group-size", type=int, default=7)
    p.add_argument("--alpha", type=float, default=30.0)
    p.add_argument("--lmbda", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=0.5)
    p.add_argument("--delta", type=float, default=1.0 / 30.0)
    p.add_argument("--classifier-weights", required=True,
                   help="a PointNetClassifier state_dict of the port")
    p.add_argument("--train-size", type=int, default=2000)
    p.add_argument("--test-size", type=int, default=400)
    p.add_argument("--eval-every", type=int, default=0,
                   help="run the prefix eval and save the checkpoint every K "
                        "epochs (0 = only at the end)")
    p.add_argument("--fused-train", action="store_true",
                   help="the --fused-mode train chain for the sampler's conv "
                        "layers (ghost: the ghost-BN kernel)")
    p.add_argument("--fused-mode", choices=("ghost", "exact"),
                   default="ghost",
                   help="ghost (statistics per block of clouds) or exact "
                        "(global statistics, the default chain)")
    p.add_argument("--fused-f32", action="store_true",
                   help="f32 matmul operands in the ghost chain (default "
                        "bf16); this also changes its block of clouds")
    p.add_argument("--log-dir", default="log/progressive")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    logger = Logger(args.log_dir, "progressive")
    train, test, _ = load_data(args)
    classifier = load_classifier(args.classifier_weights, device)

    cfg = ProgressiveConfig(
        max_num_out_points=args.max_num_out_points,
        min_num_out_points=args.min_num_out_points,
        bottleneck_size=args.bottleneck_size,
        group_size=args.group_size,
        alpha=args.alpha, lmbda=args.lmbda,
        gamma=args.gamma, delta=args.delta,
        batch_size=args.batch_size,
        fused_train=True if args.fused_train else None,
        fused_mode=args.fused_mode,
        fused_bf16=False if args.fused_f32 else None,
    )
    sampler, state = create_progressive_state(cfg, device=device,
                                              seed=args.seed)
    step = make_progressive_train_step(sampler, classifier, cfg)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    logger.log(f"progressive sizes {cfg.sizes}, device={name}")
    infer = make_progressive_infer_step(sampler, cfg.max_num_out_points)
    ckpt = os.path.join(args.log_dir, "ckpt")

    def eval_and_save(tag: str) -> dict[int, float]:
        accs = evaluate_prefixes(infer, state, classifier, test[0], test[1],
                                 cfg.sizes, args.batch_size, device=device)
        for s in cfg.sizes:
            logger.log(f"{tag} eval_acc@{s}={accs[s]:.4f}")
        logger.metrics(state.step,
                       **{f"eval_acc@{s}": accs[s] for s in cfg.sizes})
        checkpoints.save_published(ckpt, sampler.state_dict(), vars(args))
        logger.log(f"saved checkpoint to {ckpt}")
        return accs

    np_rng = np.random.RandomState(0)
    for epoch in range(args.epochs):
        agg: dict[str, list] = {}
        for bi, (bx, by) in enumerate(iterate_batches(
                train[0], train[1], args.batch_size, rng=np_rng)):
            if args.steps_per_epoch and bi >= args.steps_per_epoch:
                break
            for k, v in step(state, *_to_device(bx, by, device)).items():
                agg.setdefault(k, []).append(v)
        mean = {k: float(torch.stack(v).mean()) for k, v in agg.items()}
        logger.log(f"epoch {epoch}: " +
                   " ".join(f"{k}={v:.4f}" for k, v in sorted(mean.items())))
        logger.metrics(state.step, **mean)
        if args.eval_every and (epoch + 1) % args.eval_every == 0 \
                and epoch + 1 < args.epochs:
            eval_and_save(f"epoch {epoch}:")
    eval_and_save("final")
    logger.close()
    return state


if __name__ == "__main__":
    main()
