"""CLI: train SampleNet against a frozen PointNet classifier
(classification/train_samplenet.py pipeline), on the port.

    python -m samplenet_tpu_torch.train.train_samplenet --device cuda \\
        --classifier-ckpt log/classifier/ckpt --num-out-points 32

The frozen classifier comes from exactly one of two flags.
`--classifier-ckpt` is the port's published classifier checkpoint
(`train_classifier`'s ckpt: classifier.pth + config.json), vanilla or
T-net, as the JAX CLI's flag of that name takes its orbax checkpoint.
`--classifier-weights` is a bare `PointNetClassifier` state_dict of the
port (torch.save), its variant read off its keys; a JAX classifier's
variables convert to one with
`samplenet_tpu_torch.interop.pointnet_state_dict_from_jax`. Each epoch
writes `--log-dir`/snap_last (and snap_best when the eval accuracy
improves); `--resume` continues from snap_last. At the end the best
snapshot is published as `--log-dir`/ckpt (sampler.pth + config.json).

`--fused-train` takes the `--fused-mode` train chain for the sampler's
conv layers: ghost BN (the ghost-BN kernel, bf16 operands unless
`--fused-f32`) where the shapes allow it, else the exact-BN chain, which
is also the chain without the flag; so `--no-fused-train` is left out.
`--bf16` is the sampler's compute dtype (parameters f32; its conv chain
then runs as bf16 tensor ops, no kernel, as in the JAX package); the
frozen classifier stays f32. `--data-parallel` trains on every rank of
a torchrun launch (`torchrun --nproc-per-node=K -m
samplenet_tpu_torch.train.train_samplenet --data-parallel ...`; NCCL
with `--device cuda`, each rank on cuda:LOCAL_RANK, gloo with `--device
cpu`; without torchrun's environment a world of one): `--batch-size` is
the global batch, each rank trains on its rows of it with the global
BatchNorm statistics and averaged gradients (parallel/mesh.py), and only
rank 0 writes logs and checkpoints. The JAX CLI's --conv-layout selects
a TPU code path and is left out.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from samplenet_tpu_torch.data import CLASS_NAMES, load_split, make_dataset
from samplenet_tpu_torch.interop.jax_import import infer_pointnet_config
from samplenet_tpu_torch.models.pointnet_cls import PointNetClassifier
from samplenet_tpu_torch.parallel.mesh import (
    Mesh,
    barrier,
    initialize_distributed,
    local_device,
    make_mesh,
)
from samplenet_tpu_torch.train import checkpoints
from samplenet_tpu_torch.train.classification import (
    SampleNetConfig,
    create_samplenet_state,
    make_samplenet_eval_step,
    per_class_accuracy,
    train_samplenet_loop,
)
from samplenet_tpu_torch.utils import Logger


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_samplenet")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--dataset", default="procedural",
                   choices=["procedural", "modelnet40"])
    p.add_argument("--data-dir", default="data")
    p.add_argument("--num-points", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--num-out-points", type=int, default=32)
    p.add_argument("--bottleneck-size", type=int, default=128)
    p.add_argument("--group-size", type=int, default=7)
    p.add_argument("--alpha", type=float, default=30.0)
    p.add_argument("--lmbda", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--delta", type=float, default=0.0)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--skip-projection", action="store_true")
    p.add_argument("--bn-schedule", action="store_true",
                   help="TF-style scheduled BN decay 0.5->0.99")
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
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute dtype for the sampler (parameters "
                        "stay f32)")
    add_classifier_args(p)
    p.add_argument("--train-size", type=int, default=2000)
    p.add_argument("--test-size", type=int, default=400)
    p.add_argument("--log-dir", default="log/samplenet")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the snap_last snapshot in --log-dir")
    add_data_parallel_arg(p)
    return p.parse_args(argv)


def add_data_parallel_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the global batch over the ranks of a "
                        "torchrun launch (a world of one without it)")


def setup_device(args) -> tuple[torch.device, Mesh | None, bool]:
    """(device, mesh, owned): the run's device, its data-parallel mesh
    under --data-parallel (else None), and whether this call created the
    process group (and so destroys it at the end)."""
    if not args.data_parallel:
        if args.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but CUDA is not available")
        return torch.device(args.device), None, False
    owned = not dist.is_initialized() and initialize_distributed(args.device)
    device = local_device(args.device)
    return device, make_mesh(device=device), owned


def is_main(mesh: Mesh | None) -> bool:
    """Whether this process writes the logs and checkpoints: rank 0."""
    return mesh is None or mesh.rank == 0


def load_data(args):
    """(train, test, num_classes), clouds cut to --num-points."""
    if args.dataset == "modelnet40":
        train = load_split(args.data_dir, "train")
        test = load_split(args.data_dir, "test")
        num_classes = 40
    else:
        train = make_dataset(args.train_size, args.num_points, seed=args.seed)
        test = make_dataset(args.test_size, args.num_points,
                            seed=args.seed + 1)
        num_classes = len(CLASS_NAMES)
    train = (train[0][:, :args.num_points], train[1])
    test = (test[0][:, :args.num_points], test[1])
    return train, test, num_classes


def add_classifier_args(p: argparse.ArgumentParser) -> None:
    """--classifier-ckpt and --classifier-weights; exactly one is given."""
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--classifier-ckpt",
                   help="a classifier checkpoint of the port "
                        "(train_classifier's ckpt), vanilla or T-net")
    g.add_argument("--classifier-weights",
                   help="a PointNetClassifier state_dict of the port")


def load_classifier(args, device) -> PointNetClassifier:
    """The frozen classifier of --classifier-ckpt or --classifier-weights."""
    if args.classifier_ckpt is not None:
        return checkpoints.load_classifier(args.classifier_ckpt, device)
    sd = torch.load(args.classifier_weights, map_location="cpu",
                    weights_only=True)
    classifier = PointNetClassifier(**infer_pointnet_config(sd))
    classifier.load_state_dict(sd)
    return classifier.to(device)


def main(argv=None):
    args = parse_args(argv)
    device, mesh, owned = setup_device(args)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    main_rank = is_main(mesh)
    logger = Logger(args.log_dir if main_rank else None, "samplenet",
                    echo=main_rank)
    train, test, num_classes = load_data(args)
    classifier = load_classifier(args, device)

    scfg = SampleNetConfig(
        num_out_points=args.num_out_points,
        bottleneck_size=args.bottleneck_size,
        group_size=args.group_size,
        alpha=args.alpha, lmbda=args.lmbda,
        gamma=args.gamma, delta=args.delta,
        learning_rate=args.learning_rate,
        skip_projection=args.skip_projection,
        batch_size=args.batch_size,
        bn_schedule=args.bn_schedule,
        fused_train=True if args.fused_train else None,
        fused_mode=args.fused_mode,
        fused_bf16=False if args.fused_f32 else None,
        bf16=args.bf16,
    )
    sampler, state = create_samplenet_state(scfg, device=device,
                                            seed=args.seed)

    start_epoch = 0
    best = {"acc": -1.0}
    snap_last = os.path.join(args.log_dir, "snap_last")
    snap_best = os.path.join(args.log_dir, "snap_best")
    if args.resume and os.path.isdir(snap_last):
        state, extras = checkpoints.restore_train_state(snap_last, state)
        start_epoch = int(extras.get("epoch", -1)) + 1
        best["acc"] = float(extras.get("best_acc", -1.0))
        logger.log(f"resumed from {snap_last} at epoch {start_epoch} "
                   f"(best_acc={best['acc']:.4f})")

    def on_epoch_end(epoch, st, test_acc):
        extras = {"epoch": epoch, "best_acc": max(best["acc"], test_acc)}
        if main_rank:
            checkpoints.save_train_state(snap_last, st, extras=extras)
        if test_acc > best["acc"]:
            best["acc"] = test_acc
            if main_rank:
                checkpoints.save_train_state(snap_best, st, extras=extras)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    ranks = "" if mesh is None else f", data-parallel over {mesh.size} ranks"
    logger.log(f"training SampleNet {args.num_points}->{args.num_out_points} "
               f"against frozen classifier, device={name}{ranks}")
    state = train_samplenet_loop(
        sampler, state, scfg, classifier, train, test,
        epochs=args.epochs, logger=logger, device=device, seed=args.seed,
        steps_per_epoch=args.steps_per_epoch, start_epoch=start_epoch,
        epoch_callback=on_epoch_end, mesh=mesh)
    barrier(mesh)           # rank 0's snapshots are on disk for every rank
    # the published checkpoint is the best-eval snapshot, not the last epoch
    if os.path.isdir(snap_best):
        state, extras = checkpoints.restore_train_state(snap_best, state)
        logger.log(f"published checkpoint = best snapshot "
                   f"(eval_acc={best['acc']:.4f}, epoch {extras.get('epoch')})")
    eval_step = make_samplenet_eval_step(sampler, classifier)
    table = per_class_accuracy(eval_step, state, test, scfg.batch_size,
                               num_classes, device=device, mesh=mesh)
    for ci, acc in enumerate(table):
        logger.log(f"  class {ci}: acc={acc:.4f}")
    ckpt_path = os.path.join(args.log_dir, "ckpt")
    if main_rank:
        checkpoints.save_published(ckpt_path, sampler.state_dict(),
                                   vars(args))
    logger.log(f"saved checkpoint to {ckpt_path}")
    logger.close()
    barrier(mesh)
    if owned:
        dist.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
