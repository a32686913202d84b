"""Checkpoints of the port, with torch.save.

Mirrors the snapshot contract of samplenet_tpu/train/checkpoints.py:79-124
(registration/main.py:201-218's snap_best / snap_last): a snapshot is a
directory holding state.pt (the model's state_dict, the optimiser's state
and the step) and extras.json (epoch, best accuracy, ...). The published
checkpoint is a directory holding a bare state_dict (sampler.pth, which
`serve --weights` loads, or the autoencoder's ae.pth) and config.json.
The reconstruction track's AE checkpoint carries the AE's shape and loss
in its config (num_points, bottleneck_size, loss, denoising_sigma,
outlier_ratio; train_reconstruction.py:209-217 of the JAX package), which
the sampler phase reads back. The classifier's checkpoint is
classifier.pth and a config with num_classes and use_tnets (and, for the
best snapshot, best_epoch and best_test_acc), as the JAX CLI writes it
(train_classifier.py:106-117); `load_classifier` builds that variant.
The registration track's PCRNet checkpoint is pcrnet.pth and a config
with its bottleneck_size (and the run's best epoch and validation
rotation error); `load_pcrnet` builds it, and phase 2 of
train_registration freezes it. `save_sharded` and `restore_sharded` are
the multi-process checkpoint on torch.distributed.checkpoint, written by
every rank and read in any world size and on any mesh: a tree holding
parallel/mesh.py::sharded_state_dict(model) in place of model.state_dict()
writes each block of a layer sharded over 'model' once (a DTensor,
Shard(0)), and reads into such a tree on another mesh, or into a plain
state_dict in one process, by resharding on read (orbax's contract,
samplenet_tpu/train/checkpoints.py:53-75).
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from samplenet_tpu_torch.interop.jax_import import (
    infer_pcrnet_config,
    infer_pointnet_config,
)
from samplenet_tpu_torch.models.pcrnet import PCRNet
from samplenet_tpu_torch.models.pointnet_cls import PointNetClassifier
from samplenet_tpu_torch.train.state import TrainState

CLASSIFIER_FILE = "classifier.pth"
PCRNET_FILE = "pcrnet.pth"


def save_train_state(path: str, state: TrainState, *,
                     extras: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, os.path.join(path, "state.pt"))
    with open(os.path.join(path, "extras.json"), "w") as f:
        json.dump(extras or {}, f, default=float)


def restore_train_state(path: str, state: TrainState
                        ) -> tuple[TrainState, dict]:
    """Loads a snapshot into `state`'s model and optimiser (same model and
    optimiser structure) and returns (state, extras)."""
    tree = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                      weights_only=True)
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    extras_path = os.path.join(path, "extras.json")
    extras = {}
    if os.path.exists(extras_path):
        with open(extras_path) as f:
            extras = json.load(f)
    return state, extras


def save_sharded(path: str, tree: dict[str, Any]) -> None:
    """Every rank calls this: torch.distributed.checkpoint writes the tree
    (nested dicts of tensors and DTensors) from all ranks at once, each
    replicated tensor and each block of a sharded one once, with no gather
    to one rank (the counterpart of samplenet_tpu/train/checkpoints.py:
    53-59 on orbax)."""
    import torch.distributed.checkpoint as dcp

    dcp.save(tree, checkpoint_id=os.path.abspath(path))


def restore_sharded(path: str, target: dict[str, Any]) -> dict[str, Any]:
    """Loads a save_sharded checkpoint into `target` (the same structure,
    tensors or DTensors of the same global shapes), in place, and returns
    it. Every rank of the reading world calls this; the world size and the
    mesh may differ from the writer's, one process without a process group
    included, as orbax reshards on read (:62-75)."""
    import torch.distributed.checkpoint as dcp

    dcp.load(target, checkpoint_id=os.path.abspath(path))
    return target


def save_published(path: str, model_state: dict[str, torch.Tensor],
                   config: dict[str, Any], *,
                   filename: str = "sampler.pth") -> None:
    """The published checkpoint: the state_dict as `filename`, and
    config.json."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model_state.items()},
               os.path.join(path, filename))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1, default=str)


def load_published(path: str, filename: str = "sampler.pth"
                   ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """(state_dict, config) of a published checkpoint."""
    sd = torch.load(os.path.join(path, filename), map_location="cpu",
                    weights_only=True)
    with open(os.path.join(path, "config.json")) as f:
        return sd, json.load(f)


def load_classifier(path: str, device) -> PointNetClassifier:
    """The classifier of a published checkpoint (classifier.pth +
    config.json), the variant its config names, on `device`."""
    sd, config = load_published(path, CLASSIFIER_FILE)
    variant = {"num_classes": int(config["num_classes"]),
               "use_tnets": bool(config["use_tnets"])}
    if infer_pointnet_config(sd) != variant:
        raise ValueError(f"{path}: config.json says {variant}, the weights "
                         f"{infer_pointnet_config(sd)}")
    classifier = PointNetClassifier(**variant)
    classifier.load_state_dict(sd)
    return classifier.to(device)


def load_pcrnet(path: str, device) -> PCRNet:
    """The PCRNet of a published checkpoint (pcrnet.pth + config.json) on
    `device`."""
    sd, config = load_published(path, PCRNET_FILE)
    variant = {"bottleneck_size": int(config["bottleneck_size"])}
    if infer_pcrnet_config(sd) != variant:
        raise ValueError(f"{path}: config.json says {variant}, the weights "
                         f"{infer_pcrnet_config(sd)}")
    pcrnet = PCRNet(**variant)
    pcrnet.load_state_dict(sd)
    return pcrnet.to(device)
