"""Checkpoints of the port, with torch.save.

Mirrors the snapshot contract of samplenet_tpu/train/checkpoints.py:79-124
(registration/main.py:201-218's snap_best / snap_last): a snapshot is a
directory holding state.pt (the model's state_dict, the optimiser's state
and the step) and extras.json (epoch, best accuracy, ...). The published
checkpoint is a directory holding sampler.pth, a bare state_dict that
`serve --weights` loads, and config.json, the run's arguments.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from samplenet_tpu_torch.train.state import TrainState


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


def save_published(path: str, model_state: dict[str, torch.Tensor],
                   config: dict[str, Any]) -> None:
    """The published checkpoint: sampler.pth and config.json."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model_state.items()},
               os.path.join(path, "sampler.pth"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1, default=str)
