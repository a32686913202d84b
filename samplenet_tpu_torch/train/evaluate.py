"""Evaluation protocols and inference dumps of the classification track.

Mirrors samplenet_tpu/train/evaluate.py:31-216:
  * rotation-voting classifier eval (classification/evaluate_classifier.py:
    150-199: logits summed over num_votes rotations about the up axis);
  * SampleNet eval with the matched output (unique 1-NN + FPS, or the EMD
    transport argmax) and the mean number of unique NN indices per cloud
    (evaluate_samplenet.py:215-282);
  * the non-learned FPS and random baselines;
  * ordered inference of the four trees simplified / soft_projected /
    hard_projected / sampled (infer_samplenet_progressive.py:94-255), and
    accuracy at prefix sizes of such an ordered cloud (evaluate_from_files.
    py:109-191).

The last two are split in a core that works in memory (`infer_ordered`,
`evaluate_prefix_accuracy`) and a thin h5 writer or reader
(`infer_and_dump`, `evaluate_from_files`), so that the cores run where
h5py is not installed. Each function takes the port's modules and the
device the batches go to; every batch is padded to `batch_size` and
sliced (full coverage). On a CUDA tensor the SampleNet forward runs
`point_mlp_max`, the hard matching and `mean_unique_nn` the
`nn_direction` kernel, the FPS completion and baseline the `fps` kernel,
and the ordered inference also `nn_snap` and the soft projection's
forward; the classifier is plain torch.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from samplenet_tpu_torch.data import augment, iterate_batches_padded
from samplenet_tpu_torch.data.modelnet import load_h5, save_h5
from samplenet_tpu_torch.ops.cuda.chamfer_kernel import nn_direction
from samplenet_tpu_torch.ops.fps import (
    farthest_point_sample_with_points,
    gather_point,
)
from samplenet_tpu_torch.ops.matching import (
    emd_matching,
    first_occurrence_mask,
)
from samplenet_tpu_torch.train.classification import _to_device
from samplenet_tpu_torch.train.progressive import make_progressive_infer_step


def _per_class(labels: np.ndarray, ok: np.ndarray,
               num_classes: int) -> np.ndarray:
    seen = np.zeros(num_classes)
    right = np.zeros(num_classes)
    np.add.at(seen, labels, 1)
    np.add.at(right, labels, ok)
    return right / np.maximum(seen, 1)


def evaluate_classifier_voting(classifier, data: np.ndarray,
                               labels: np.ndarray, batch_size: int,
                               num_votes: int = 12, *, device) -> dict:
    """Logits summed (on the host, in f32) over `num_votes` copies of each
    batch rotated about Y by vote / num_votes * 2 pi; the argmax decides.
    Per-class accuracy over the logits' width."""
    preds, kept = [], []
    num_classes = None
    for bx, by, real in iterate_batches_padded(data, labels, batch_size):
        vote_sum = None
        for vote in range(num_votes):
            rotated = augment.rotate_point_cloud_by_angle(
                bx, vote / num_votes * 2 * np.pi)
            with torch.inference_mode():
                lg, _ = classifier(torch.from_numpy(rotated).to(device))
            lg = lg.cpu().numpy()
            vote_sum = lg if vote_sum is None else vote_sum + lg
        num_classes = vote_sum.shape[1]
        preds.append(vote_sum.argmax(1)[:real])
        kept.append(by[:real])
    pred, kept = np.concatenate(preds), np.concatenate(kept)
    ok = pred == kept
    return {"accuracy": float(ok.sum()) / max(len(kept), 1),
            "per_class_accuracy": _per_class(kept, ok, num_classes)}


def evaluate_samplenet_matched(sampler, classifier, data: np.ndarray,
                               labels: np.ndarray, batch_size: int, *,
                               match_output: bool = True,
                               matching: str = "nn", device) -> dict:
    """The classifier on the sampler's matched output (or, without
    `match_output`, its simplified cloud), and the number of unique 1-NN
    indices of each simplified point in its cloud.

    matching="nn" is the eval forward's unique + FPS completion; "emd"
    takes each simplified point's strongest approximate-EMD partner
    (ops/matching.py::emd_matching, with the JAX package's argmax axis).

    Returns accuracy, loss (the mean per-cloud NLL), mean_unique_nn and
    per_class_accuracy (over max(labels) + 1 classes), as the JAX
    package; and per cloud, in data order: correct, nll, unique_nn and
    the classified points `sampled` [n, k, 3]."""
    if matching not in ("nn", "emd"):
        raise ValueError(f"matching must be 'nn' or 'emd', got {matching!r}")
    outs: dict[str, list] = {k: [] for k in
                             ("correct", "nll", "unique_nn", "sampled")}
    for bx, by, real in iterate_batches_padded(data, labels, batch_size):
        x, y = _to_device(bx, by, device)
        with torch.inference_mode():
            simp, matched = sampler(x)
            if matching == "emd":
                matched = emd_matching(x, simp)
            out = matched if match_output else simp
            logits, _ = classifier(out)
            _, idx = nn_direction(simp, x)
            uniq = first_occurrence_mask(idx).sum(dim=1)
            # per-cloud NLL (not the batch mean), so padding can be sliced
            nll = -F.log_softmax(logits, dim=1).gather(1, y[:, None])[:, 0]
            ok = logits.argmax(-1) == y
        for key, val in zip(outs, (ok, nll, uniq, out)):
            outs[key].append(val[:real].cpu().numpy())
    report = {k: np.concatenate(v) for k, v in outs.items()}
    return {"accuracy": float(np.mean(report["correct"])),
            "loss": float(np.mean(report["nll"])),
            "mean_unique_nn": float(np.mean(report["unique_nn"])),
            "per_class_accuracy": _per_class(
                np.asarray(labels), report["correct"],
                int(max(labels)) + 1),
            **report}


def evaluate_baseline_sampler(classifier, data: np.ndarray,
                              labels: np.ndarray, batch_size: int,
                              num_out_points: int, *, sampler: str = "fps",
                              seed: int = 0, device) -> dict:
    """Non-learned sampling baselines (registration/src/fps.py:8-43,
    random_sampling.py:7-46; the paper's Fig. 4 rows). "fps": greedy FPS
    from index 0; "random": a uniform choice without replacement a cloud,
    from one RandomState(seed) carried across the batches (padding
    included), so the indices are the JAX package's. Returns accuracy,
    sampler, m, and the classified points `sampled` [n, m, 3]."""
    if sampler not in ("fps", "random"):
        raise ValueError(f"unknown baseline sampler {sampler!r}")
    rng = np.random.RandomState(seed)
    oks, picked = [], []
    for bx, by, real in iterate_batches_padded(data, labels, batch_size):
        x, y = _to_device(bx, by, device)
        with torch.inference_mode():
            if sampler == "fps":
                sampled = farthest_point_sample_with_points(
                    num_out_points, x)[1]
            else:
                idx = np.stack([rng.choice(x.shape[1], num_out_points,
                                           replace=False)
                                for _ in range(x.shape[0])])
                sampled = gather_point(x, torch.from_numpy(idx).to(device))
            logits, _ = classifier(sampled)
            ok = logits.argmax(-1) == y
        oks.append(ok[:real].cpu().numpy())
        picked.append(sampled[:real].cpu().numpy())
    return {"accuracy": float(np.mean(np.concatenate(oks))),
            "sampler": sampler, "m": num_out_points,
            "sampled": np.concatenate(picked)}


DUMP_TREES = ("simplified", "soft_projected", "hard_projected", "sampled")


def infer_ordered(sampler, data: np.ndarray, labels: np.ndarray, *,
                  num_out_points: int, batch_size: int = 32, device
                  ) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """The ordered outputs of every cloud, {tree: [n, m, 3]} for the
    four DUMP_TREES (train/progressive.py::make_progressive_infer_step),
    and the labels, in data order."""
    infer = make_progressive_infer_step(sampler, num_out_points)
    outs: dict[str, list] = {k: [] for k in DUMP_TREES}
    kept = []
    for bx, by, real in iterate_batches_padded(data, labels, batch_size):
        x = torch.from_numpy(np.ascontiguousarray(bx)).to(device)
        for key, val in zip(DUMP_TREES, infer(None, x)):
            outs[key].append(val[:real].cpu().numpy())
        kept.append(by[:real])
    return ({k: np.concatenate(v) for k, v in outs.items()},
            np.concatenate(kept))


def write_dumps(out_dir: str, outs: dict[str, np.ndarray],
                labels: np.ndarray) -> dict[str, str]:
    """out_dir/<tree>/dump.h5 for each tree (float32 data, uint8 labels)."""
    paths = {}
    for key in DUMP_TREES:
        d = os.path.join(out_dir, key)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "dump.h5")
        save_h5(path, outs[key], labels, data_dtype="float32",
                label_dtype="uint8")
        paths[key] = path
    return paths


def infer_and_dump(sampler, data: np.ndarray, labels: np.ndarray,
                   out_dir: str, *, num_out_points: int,
                   batch_size: int = 32, device) -> dict[str, str]:
    """`infer_ordered`, written as the four h5 dump trees."""
    outs, kept = infer_ordered(sampler, data, labels,
                               num_out_points=num_out_points,
                               batch_size=batch_size, device=device)
    return write_dumps(out_dir, outs, kept)


def evaluate_prefix_accuracy(classifier, data: np.ndarray,
                             labels: np.ndarray, sizes, batch_size: int = 32,
                             *, device) -> dict[int, float]:
    """Accuracy of the classifier on the first `size` points of each
    ordered cloud, for every size."""
    out = {}
    for size in sizes:
        oks = []
        for bx, by, real in iterate_batches_padded(data, labels, batch_size):
            x, y = _to_device(bx[:, :size], by, device)
            with torch.inference_mode():
                logits, _ = classifier(x)
                oks.append((logits.argmax(-1) == y)[:real].cpu().numpy())
        out[size] = float(np.mean(np.concatenate(oks)))
    return out


def evaluate_from_files(classifier, dump_path: str, sizes,
                        batch_size: int = 32, *, device) -> dict[int, float]:
    """`evaluate_prefix_accuracy` on a dumped ordered cloud file."""
    data, labels = load_h5(dump_path)
    return evaluate_prefix_accuracy(classifier, data, labels, sizes,
                                    batch_size, device=device)
