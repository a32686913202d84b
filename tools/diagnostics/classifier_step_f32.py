#!/usr/bin/env python3
"""How far the T-net classifier's f32 train step lands from float64, on the
card and on the CPU, and how far float64 moves when its input does.

    python3 tools/diagnostics/classifier_step_f32.py

Runs the gradient of chip_smoke.py's classifier phase step (the T-net
PointNetClassifier of its seed, 40 classes, B=32 clouds of 1024 points of
the procedural data, dropout 0, augmentation off) five ways: f32 on the
card, f32 on the CPU, f64 on the CPU, f64 on the card, and f64 on the CPU
with every input coordinate moved by 1e-7 relative (seeded). It prints,
for the twelve parameters whose card f32 gradient is furthest from the
CPU f64 one (norm-wise), the card f32, CPU f32, card f32 against CPU f32,
card f64 and moved-input f64 distances. Where the two f32 runs sit as far
from each other as from f64 while the moved f64 input barely moves the
gradient, the f32 arithmetic of the step, not the function, limits the
agreement: that is why chip_smoke.py holds the card to twice the CPU f32
step's error and not to a fixed bound. Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    if not torch.cuda.is_available():
        print("classifier_step_f32: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from samplenet_tpu_torch.data import make_dataset
    from samplenet_tpu_torch.models.pointnet_cls import pointnet_loss
    from samplenet_tpu_torch.train.classification import ClassifierConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, labels = make_dataset(cs.B, cs.N, seed=cs.SEED)
    data, labels = data[:cs.CLS_B], labels[:cs.CLS_B].astype(np.int64)
    cfg = ClassifierConfig(num_classes=cs.NUM_CLASSES, batch_size=cs.CLS_B,
                           use_tnets=True, augment=False)

    def grads(x, dev, dtype):
        model, _ = cs._cls_state(torch, cfg, dev)
        model.dropout_rate = 0.0
        model.to(dtype)
        logits, ends = model(torch.from_numpy(x).to(dev, dtype),
                             training=True)
        pointnet_loss(logits, torch.from_numpy(labels).to(dev),
                      ends).backward()
        return {k: p.grad.detach().cpu().double()
                for k, p in model.named_parameters()}

    moved = data.astype(np.float64) * (
        1 + 1e-7 * np.random.RandomState(5).standard_normal(data.shape))
    runs = {name: grads(x, dev, dtype) for name, x, dev, dtype in (
        ("card f32", data, "cuda", torch.float32),
        ("cpu f32", data, "cpu", torch.float32),
        ("cpu f64", data, "cpu", torch.float64),
        ("card f64", data, "cuda", torch.float64),
        ("cpu f64, input moved 1e-7", moved, "cpu", torch.float64))}
    ref = runs["cpu f64"]
    scale = max(float(g.abs().max()) for g in ref.values())

    def err(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    rows = sorted(
        (err(runs["card f32"][k], ref[k]), err(runs["cpu f32"][k], ref[k]),
         err(runs["card f32"][k], runs["cpu f32"][k]),
         err(runs["card f64"][k], ref[k]),
         err(runs["cpu f64, input moved 1e-7"][k], ref[k]), k)
        for k in ref if float(ref[k].abs().max()) > 1e-10 * scale)
    print(f"{cs.card_line()}; torch {torch.__version__}")
    print("norm-wise distance to the CPU f64 gradient: card f32, CPU f32, "
          "card f32 to CPU f32, card f64, CPU f64 with the input moved")
    for row in rows[-12:]:
        print(" ".join(f"{v:.3g}" for v in row[:5]), row[5])
    return 0


if __name__ == "__main__":
    sys.exit(main())
