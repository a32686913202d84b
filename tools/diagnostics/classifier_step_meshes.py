#!/usr/bin/env python3
"""How far the vanilla classifier's f32 train step lands from float64 on
one process and on 2 x 1, 1 x 2 and 2 x 2 meshes of gloo ranks sharing the
card, and how much of that error is one direction.

    python3 tools/diagnostics/classifier_step_meshes.py

Runs chip_smoke.py's tensor-parallel classifier step (PointNetClassifier
of 40 classes at its published widths, B=32 clouds of 1024 points,
augmentation and dropout from seeded generators) in f32 and f64 in this
process and in f32 on each mesh (the wide layers sharded over 'model'
where M > 1), and prints, for each conv layer's weight and the head's
fc1, the norm-wise distance of every f32 gradient from the one-process
f64 one, and the share of the one-process error's norm in its largest
singular value (the weight as [out, in]). A share near 1 says the error
is one outer product: a per-channel error (a BatchNorm's reductions over
every point) times a fixed input direction, so its size follows the
order in which those reductions add, which differs from mesh to mesh.
That is why chip_smoke.py holds this step's gradients in float64. Needs
a CUDA card.
"""

from __future__ import annotations

import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MESHES = ((2, 1), (1, 2), (2, 2))
NAMES = ("conv1.weight", "conv3.weight", "conv5.weight", "fc1.weight")


def _rank(mesh) -> dict:
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    return cs._tp_case(torch, mesh, "classifier")["grads"]


def _err(a: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float((a.double() - ref).norm() / ref.norm())


def main() -> int:
    if not torch.cuda.is_available():
        print("classifier_step_meshes: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from samplenet_tpu_torch.parallel.launch import spawn

    torch.backends.cuda.matmul.allow_tf32 = False
    one = {}
    for dtype in (None, torch.float64):
        net, state, step, args, extra = cs._tp_setup(torch, "classifier",
                                                     dtype=dtype)
        step(state, *args, *extra())
        torch.cuda.synchronize()
        one[dtype] = {k: p.grad.detach().cpu() for k, p in
                      net.named_parameters()}
    ranks = {dm: spawn(_rank, dm[0] * dm[1], device="cuda", model=dm[1],
                       timeout=300.0)[0] for dm in MESHES}
    print(cs.card_line())
    for name in NAMES:
        ref = one[torch.float64][name]
        e = (one[None][name].double() - ref.double()).reshape(
            ref.shape[0], -1)
        sv = torch.linalg.svdvals(e)
        meshes = " ".join(f"{d}x{m} {_err(g[name], ref):.4g}"
                          for (d, m), g in ranks.items())
        print(f"{name}: one process {_err(one[None][name], ref):.4g} "
              f"(largest singular value's share {float(sv[0] / sv.norm()):.4f})"
              f"; {meshes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
