#!/usr/bin/env python3
"""Which discrete choices set how far the registration sampler step's f32
gradients land from float64, on the kernel path and on the plain path.

    python3 tools/diagnostics/registration_choices.py [cuda|cpu]

Runs the step of test_torch_port_cuda.py's
test_registration_sampler_step_kernel_path_matches_plain_path (B=32 pairs
of 1024 randn points scaled by 0.5, random rotations, m=64, k=8, both
clouds sampled, against PCRNet from seed 2) on each f32 path with its
choices recorded (chip_smoke.py::choices: the 1-NN indices, the soft
projection's neighbours, PCRNet's ReLU masks and max-pool argmaxes), then
in float64 twice: once making its own choices (recorded too) and once
replaying the f32 path's. For each path it prints the largest norm-wise
gradient error against each f64 step, and how many choices of each kind
the f32 step made apart from the f64 step that made its own. Where the
errors against the own-choice f64 step are large and against the replay
small, moved choices, not f32 arithmetic, set the error. On the CPU
there is only the plain path.
"""

from __future__ import annotations

import contextlib
import copy
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the kinds of choice in the order a step records them: per cloud the
# soft projection, then the simplification loss's two 1-NN directions;
# then PCRNet's features on each cloud (five ReLU masks, one argmax), then
# its Chamfer loss's two directions
KINDS = (["neighbours", "1-NN", "1-NN"] * 2
         + (["PCRNet ReLU mask"] * 5 + ["PCRNet argmax"]) * 2
         + ["1-NN", "1-NN"])


def main() -> int:
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    if dev == "cuda" and not torch.cuda.is_available():
        print("registration_choices: no CUDA card (pass cpu for the plain "
              "path on the CPU)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import CANCELLED, choices
    from samplenet_tpu_torch.geometry import QuaternionTransform
    from samplenet_tpu_torch.models import PCRNet
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda
    from samplenet_tpu_torch.train import registration as reg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reg.RegistrationConfig()
    rng = np.random.default_rng(15)
    p0 = 0.5 * torch.from_numpy(rng.standard_normal((32, 1024, 3)).astype(
        np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((32, 4)).astype(
        np.float32)).to(dev)
    tw = torch.cat([q / q.norm(dim=-1, keepdim=True),
                    torch.zeros(32, 3, device=dev)], -1)
    p1 = QuaternionTransform(tw).rotate(p0)
    pcrnet = PCRNet(generator=torch.Generator().manual_seed(2)).to(dev)

    def run(dtype, plain, how):
        sampler, state = reg.create_sampler_state(cfg, device=dev, seed=1)
        sampler.to(dtype)
        step = reg.make_sampler_train_step(
            sampler, copy.deepcopy(pcrnet).to(dtype), cfg)
        with plain_on_cuda() if plain else contextlib.nullcontext(), how:
            step(state, *(t.to(dtype) for t in (p0, p1, tw)))
        return {k: p.grad.double() for k, p in sampler.named_parameters()}

    def worst(g, ref):       # gradients zero in exact arithmetic left out
        return max(((g[k] - ref[k]).norm() / ref[k].norm(), k)
                   for k in g if k not in CANCELLED)

    card = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    for plain in ((False, True) if dev == "cuda" else (True,)):
        made, own = [], []
        g32 = run(torch.float32, plain, choices(torch, record=made))
        g_own = run(torch.float64, True, choices(torch, record=own))
        g_rep = run(torch.float64, True, choices(torch, replay=made))
        apart: dict[str, int] = {}
        for kind, a, c in zip(KINDS, made, own):
            apart[kind] = apart.get(kind, 0) + int((a != c).sum())
        e_own, e_rep = worst(g32, g_own), worst(g32, g_rep)
        print(f"{'plain' if plain else 'kernel'} path ({card}): worst "
              f"gradient error against f64 making its own choices "
              f"{float(e_own[0])!r} at {e_own[1]}, against f64 replaying "
              f"the path's {float(e_rep[0])!r} at {e_rep[1]}; choices "
              f"apart from the own-choice f64 step: {apart}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
