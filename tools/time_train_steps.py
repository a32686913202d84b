#!/usr/bin/env python3
"""Time the train steps for a checkout, on the card.

    python3 tools/time_train_steps.py CHECKOUT TAG [READINGS]

Imports samplenet_tpu_torch from CHECKOUT (building its kernels there) and
builds, as chip_smoke.py does and from its helpers, the classification
train step (B=1024, 1024 -> 32 points, k=7, augmented, against a seeded
frozen PointNet), the reconstruction sampler step (B=50, 2048 -> 64
points, k=16, EMD, against a seeded AE), the progressive classification
step on the exact chain (B=32, 1024 points, sizes 8..1024, k=7) and the
progressive AE step (B=50, 2048 points, sizes 16..2048, k=16, against a
seeded AE). For each it prints, under TAG, the step's device time per
step under torch.profiler, its time per step with CUDA events (mean of 5
after warm-up), and the device time per step, with its share of the
step's, of two kernels by name: the 1-NN kernel (nn_direction_kernel,
its nn_direction and nn_snap entries) and the soft projection's backward
(soft_project_bwd*).

With READINGS, it times the classification step alone: READINGS wall
readings, each the mean of 5 steps with CUDA events after warm-up, all
printed, then their median. The step is host-bound, so its wall time
reads the host's work per step, the wrappers' glue included.

To compare two checkouts on one card, run it four times in a row: A, B,
B, A (with READINGS, alternate more pairs: A B B A B A A B).
"""

from __future__ import annotations

import importlib.util
import os
import sys

TOOL_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def kernels_ms(torch, fn, key: str, iters: int = STEPS) -> float:
    """Device ms per call of fn's CUDA kernels whose name holds `key`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and key in e.key) \
        / iters / 1e3


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    readings = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(TOOL_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    from samplenet_tpu_torch.ops.cuda._build import library
    from samplenet_tpu_torch.train import progressive as prog
    from samplenet_tpu_torch.train import reconstruction as rec

    library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    data, labels, classifier = cs.make_train_setup(torch)
    xd = torch.from_numpy(data).to(cs.DEVICE)
    yd = torch.from_numpy(labels).to(cs.DEVICE)
    _, cstate, cstep = cs._train_step(torch, classifier, augment=True)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
    if readings:
        walls = [cs._time_ms(torch, lambda: cstep(cstate, xd, yd, gen), 5)
                 for _ in range(readings)]
        print(f"[{tag}] classification step (B={cs.B}, {cs.N} -> {cs.M}, "
              f"k={cs.K}) wall ms per step: {walls!r}, median "
              f"{sorted(walls)[readings // 2]!r} ({card})", flush=True)
        return 0
    px, py = xd[:cs.PROG_B].contiguous(), yd[:cs.PROG_B].contiguous()
    _, pstate, pstep = cs._prog_step(torch, classifier)
    _, recon_x = cs.make_recon_data(torch)
    ae, _, _ = cs._recon_state(torch, "ae")
    pcfg = prog.ProgressiveAEConfig(batch_size=cs.RECON_B)
    scfg = rec.SampleNetAEConfig(num_out_points=pcfg.max_num_out_points,
                                 batch_size=cs.RECON_B)
    sampler, astate = rec.create_sampler_ae_state(scfg, device=cs.DEVICE,
                                                  seed=cs.SEED + 1)
    astep = prog.make_progressive_ae_train_step(sampler, ae, pcfg)
    _, rstate, rstep = cs._recon_state(torch, "sampler", ae)
    steps = {
        f"classification step (B={cs.B}, {cs.N} -> {cs.M}, k={cs.K})":
            lambda: cstep(cstate, xd, yd, gen),
        f"reconstruction sampler step (B={cs.RECON_B}, {cs.RECON_N} -> "
        f"{cs.RECON_M}, k={cs.RECON_K})":
            lambda: rstep(rstate, recon_x),
        f"progressive step, exact chain (B={cs.PROG_B}, {cs.PROG_N} "
        f"points, sizes 8..{cs.PROG_MAX}, k={cs.K})":
            lambda: pstep(pstate, px, py),
        f"progressive AE step (B={cs.RECON_B}, {cs.RECON_N} points, sizes "
        f"{pcfg.sizes[0]}..{pcfg.sizes[-1]}, k={cs.RECON_K})":
            lambda: astep(astate, recon_x),
    }
    for name, fn in steps.items():
        dev = cs._device_ms(torch, fn, STEPS)
        wall = cs._time_ms(torch, fn, 5)
        nn = kernels_ms(torch, fn, "nn_direction_kernel")
        bwd = kernels_ms(torch, fn, "soft_project_bwd")
        print(f"[{tag}] {name}: {dev!r} ms device per step, {wall!r} ms "
              f"per step; 1-NN kernel {nn!r} ms device per step "
              f"({nn / dev:.2%}); soft projection backward {bwd!r} ms "
              f"device per step ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
