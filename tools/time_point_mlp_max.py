#!/usr/bin/env python3
"""Time point_mlp_max of a checkout on the card, at the batches below and
at the SM count.

    python3 tools/time_point_mlp_max.py CHECKOUT TAG

Imports samplenet_tpu_torch from CHECKOUT (building its kernels there),
prints the build's ptxas lines for point_mlp_max's kernels (registers,
spills) and then, under TAG, at the registration eval's shape (B=32
clouds of 1024 points, widths 3-64-64-64-128-128), the NRE eval's (B=50,
2048 points, the AE encoder's 3-64-128-128-256-128) and the serving
path's (B=1024, 1024 points), each in f32 and with bf16 operands, on
standard-normal clouds and chip_smoke.py's seeded weights:

- the kernel's median of 20 calls after 3 warm-ups, CUDA events around
  each call (the wrapper's glue included), its device time per call under
  torch.profiler (every device event of the call: the kernel, and where
  the checkout splits a cloud over blocks the output's zeroing) and those
  events by name; the plain version's median per call and its device
  time;
- the blocks a cloud the checkout's plan gives (S; 1 where it has no
  split), a SHA-1 digest of the output (equal digests from two checkouts
  mean bit-equal results), and the bound at the shape, as
  chip_smoke.py::kernel_bounds counts point_mlp_max's (each input read
  once and the output written once; the multiply-adds as three TF32
  products, or one BF16 product with bf16 operands);

then the registration eval step (chip_smoke.py's seeded sampler and
PCRNet on its procedural pairs): its median wall time of 10 steps and its
device time per step.

To compare two checkouts on one card, run it four times in a row: A, B,
B, A.
"""

from __future__ import annotations

import importlib.util
import os
import sys

TOOL_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bound(cs, b: int, n: int, widths, bf16: bool) -> tuple[float, str]:
    """point_mlp_max's bound at (b, n, widths), as kernel_bounds counts it
    at the eval shape."""
    pairs = list(zip(widths[:-1], widths[1:]))
    macs = sum(a * c for a, c in pairs)
    params = sum(a * c + c for a, c in pairs)
    products = ((b * n * 2.0 * macs, cs.BF16_FLOP_PER_S) if bf16
                else (b * n * 3 * 2.0 * macs, cs.TF32_FLOP_PER_S))
    return cs._bound(4 * (b * n * 3 + params + b * widths[-1]), products,
                     (b * n * 3.0 * sum(widths[1:]), cs.FP32_FLOP_PER_S))


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(TOOL_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from samplenet_tpu_torch.ops.cuda import point_mlp_kernel as pmk
    from samplenet_tpu_torch.ops.cuda._build import library, library_path

    library()
    log = (library_path().parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):        # each entry's properties follow it
        if "Compiling entry" in line and "point_mlp_max" in line:
            print(f"[{tag}] ptxas: " + " | ".join(
                ln.strip() for ln in log[i:i + 4]
                if "spill" in ln or "registers" in ln or "entry" in ln))
    card = cs.card_line()
    rng = np.random.default_rng(cs.SEED + 51)

    def median_ms(fn, iters=20) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    for b, n, widths in ((cs.REG_B, cs.REG_N, cs.WIDTHS),
                         (cs.RECON_B, cs.RECON_N, cs.RECON_WIDTHS),
                         (cs.B, cs.N, cs.WIDTHS)):
        x = cs._randn(torch, rng, b, n, 3)
        wbs = cs._mlp_weights(torch, rng, "cuda", widths)
        for bf16 in (False, True):
            def kernel():
                return pmk.point_mlp_max(x, wbs, bf16=bf16)

            with torch.no_grad():
                ms = median_ms(kernel)
                def plain_fn():
                    return pmk.point_mlp_max_plain(x, wbs, bf16)

                plain = median_ms(plain_fn, 5)
                plain_dev = cs._device_ms(torch, plain_fn, 3)
                rows, why = cs._profiled(torch, kernel, 10)
                dev = sum(us for us, _, _ in rows) / 10 / 1e3
                split = (pmk.max_splits_for(x, widths, bf16)
                         if hasattr(pmk, "max_splits_for") else 1)
                bits = cs._digest(kernel())
            events = ", ".join(f"{name[:48]} {us / 10 / 1e3!r}"
                               for us, _, name in sorted(rows, reverse=True))
            lo = bound(cs, b, n, widths, bf16)
            print(f"[{tag}] point_mlp_max B={b}, N={n}, widths {widths}, "
                  f"bf16={bf16}, S={split}: {ms!r} ms per call, device "
                  f"{dev!r} ms ({events}{'' if why is None else '; ' + why})"
                  f"; plain {plain!r} ms per call, device {plain_dev!r} ms"
                  f"; bound {lo[0]!r} ms "
                  f"({lo[1]}); bits {bits} ({card})", flush=True)

    from samplenet_tpu_torch.train import registration as reg

    batch = cs._reg_data(torch)
    pcrnet = cs._reg_pcrnet(torch)
    sampler, _, _ = cs._reg_state(torch, "sampler", pcrnet=pcrnet)
    step = reg.make_eval_step(sampler, pcrnet, reg.RegistrationConfig())
    wall = median_ms(lambda: step(*batch), 10)
    dev = cs._device_ms(torch, lambda: step(*batch), 5)
    print(f"[{tag}] registration eval step, B={cs.REG_B}, {cs.REG_N} points: "
          f"{wall!r} ms per step, device {dev!r} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
