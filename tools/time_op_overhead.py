#!/usr/bin/env python3
"""What the samplenet:: torch.library ops cost on the host, against a
checkout whose wrappers launch the kernels directly.

    python3 tools/time_op_overhead.py CHECKOUT TAG

Imports samplenet_tpu_torch from CHECKOUT (building its kernels there) and
prints, under TAG, on the card:

- the eval forward with hard matching at the serving shape (chip_smoke.py's
  seeded SampleNet 1024 -> 32, bottleneck 128, B=1024 clouds of 1024
  points): its wall time per call (median of 30 calls, host clock around
  the call and a synchronize, after 5 warm-ups), its device time per
  call (torch.profiler, chip_smoke.py's `_device_ms`, 20 calls) and that
  device time by kernel (chip_smoke.py's `_profile_top`);
- the host time of one call of each eval wrapper, `point_mlp_max`,
  `nn_direction` and `fps`, at B=1 (the forward's shapes per cloud): the
  host clock around the call alone, the card idle before it (a
  synchronize between calls), the median of 500 calls after 20 warm-ups;
- SHA-1 digests (first 12 hex digits) of the eval forward's output and of
  `point_mlp_max` on tools/time_exact_chain.py's inputs: equal digests
  from two checkouts mean bit-equal results.

To compare two checkouts on one card, run it four times in a row: A, B,
B, A.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import sys
import time

TOOL_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(t) -> str:
    return hashlib.sha1(t.detach().contiguous().cpu().numpy()
                        .tobytes()).hexdigest()[:12]


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

    from samplenet_tpu_torch.ops.cuda import fps, nn_direction, point_mlp_max
    from samplenet_tpu_torch.ops.cuda._build import library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    library()
    card = cs.card_line()
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).cuda()

    y = randn(cs.B, cs.N, 3)                 # time_exact_chain.py's inputs
    wbs = cs._mlp_weights(torch, rng, "cuda")
    max_bits = digest(point_mlp_max(y, wbs))
    model = cs.make_model(torch, "cuda")
    clouds = randn(cs.B, cs.N, 3)

    def forward():
        with torch.inference_mode():
            return model(clouds)[1]

    for _ in range(5):
        forward()
    torch.cuda.synchronize()
    walls = []
    for _ in range(30):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    device = cs._device_ms(torch, forward, 20)
    print(f"[{tag}] card {card}; eval forward + matching B={cs.B}, "
          f"N={cs.N}, m={cs.M}: wall {float(np.median(walls))!r} ms per "
          f"call (median of 30; min {min(walls)!r}), device {device!r} ms "
          f"per call; bits {digest(forward())}; point_mlp_max bits "
          f"{max_bits}", flush=True)
    print(f"[{tag}] eval forward by kernel: "
          f"{cs._profile_top(torch, forward, 20)}", flush=True)

    x1 = randn(1, cs.N, 3)
    q1 = randn(1, cs.M, 3)
    given = torch.zeros((1, cs.M), dtype=torch.int32, device="cuda")
    count = torch.ones((1,), dtype=torch.int32, device="cuda")
    calls = {
        "point_mlp_max": lambda: point_mlp_max(x1, wbs),
        "nn_direction": lambda: nn_direction(q1, x1),
        "fps": lambda: fps(x1, given, count, cs.M),
    }
    parts = []
    with torch.inference_mode():
        for name, fn in calls.items():
            times = []
            for i in range(520):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                if i >= 20:
                    times.append((time.perf_counter() - t0) * 1e6)
            lo, med, hi = np.percentile(times, [25, 50, 75])
            parts.append(f"{name} {med!r} us (quartiles {lo!r}, {hi!r})")
    torch.cuda.synchronize()
    print(f"[{tag}] host time of one call at B=1, card idle before it: "
          + ", ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
