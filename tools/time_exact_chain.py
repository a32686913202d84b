#!/usr/bin/env python3
"""Time the exact-BN train chain of a checkout on the card.

    python3 tools/time_exact_chain.py CHECKOUT TAG

Imports samplenet_tpu_torch from CHECKOUT (building its kernels there) and
prints, under TAG, the time per call of point_mlp_exact_train_max forward,
and forward + backward, at the classification train shape (B=1024,
N=1024, widths 3-64-64-64-128-128) and the reconstruction track's (B=50,
N=2048, widths 3-64-128-128-256-128): CUDA events around each call, host
time included, median of 20 calls after 3 warm-ups. To compare two
checkouts on one card, run it four times in a row: A, B, B, A.
"""

from __future__ import annotations

import os
import sys

SHAPES = ((1024, 1024, (3, 64, 64, 64, 128, 128)),
          (50, 2048, (3, 64, 128, 128, 256, 128)))


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_train_max
    from samplenet_tpu_torch.ops.cuda._build import library

    library()
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).cuda()

    def median_ms(fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    for b, n, widths in SHAPES:
        x = randn(b, n, widths[0]).requires_grad_()
        pairs = list(zip(widths[:-1], widths[1:]))
        params = ([randn(ci, co) / ci ** 0.5 for ci, co in pairs],
                  [0.1 * randn(co) for _, co in pairs],
                  [1 + 0.1 * randn(co) for _, co in pairs],
                  [0.1 * randn(co) for _, co in pairs])
        for group in params:
            for t in group:
                t.requires_grad_()
        g = randn(b, widths[-1])

        def forward():
            with torch.no_grad():
                point_mlp_exact_train_max(x, *params)

        def both():
            pooled, _, _ = point_mlp_exact_train_max(x, *params)
            (pooled * g).sum().backward()

        print(f"[{tag}] B={b}, N={n}, widths {widths}: forward "
              f"{median_ms(forward)!r} ms, forward + backward "
              f"{median_ms(both)!r} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
