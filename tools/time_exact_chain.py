#!/usr/bin/env python3
"""Time the train MLP chains of a checkout on the card.

    python3 tools/time_exact_chain.py CHECKOUT TAG

Imports samplenet_tpu_torch from CHECKOUT (building its kernels there) and
prints, under TAG, for point_mlp_exact_train_max at the classification
train shape (B=1024, N=1024, widths 3-64-64-64-128-128) and the
reconstruction track's (B=50, N=2048, widths 3-64-128-128-256-128): the
time per call of the forward, of forward + backward, and of the backward
kernels alone (`point_mlp_exact_bwd_cuda` on a saved forward), CUDA
events around each call, host time included, median of 20 calls after 3
warm-ups; then the backward's device time under torch.profiler, split by
pass (chip_smoke.py's `_bwd_split`, read from this script's own checkout).
Last, the ghost chain's backward (`point_mlp_train_bwd_cuda`, bf16, block
4) at the progressive step's shape (B=32, N=1024), per call. To compare
two checkouts on one card, run it four times in a row: A, B, B, A.
"""

from __future__ import annotations

import importlib.util
import os
import sys

SHAPES = ((1024, 1024, (3, 64, 64, 64, 128, 128)),
          (50, 2048, (3, 64, 128, 128, 256, 128)))
GHOST = (32, 1024, (3, 64, 64, 64, 128, 128), 4)
TOOL_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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

    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme
    from samplenet_tpu_torch.ops.cuda import point_mlp_train_kernel as pmt
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

    def inputs(b, n, widths):
        x = randn(b, n, widths[0]).requires_grad_()
        pairs = list(zip(widths[:-1], widths[1:]))
        params = ([randn(ci, co) / ci ** 0.5 for ci, co in pairs],
                  [0.1 * randn(co) for _, co in pairs],
                  [1 + 0.1 * randn(co) for _, co in pairs],
                  [0.1 * randn(co) for _, co in pairs])
        for group in params:
            for t in group:
                t.requires_grad_()
        return x, params, randn(b, widths[-1])

    for b, n, widths in SHAPES:
        x, params, g = inputs(b, n, widths)
        ws, _, gs, bes = [[t.detach() for t in grp] for grp in params]
        xd = x.detach()

        def forward():
            with torch.no_grad():
                pme.point_mlp_exact_train_max(x, *params)

        def both():
            pooled, _, _ = pme.point_mlp_exact_train_max(x, *params)
            (pooled * g).sum().backward()

        saved = pme.point_mlp_exact_fwd_cuda(xd, ws, gs, bes, 1e-5)[3]

        def backward():
            pme.point_mlp_exact_bwd_cuda(xd, ws, gs, bes, saved, g)

        print(f"[{tag}] B={b}, N={n}, widths {widths}: forward "
              f"{median_ms(forward)!r} ms, forward + backward "
              f"{median_ms(both)!r} ms, backward {median_ms(backward)!r} ms; "
              f"backward {cs._bwd_split(torch, backward, 5, len(widths) - 1)}",
              flush=True)
        del saved
        torch.cuda.empty_cache()

    b, n, widths, bb = GHOST
    x, params, g = inputs(b, n, widths)
    ws, _, gs, bes = [[t.detach() for t in grp] for grp in params]
    saved = pmt.point_mlp_train_fwd_cuda(x.detach(), ws, gs, bes, 1e-5, bb,
                                         True)[3]

    def ghost_backward():
        pmt.point_mlp_train_bwd_cuda(x.detach(), ws, gs, bes, 1e-5, bb, True,
                                     saved, g)

    print(f"[{tag}] ghost B={b}, N={n}, bf16, block {bb}: backward "
          f"{median_ms(ghost_backward)!r} ms per call; "
          f"{cs._bwd_split(torch, ghost_backward, 5, len(widths) - 1)}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
