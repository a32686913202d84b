#!/usr/bin/env python3
"""Where the exact-BN chain's kernel and plain f32 forwards part from the
float64 one, and what that does to the gradients, on the card.

    python3 tools/diagnostics/mask_flips.py

Run it from the root of a checkout on a machine with an NVIDIA H100. For
the exact chain (point_mlp_exact_train_max) at the card tests' shapes,
with their seeded inputs (B=8, N=2048 at the reconstruction widths
3-64-128-128-256-128; B=4, N=1 and B=64, N=1024 at the classification
widths), it runs the forward on the kernels, on the plain f32 version and
on the plain version in float64, and prints per layer: z's and the batch
statistics' errors against float64 (largest entry, relative to the
largest), and the ReLU masks that differ from float64's (points whose
pre-activation gamma * xhat + beta falls on the other side of zero). Then
the gradients against the float64 backward: the kernels on their own
forward, the plain version on its own, and the plain backward on the
kernel forward's state (which shows whether the forward or the backward
moved them).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

CASES = ((8, 2048, (3, 64, 128, 128, 256, 128)),
         (4, 1, (3, 64, 64, 64, 128, 128)),
         (64, 1024, (3, 64, 64, 64, 128, 128)))


def rel(t, r) -> float:
    r = r.double()
    return float((t.double() - r).abs().max() / r.abs().max())


def main() -> int:
    sys.path.insert(0, os.getcwd())
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme

    torch.backends.cuda.matmul.allow_tf32 = False
    for b, n, widths in CASES:
        # the card tests' inputs (tests/test_torch_port_cuda.py::_exact_args)
        rng = np.random.default_rng(b * 1000 + n)

        def rn(*s):
            return torch.from_numpy(rng.standard_normal(s)
                                    .astype(np.float32)).cuda()

        x = rn(b, n, widths[0])
        ws, gs, bes = [], [], []
        for ci, co in zip(widths[:-1], widths[1:]):
            ws.append(rn(ci, co) / ci ** 0.5)
            rn(co)
            gs.append(1 + 0.1 * rn(co))
            bes.append(0.1 * rn(co))
        g = rn(b, widths[-1])
        d = lambda ts: [t.double() for t in ts]  # noqa: E731
        fk = pme.point_mlp_exact_fwd_cuda(x, ws, gs, bes, 1e-5)[3]
        fp = pme.point_mlp_exact_fwd_plain(x, ws, gs, bes, 1e-5)[3]
        fr = pme.point_mlp_exact_fwd_plain(x.double(), d(ws), d(gs), d(bes),
                                           1e-5)[3]
        print(f"B={b}, N={n}, widths {widths}", flush=True)
        for i in range(len(ws)):
            def y(f, dt):
                return (gs[i].to(dt) * ((f[0][i] - f[1][i]) * f[2][i])
                        + bes[i].to(dt)) > 0
            yr = y(fr, torch.float64)
            print(f"  layer {i}: z against f64 kernel {rel(fk[0][i], fr[0][i]):.3e}"
                  f" plain {rel(fp[0][i], fr[0][i]):.3e}; mean kernel "
                  f"{rel(fk[1][i], fr[1][i]):.3e} plain {rel(fp[1][i], fr[1][i]):.3e}"
                  f"; rstd kernel {rel(fk[2][i], fr[2][i]):.3e} plain "
                  f"{rel(fp[2][i], fr[2][i]):.3e}; ReLU masks off f64's: kernel "
                  f"{int((y(fk, torch.float32) != yr).sum())}, plain "
                  f"{int((y(fp, torch.float32) != yr).sum())} of {yr.numel()}")
        gr = pme.point_mlp_exact_bwd_plain(x.double(), d(ws), d(gs), d(bes), fr,
                                           g.double())
        gk = pme.point_mlp_exact_bwd_cuda(x, ws, gs, bes, fk, g)
        gp = pme.point_mlp_exact_bwd_plain(x, ws, gs, bes, fp, g)
        gpk = pme.point_mlp_exact_bwd_plain(x, ws, gs, bes,
                                            (*fk[:3], fk[3].long()), g)
        names = ["dx"] + [f"dW{i}" for i in range(len(ws))]
        for name, a, p, pk, r in zip(names, [gk[0], *gk[1]], [gp[0], *gp[1]],
                                     [gpk[0], *gpk[1]], [gr[0], *gr[1]]):
            print(f"  {name} against f64: kernel {rel(a, r):.3e}, plain "
                  f"{rel(p, r):.3e}, plain backward on the kernel's forward "
                  f"{rel(pk, r):.3e}", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
