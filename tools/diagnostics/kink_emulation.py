#!/usr/bin/env python3
"""How often an f32 forward that rounds otherwise than the plain path fails
the exact-BN chain's gradient rule, emulated on the CPU.

    python3 tools/diagnostics/kink_emulation.py [SEEDS]

The exact chain's gradients are held to "at most twice the plain f32
path's error against float64" (chip_smoke.py, tests/test_torch_port_cuda
.py). BN's ReLU masks decide that error: a pre-activation within f32 noise
of zero can land on either side, and such a point moves a gradient entry
by far more than rounding does. This runs, for SEEDS seeded inputs (30 by
default) at the reconstruction widths (B=4, N=2048, 3-64-128-128-256-128),
the exact forward with each layer's matmul computed as

- `f32`: the plain path (torch's f32 matmul);
- `3x`: the tensor-core tile with three TF32 products (csrc/mma_tile.cuh,
  which point_mlp_max runs: operands split as cvt.rna rounds, a_lo*b_hi +
  a_hi*b_lo + a_hi*b_hi per 8-channel step, the step truncated toward zero
  as the tensor cores sum, then added in f32);
- `4x`: the same with a_lo*b_lo as well;
- `exact`: the f64 product rounded once to f32 (the most accurate f32 z);

then the plain f64 backward on that forward's state, and prints per seed
each mode's worst gradient error against the f64 chain, marking with X
where it exceeds twice the `f32` mode's (or 1e-5), and the counts. The
first layer (3 input channels, FP32 FMAs on the card) is `f32` in all.
It is why the train chains' pmt_dense sums in the plain path's order: a
tensor-core forward as accurate as the plain path's fails the rule on
some inputs.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

MODES = ("3x", "4x", "exact")
B, N, WIDTHS = 4, 2048, (3, 64, 128, 128, 256, 128)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    return ((t.view(torch.int32) + 0x1000) & ~0x1fff).view(torch.float32)


def _toward_zero(t64: torch.Tensor) -> torch.Tensor:
    """f64 to f32, rounded toward zero."""
    t32 = t64.float()
    over = t32.double().abs() > t64.abs()
    return torch.where(over, torch.nextafter(t32, torch.zeros_like(t32)),
                       t32)


def matmul(a: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "f32":
        return a @ w
    if mode == "exact":
        return (a.double() @ w.double()).float()
    ah, wh = _tf32(a), _tf32(w)
    al, wl = _tf32(a - ah), _tf32(w - wh)
    pairs = [(al, wh), (ah, wl), (ah, wh)]
    if mode == "4x":
        pairs.append((al, wl))
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        step = sum(x[:, k].double() @ y[k].double() for x, y in pairs)
        acc = acc + _toward_zero(step)
    return acc


def forward(x, ws, gs, bes, mode):
    """The exact chain's saved state (zs, means, rstds, argmax), its BN
    statistics from f64 sums as the kernel takes them."""
    b, n, c0 = x.shape
    count = b * n
    h = x.reshape(count, c0)
    zs, mus, rstds = [], [], []
    for i, (w, g, be) in enumerate(zip(ws, gs, bes)):
        z = matmul(h, w, "f32" if i == 0 else mode)
        z64 = z.double()
        mu = z64.sum(0) / count
        var = (z64 * z64).sum(0) / count - mu * mu
        mu, var = mu.float(), var.float()
        rstd = torch.rsqrt(var + 1e-5)
        h = torch.relu(g * ((z - mu) * rstd) + be)
        zs.append(z)
        mus.append(mu)
        rstds.append(rstd)
    return zs, mus, rstds, torch.argmax(h.reshape(b, n, -1), dim=1)


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme

    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    fails = dict.fromkeys(MODES, 0)
    flipped = 0
    d = lambda ts: [t.double() for t in ts]  # noqa: E731
    for seed in range(seeds):
        rng = np.random.default_rng(1000 + seed)

        def rn(*shape):
            return torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32))

        x = rn(B, N, 3)
        ws, gs, bes = [], [], []
        for ci, co in zip(WIDTHS[:-1], WIDTHS[1:]):
            ws.append(rn(ci, co) / ci ** 0.5)
            rn(co)
            gs.append(1 + 0.1 * rn(co))
            bes.append(0.1 * rn(co))
        g = rn(B, WIDTHS[-1])
        ref = pme.point_mlp_exact_fwd_plain(x.double(), d(ws), d(gs), d(bes),
                                            1e-5)[3]
        gr = pme.point_mlp_exact_bwd_plain(x.double(), d(ws), d(gs), d(bes),
                                           ref, g.double())

        def errors(mode):
            zs, mus, rstds, am = forward(x, ws, gs, bes, mode)
            grads = pme.point_mlp_exact_bwd_plain(
                x.double(), d(ws), d(gs), d(bes), (d(zs), d(mus), d(rstds),
                                                   am), g.double())
            return [float((a - r).abs().max() / r.abs().max())
                    for a, r in zip([grads[0], *grads[1]], [gr[0], *gr[1]])]

        ep = errors("f32")
        flipped += max(ep) > 1e-5
        line = [f"f32 {max(ep):.1e}"]
        for mode in MODES:
            ek = errors(mode)
            bad = any(k > max(2 * p, 1e-5) for k, p in zip(ek, ep))
            fails[mode] += bad
            line.append(f"{mode} {max(ek):.1e}{' X' if bad else ''}")
        print(f"seed {seed}: " + ", ".join(line), flush=True)
    print(f"{seeds} seeds: the f32 path itself off f64 by more than 1e-5 "
          f"in {flipped}; past twice its error: "
          + ", ".join(f"{m} {fails[m]}" for m in MODES), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
