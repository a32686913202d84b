#!/usr/bin/env python3
"""Time the approximate-EMD kernel of a checkout on the card.

    python3 tools/time_emd.py CHECKOUT TAG

Imports samplenet_tpu_torch from CHECKOUT (building its kernels there),
prints the build's ptxas lines for the EMD kernels (registers, spills)
and then, under TAG, at B=50 clouds, 2048 x 2048 points (the
reconstruction track's shape), on two inputs:

- "randn": chip_smoke.py's timing inputs (`phase_times_recon`: two
  standard-normal clouds from numpy's default_rng(SEED + 21));
- "ae": the AE step's own pair, the procedural clouds of chip_smoke.py's
  reconstruction phases and the seeded AE's reconstruction of them
  (`model(x, training=True)` at its initialisation, as the first AE step
  sees it), as the AE loss takes them: xyz1 the reconstruction, xyz2 x.

For each input and with and without gradients: the kernel's median of
20 calls after 3 warm-ups, CUDA events around each call (the wrapper's
glue included), and its device time per call under torch.profiler; the
SHA-1 digests of cost, g1 and g2 (equal digests from two checkouts mean
bit-equal results); and, where the checkout's kernel skips warp units
whose weights underflow, the share of units it skips per level,
estimated with plain torch ops from the same d2 and the same test
(level * d2 below the kernel's constant, d2 finite), in the order the
kernel sees the clouds, and the share of the 20 exp per pair that
those skips save.

To compare two checkouts on one card, run it four times in a row: A, B,
B, A.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import sys

TOOL_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, WARMUP = 20, 3


def digest(*outs) -> str:
    """SHA-1 (first 12 hex digits) of the bytes of every tensor in outs."""
    h = hashlib.sha1()
    for t in outs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def skip_shares(torch, ek, lib, x1, x2) -> str:
    """Per level, the share of warp units (the kernel's row group x 32
    columns) whose every pair has level * d2 below the kernel's underflow
    constant and a finite d2, on the clouds in the order the kernel
    takes them; and the share of the function's 20 exp per pair they
    skip (the first level's pass, each level's own weights and the next
    level's in the level before it)."""
    under = float(lib.snt_emd_underflow())
    rows = int(lib.snt_emd_unit_rows())
    order = getattr(ek, "morton_order", None)
    if order is not None:
        x1 = ek.take_rows(x1, order(x1))
        x2 = ek.take_rows(x2, order(x2))
    b, n, m = x1.shape[0], x1.shape[1], x2.shape[1]
    # rows past the cloud's end sit at the origin in the kernel; columns
    # past it take no part
    x1 = torch.nn.functional.pad(x1, (0, 0, 0, -n % rows))
    levels = ek.LEVELS[:-1]
    dead_units = [0] * len(levels)
    for i in range(b):                         # one cloud's d2 at a time
        d2 = ek.sqdist_broadcast(x1[i:i + 1], x2[i:i + 1])[0]
        for li, level in enumerate(levels):
            dead = ((level * d2) < under) & (d2 < float("inf"))
            dead = torch.nn.functional.pad(dead, (0, -m % 32), value=True)
            dead = dead.view(-1, rows, dead.shape[1] // 32, 32)
            dead_units[li] += int(dead.all(dim=3).all(dim=1).sum())
    total = b * (x1.shape[1] // rows) * (-(-m // 32))
    shares = [d / total for d in dead_units]
    saved = (shares[0] + sum(shares) + sum(shares[1:])) / 20
    return (f"units skipped per level {[round(s, 4) for s in shares]} "
            f"(L = {list(levels)}); exp skipped {saved!r} of 20 a "
            f"pair")


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

    from samplenet_tpu_torch.ops.cuda import emd_kernel as ek
    from samplenet_tpu_torch.ops.cuda._build import library, library_path
    from samplenet_tpu_torch.train import reconstruction as rec

    lib = library()
    log = (library_path().parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):        # each entry's properties follow it
        if "Compiling entry" in line and "emd_" in line:
            print(f"[{tag}] ptxas: " + " | ".join(
                ln.strip() for ln in log[i:i + 4]
                if "spill" in ln or "registers" in ln or "entry" in ln))
    card = cs.card_line()

    def median_ms(fn) -> float:
        for _ in range(WARMUP):
            fn()
        times = []
        for _ in range(ITERS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    rng = np.random.default_rng(cs.SEED + 21)
    inputs = {"randn": (cs._randn(torch, rng, cs.RECON_B, cs.RECON_N, 3),
                        cs._randn(torch, rng, cs.RECON_B, cs.RECON_N, 3))}
    _, x = cs.make_recon_data(torch)
    model, _ = rec.create_ae_state(rec.AEConfig(loss="emd",
                                                batch_size=cs.RECON_B),
                                   device="cuda", seed=cs.SEED)
    with torch.no_grad():
        inputs["ae"] = (model(x, training=True).contiguous(), x)
    del model
    for name, (x1, x2) in inputs.items():
        parts = []
        for grads in (True, False):
            def call(grads=grads):
                return ek.emd_cost_cuda(x1, x2, grads)

            ms = median_ms(call)
            dev = cs._device_ms(torch, call, 5)
            cost, g1, g2 = call()
            bits = (f"cost {digest(cost)}, g1 {digest(g1)}, g2 {digest(g2)}"
                    if grads else f"cost {digest(cost)}")
            parts.append(f"{'with' if grads else 'without'} gradients "
                         f"{ms!r} ms per call, {dev!r} ms device; bits: "
                         f"{bits}")
        if hasattr(lib, "snt_emd_underflow"):
            parts.append(skip_shares(torch, ek, lib, x1, x2))
        torch.cuda.empty_cache()
        print(f"[{tag}] emd {name} B={x1.shape[0]}, {x1.shape[1]} x "
              f"{x2.shape[1]}: " + "; ".join(parts) + f" ({card})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
