#!/usr/bin/env python3
"""Time the seeded-FPS kernel of a checkout on the card.

    python3 tools/time_fps.py CHECKOUT TAG

Imports samplenet_tpu_torch from CHECKOUT (building its kernels there),
prints the build's ptxas lines for the FPS kernels (registers, spills)
and then, under TAG, for each shape and count mix of SHAPES below, on
standard-normal clouds and given indices from numpy's
default_rng(SEED + 51 + i), as chip_smoke.py's `_inputs` makes them:

- the median of 20 calls after 3 warm-ups, CUDA events around each call
  (the wrapper's glue included), and the device time per call under
  torch.profiler;
- SHA-1 digests of idx and of xyz (equal digests from two checkouts mean
  bit-equal results);
- the bound at that shape (chip_smoke.py's `_fps_bound`);
- where the checkout's kernel takes a launch plan (ops/cuda/fps_plan.py),
  the device time of every block plan it takes for the shape, each checked
  against the planned launch's idx, and the plan's choice.

Where the checkout has the cluster variant (fps_plan.plan_cluster), the
same at each shape of chip_smoke.py's CAPS_FPS, beyond one block, with
the plan's choice; where its cluster size is a build's
(fps_plan.cluster_candidates), the sweep of every C that holds the cloud
(its fewest R; and the streamed build), each checked against the planned
launch's idx.

Then the 1-NN kernels, whose NaN handling shares this tool's change:
nn_direction at the eval shape (32 queries against 1024 points, B=1024)
and nn_snap at the progressive infer step's (1024 against 1024, B=32),
per call, device time and digests. Last, the eval forward with hard
matching at B=1024 (chip_smoke.py's seeded model and clouds): per call
and device time.

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
SHAPES = {   # name -> (B, N, k, count: "random" in 1..k, "one" or "all")
    "eval, random counts": (1024, 1024, 32, "random"),
    "eval, count k": (1024, 1024, 32, "all"),
    "eval, count 1": (1024, 1024, 32, "one"),
    "recon FPS baseline": (50, 2048, 64, "one"),
    "ragged": (3, 1000, 33, "random"),
    "80 KB case": (3, 5000, 64, "random"),
}


def digest(*outs) -> str:
    """SHA-1 (first 12 hex digits) of the bytes of every tensor in outs."""
    h = hashlib.sha1()
    for t in outs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def plan_sweep(torch, cs, fk, pts, given, count, k, idx) -> str:
    from samplenet_tpu_torch.ops.cuda import fps_plan as fp

    b, n, _ = pts.shape
    chosen = fk.kernel_plan(pts.device.index, b, n, k)
    parts = [f"plan w{chosen.warps} r{chosen.points}"
             f"{' shared' if chosen.shared else ''}"]
    for plan in fp.candidates(n):
        def call(plan=plan):
            return fk.launch(pts, given, count, k, plan)

        if not torch.equal(call()[0], idx):
            raise AssertionError(f"idx differ under {plan}")
        parts.append(f"w{plan.warps} r{plan.points}"
                     f"{' shared' if plan.shared else ''} "
                     f"{cs._device_ms(torch, call, 10)!r}")
    return ", ".join(parts)


def cluster_sweep(torch, cs, fk, pts, given, count, k, idx) -> str:
    from samplenet_tpu_torch.ops.cuda import fps_plan as fp

    b, n, _ = pts.shape
    chosen = fk.kernel_plan(pts.device.index, b, n, k)
    active = fk.cluster_active(pts.device.index)
    plans = fp.cluster_candidates(n, smem_limit=232448)
    plans.append(fp.FpsPlan(32, 0, False, fp.STREAM_CLUSTER))
    parts = [f"plan C={chosen.cluster} R={chosen.points}"]
    for plan in plans:
        def call(plan=plan):
            return fk.launch(pts, given, count, k, plan)

        if not torch.equal(call()[0], idx):
            raise AssertionError(f"idx differ under {plan}")
        at_once = active[plan.cluster, plan.points]
        parts.append(f"C={plan.cluster} R={plan.points} ({at_once} clouds "
                     f"at once, {-(-b // at_once)} waves) "
                     f"{cs._device_ms(torch, call, 5)!r}")
    return ", ".join(parts)


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

    from samplenet_tpu_torch.ops.cuda import fps_kernel as fk
    from samplenet_tpu_torch.ops.cuda._build import library, library_path

    library()
    log = (library_path().parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):        # each entry's properties follow it
        if "Compiling entry" in line and "fps_kernel" in line:
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

    from samplenet_tpu_torch.ops.cuda import fps_plan

    shapes = dict(SHAPES)
    if hasattr(fps_plan, "plan_cluster"):
        shapes.update((f"caps: {name}", shape)
                      for name, shape in cs.CAPS_FPS.items())
    for i, (name, (b, n, k, counts)) in enumerate(shapes.items()):
        rng = np.random.default_rng(cs.SEED + 51 + i)
        _, pts, given, count = cs._inputs(torch, rng, cs.DEVICE, b, n, k)
        if counts != "random":
            count = torch.full_like(count, k if counts == "all" else 1)

        def call():
            return fk.fps(pts, given, count, k)

        idx, xyz = call()
        ms, dev = median_ms(call), cs._device_ms(torch, call, 20)
        bd = cs._fps_bound(b, n, k)
        print(f"[{tag}] fps {name} (B={b}, N={n}, k={k}, count {counts}): "
              f"{ms!r} ms per call, {dev!r} ms device (bound {bd[0]!r} ms, "
              f"{bd[1]}); bits: idx {digest(idx)}, xyz {digest(xyz)} "
              f"({card})", flush=True)
        chosen = getattr(fk.kernel_plan(0, b, n, k), "cluster", 0) \
            if hasattr(fk, "kernel_plan") else 0
        if hasattr(fk, "kernel_plan") and not chosen:
            print(f"[{tag}] plans at the {name} shape: "
                  + plan_sweep(torch, cs, fk, pts, given, count, k, idx)
                  + f" ({card})", flush=True)
        elif hasattr(fps_plan, "cluster_candidates"):
            print(f"[{tag}] cluster sizes at the {name} shape: "
                  + cluster_sweep(torch, cs, fk, pts, given, count, k, idx)
                  + f" ({card})", flush=True)
        elif chosen:
            print(f"[{tag}] the plan at the {name} shape: "
                  f"{fk.kernel_plan(0, b, n, k)} ({card})", flush=True)
        del pts, given, count, idx, xyz
        torch.cuda.empty_cache()

    from samplenet_tpu_torch.ops.cuda import nn_direction, nn_snap

    for name, fn, (b, n1, n2) in (
            ("nn_direction", nn_direction, (cs.B, cs.M, cs.N)),
            ("nn_snap", nn_snap, (cs.PROG_B, cs.PROG_N, cs.PROG_N))):
        rng = np.random.default_rng(cs.SEED + 61)
        x, y, _, _ = cs._inputs(torch, rng, cs.DEVICE, b, n2, n1)

        def call(fn=fn):
            return fn(x, y)

        outs = call()
        ms, dev = median_ms(call), cs._device_ms(torch, call, 20)
        print(f"[{tag}] {name} (B={b}, {n1} queries, {n2} points): {ms!r} "
              f"ms per call, {dev!r} ms device; bits: {digest(*outs)} "
              f"({card})", flush=True)

    model = cs.make_model(torch, cs.DEVICE)
    clouds = np.random.default_rng(cs.SEED + 4).standard_normal(
        (cs.B, cs.N, 3)).astype(np.float32)
    xc = torch.from_numpy(clouds).to(cs.DEVICE)
    with torch.inference_mode():
        ms = median_ms(lambda: model(xc))
        dev = cs._device_ms(torch, lambda: model(xc), 10)
        _, matched = model(xc)
    print(f"[{tag}] eval forward + matching, B={cs.B}, {cs.N}->{cs.M}: "
          f"{ms!r} ms per call, {dev!r} ms device; bits: matched "
          f"{digest(matched)} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
