#!/usr/bin/env python3
"""Time the soft-projection kernels of a checkout on the card.

    python3 tools/time_soft_projection.py CHECKOUT TAG

Imports samplenet_tpu_torch from CHECKOUT (building its kernels there),
prints the build's ptxas lines for the forward and backward kernels at
k = 7 and 16 (registers, spills) and then, under TAG, at the soft
projection's shape on
each path that runs it (chip_smoke.py's SOFT_SHAPES: the classification
step, the reconstruction sampler step, the progressive step and the
progressive AE step), on standard-normal clouds and queries from numpy's
default_rng(SEED + 41 + i) and sigma^2 = 0.7, as chip_smoke.py's
`_soft_inputs` makes them:

- the forward's median of 20 calls after 3 warm-ups, CUDA events around
  each call (the wrapper's glue included), and its device time per call
  under torch.profiler; the same for the backward on the forward's idx and
  a standard-normal cotangent;
- SHA-1 digests of idx, of out and of each of the backward's three
  outputs, d points, d queries and d sigma^2 (equal digests from two
  checkouts mean bit-equal results);
- the backward's host time a call: the least of three means over
  HOST_CALLS calls issued back to back with no sync among them (the
  wrapper's glue and its launches, as a host-bound train step pays them);
- the forward's and the backward's bounds (chip_smoke.py::_soft_fwd_bound,
  _soft_bwd_bound, the latter on the points this idx names), and the
  backward's device time by kernel;
- where the checkout's forward takes a launch plan of slices (lanes a
  query) and warps (ops/cuda/soft_projection_plan.py), its device time
  under torch.profiler for every slices x warps, and the plan's choice;
- where the checkout's backward takes a launch plan (queries a block,
  threads and points a block), its device time under each plan that
  differs from the chosen one in one of them, each checked bit for bit
  against the planned launch.

Where the checkout has the wide kernels (k above 16), the same lines at
each shape of chip_smoke.py's CAPS_SOFT, but for the plan sweeps, which
are the register kernels'.

With a third argument `sweep`, where the checkout has the wide
backward's plan (`plan_bwd_wide`), its device time at each CAPS_SOFT shape
under the chosen plan and under every plan that differs from it in one of
its choices (queries a block, threads, points a block), each checked bit
for bit against the planned launch.

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
ITERS, WARMUP = 20, 3
HOST_CALLS = 100


def digest(*outs) -> str:
    """SHA-1 (first 12 hex digits) of the bytes of every tensor in outs."""
    h = hashlib.sha1()
    for t in outs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def plan_sweep(torch, cs, spk, pts, qs, sigma, k, idx) -> str:
    """Device ms of the forward under every slices x warps, each checked
    against the planned launch's idx."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp

    b, n, _ = pts.shape
    m = qs.shape[1]
    plan = spk.fwd_plan(pts.device.index, b, n, m)
    parts = [f"plan slices {plan.slices}, warps {plan.warps}"]
    slices = 1
    while slices <= spp.MAX_SLICES:
        for warps in (2, 4, 8):
            other = spp.FwdPlan(plan.chunk, warps, slices, (b, 0))

            def call(other=other):
                return spk.launch_fwd(pts, qs, sigma, k, other)

            if not torch.equal(call()[1], idx):
                raise AssertionError(f"idx differ under {other}")
            parts.append(f"s{slices} w{warps} "
                         f"{cs._device_ms(torch, call, 10)!r}")
        slices *= 2
    return ", ".join(parts)


def bwd_sweep(torch, cs, spk, pts, qs, sigma, idx, cot) -> str:
    """Device ms of the backward under the chosen plan and under plans
    that differ from it in one choice, each bit-equal to the chosen one."""
    from dataclasses import replace

    b, n, _ = pts.shape
    m, k = idx.shape[1], idx.shape[2]
    plan = spk.bwd_plan(pts.device.index, b, n, m, k)
    want = spk.launch_bwd(pts, qs, sigma, idx, cot, plan)
    others = ([replace(plan, tile=t) for t in (32, 64, 128, 256)]
              + [replace(plan, span=s, threads=min(s, 256))
                 for s in (32, 64, 128, 256, 512, 1024)]
              + [replace(plan, threads=t) for t in (32, 64, 128, 256)
                 if plan.span // 4 <= t <= plan.span])
    parts = [f"plan tile {plan.tile}, threads {plan.threads}, span "
             f"{plan.span}"]
    for other in dict.fromkeys(others):
        def call(other=other):
            return spk.launch_bwd(pts, qs, sigma, idx, cot, other)

        if not all(torch.equal(a, c) for a, c in zip(call(), want)):
            raise AssertionError(f"the backward differs under {other}")
        parts.append(f"tile {other.tile} threads {other.threads} span "
                     f"{other.span} "
                     f"{cs._device_ms(torch, call, 10)!r}")
    return ", ".join(parts)


def wide_sweep(torch, cs, spk, pts, qs, sigma, idx, cot) -> str:
    """Device ms of the wide backward under the chosen plan and under
    plans that differ from it in one choice (the two kernels', and the
    fused kernel's where it takes the shape), each bit-equal to the chosen
    one."""
    from dataclasses import replace

    spp = spk.spp

    b, n, _ = pts.shape
    m, k = idx.shape[1], idx.shape[2]
    plan = spk.bwd_plan(pts.device.index, b, n, m, k)
    want = spk.launch_bwd(pts, qs, sigma, idx, cot, plan)
    base = replace(plan, fused=False)
    others = ([replace(base, warps=w) for w in (1, 2, 4, 8)]
              + [replace(base, threads=t) for t in (128, 256, 512, 1024)]
              + [replace(base, span=s)
                 for s in (32, 64, 128, 256, 512, 1024, 2048, 4096)]
              + [replace(base, threads=t, fused=True) for t in (64, 128, 256)])
    others = [o for o in others if o.span <= spp.WIDE_POINTS_PER * o.threads
              and (not o.fused or spp.takes_fused(
                  b, n, m, k, sms=1) and n <= spp.WIDE_POINTS_PER * o.threads)]
    parts = [f"plan warps {plan.warps}, threads {plan.threads}, span "
             f"{plan.span}, fused {plan.fused}"]
    for other in dict.fromkeys(others):
        def call(other=other):
            return spk.launch_bwd(pts, qs, sigma, idx, cot, other)

        if not all(torch.equal(a, c) for a, c in zip(call(), want)):
            raise AssertionError(f"the backward differs under {other}")
        parts.append(f"warps {other.warps} threads {other.threads} span "
                     f"{other.span} fused {other.fused} "
                     f"{cs._device_ms(torch, call, 10)!r}")
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

    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.cuda._build import library, library_path

    library()
    log = (library_path().parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):        # each entry's properties follow it
        if ("Compiling entry" in line and "soft_project_" in line
                and ("ILi7E" in line or "ILi16E" in line)):
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

    def host_ms(fn) -> float:
        """The host's ms a call: HOST_CALLS calls issued back to back, no
        sync among them (the wrapper's glue and its launches)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / HOST_CALLS * 1e3

    shapes = dict(cs.SOFT_SHAPES)
    if hasattr(spk, "launch_fwd_wide"):
        shapes.update((f"caps: {path}", shape)
                      for path, shape in cs.CAPS_SOFT.items())
    for i, (path, (b, n, m, k)) in enumerate(shapes.items()):
        rng = np.random.default_rng(cs.SEED + 41 + i)
        pts, qs, sigma, cot = cs._soft_inputs(torch, rng, b, n, m)
        sigma = sigma.reshape(1)

        def fwd():
            return spk.soft_project_fwd_cuda(pts, qs, sigma, k)

        out, idx = fwd()

        def bwd():
            return spk.soft_project_bwd_cuda(pts, qs, sigma, idx, cot)

        f_ms, f_dev = median_ms(fwd), cs._device_ms(torch, fwd, 10)
        b_ms, b_dev = median_ms(bwd), cs._device_ms(torch, bwd, 10)
        bound = cs._soft_fwd_bound(b, n, m, k)
        b_bound = cs._soft_bwd_bound(b, n, m, k, cs._gathered(torch, idx, n))
        b_host = min(host_ms(bwd) for _ in range(3))
        dp, dq, ds = bwd()
        print(f"[{tag}] soft_projection {path} (B={b}, N={n}, M={m}, k={k}):"
              f" forward {f_ms!r} ms per call, {f_dev!r} ms device (bound "
              f"{bound[0]!r} ms, {bound[1]}); backward {b_ms!r} ms per "
              f"call, {b_dev!r} ms device, {b_host!r} ms of the host a call "
              f"(bound {b_bound[0]!r} ms, {b_bound[1]}); bits: idx {digest(idx)}, out {digest(out)}, "
              f"d points {digest(dp)}, d queries {digest(dq)}, d sigma^2 "
              f"{digest(ds)} ({card})", flush=True)
        print(f"[{tag}] backward by kernel at the {path}'s shape: "
              f"{cs._profile_top(torch, bwd, 10, top=4)} ({card})",
              flush=True)
        if hasattr(spk, "launch_fwd") and k <= 16:
            print(f"[{tag}] plans at the {path}'s shape: "
                  + plan_sweep(torch, cs, spk, pts, qs, sigma, k, idx)
                  + f" ({card})", flush=True)
        if hasattr(spk, "launch_bwd") and k <= 16:
            print(f"[{tag}] backward plans at the {path}'s shape: "
                  + bwd_sweep(torch, cs, spk, pts, qs, sigma, idx, cot)
                  + f" ({card})", flush=True)
        if hasattr(spk.spp, "plan_bwd_wide") and k > 16 and "sweep" in sys.argv:
            print(f"[{tag}] wide backward plans at the {path}'s shape: "
                  + wide_sweep(torch, cs, spk, pts, qs, sigma, idx, cot)
                  + f" ({card})", flush=True)
        del pts, qs, cot, out, idx, dp, dq, ds
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
