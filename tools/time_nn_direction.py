#!/usr/bin/env python3
"""Time the 1-NN kernel (nn_direction and nn_snap) of a checkout on the card.

    python3 tools/time_nn_direction.py CHECKOUT TAG [sweep]

Imports samplenet_tpu_torch from CHECKOUT (building its kernels there) and
prints, under TAG, the SASS lane-instructions a (query, point) pair of the
checkout's 1-NN kernels (chip_smoke.py's `nn_pair_cost`), then for each
shape of chip_smoke.py's NN_SHAPES (every shape the four paths give the
kernel), on standard-normal clouds from numpy's default_rng(SEED + 71 + i):

- the median of 20 calls after 3 warm-ups, CUDA events around each call
  (the wrapper's glue included), the device time a call under
  torch.profiler, and the host's time a call over 100 calls in a row
  without a sync (the wrapper's glue and the launch);
- a SHA-1 digest of dist, idx (and snapped, for nn_snap): equal digests
  from two checkouts mean bit-equal results;
- the bound (chip_smoke.py's `_nn_bound`) and the issue floor (the pairs
  at the kernel's SASS lane-instructions a pair over the card's issue
  slots), and the launch plan where the checkout has one
  (ops/cuda/nn_plan.py);

then the kernel's device ms a step of each train path (`_nn_per_step`)
and, at the classification step's two Chamfer directions, the two-call
library route (torch.cdist without the matmul form, then amin), a
yardstick only. With `sweep` (a checkout with the plan), at every shape
every (lanes, queries) the kernel takes at each chunk it takes there, and
the chosen plan at every block width, each timed as graph-replay ms a
call (`graph_ms`) and checked bit for bit against the planned launch;
the eight fastest print, and every reading goes to
log/nn_sweep_TAG.json (a directory .gitignore lists).

To compare two checkouts on one card, run it four times in a row: A, B,
B, A.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import re
import sys
import time

TOOL_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, WARMUP = 20, 3


def digest(*outs) -> str:
    """SHA-1 (first 12 hex digits) of the bytes of every tensor in outs."""
    h = hashlib.sha1()
    for t in outs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def pair_costs(cs, lib_path) -> dict:
    """(lanes, queries, snap) -> SASS lane-instructions a pair; a kernel
    without the plan's template arguments (one layout) under (None, None,
    snap)."""
    from samplenet_tpu_torch.ops.cuda._build import find_nvcc

    funcs = cs._sass(find_nvcc(), lib_path)
    out = cs.nn_pair_costs(funcs)
    for name, code in funcs.items():
        m = re.search(r"nn_direction_kernelILb([01])E", name)
        if m and cs.nn_pair_cost(code) is not None:
            out[(None, None, m.group(1) == "1")] = cs.nn_pair_cost(code)
    return out


def graph_ms(torch, fn, calls: int = 20, reps: int = 5) -> float:
    """ms a call of fn, `calls` calls captured in a CUDA graph and replayed
    `reps` times between CUDA events (the median): device time without
    the host's launch overhead, the gaps between graph nodes included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[reps // 2]


def sweep(torch, ck, x, y, snap: bool, ref) -> tuple[str, list, float]:
    """Every (lanes, queries) at every chunk the kernel takes for the shape
    (256, 512, 1024 where the database is longer), and the chosen plan at
    every block width: graph-replay ms a call, each checked bit for bit
    against the planned launch. Returns the line (the chosen plan's time
    and the eight fastest), every (plan, ms) and the chosen plan's time
    over the fastest's."""
    from samplenet_tpu_torch.ops.cuda import nn_plan as npl

    b, n1, _ = x.shape
    n2 = y.shape[1]
    chosen = ck.kernel_plan(x.device.index, b, n1, n2)
    chunks = sorted({npl.nn_chunk(n2)} | {c for c in (256, 512, 1024)
                                          if c < n2})
    plans = {npl.NnPlan(p.lanes, p.queries, p.warps, c)
             for p in npl.candidates(b, n1, n2) for c in chunks}
    plans |= {npl.NnPlan(chosen.lanes, chosen.queries, w, chosen.chunk)
              for w in range(1, npl.MAX_WARPS + 1)}
    rows = []
    for plan in sorted(plans, key=lambda p: (p.lanes, p.queries, p.warps,
                                             p.chunk)):
        if not npl.valid(plan, b, n1, n2):
            continue

        def call(plan=plan):
            return ck.launch(x, y, plan, snap)

        out = call()
        if not (torch.equal(out[1], ref[1]) and all(
                torch.equal(a.view(torch.int32), c.view(torch.int32))
                for a, c in zip(out[::2], ref[::2]))):
            raise AssertionError(f"outputs differ under {plan}")
        rows.append((graph_ms(torch, call), plan))
    rows.sort(key=lambda r: r[0])
    mine = next(ms for ms, p in rows if p == chosen)
    name = (lambda p: f"L{p.lanes} Q{p.queries} w{p.warps} c{p.chunk}")
    line = (f"chosen {name(chosen)} {mine!r} (best/chosen "
            f"{rows[0][0] / mine:.3f}); fastest: "
            + ", ".join(f"{name(p)} {ms!r}" for ms, p in rows[:8]))
    return line, [[p.lanes, p.queries, p.warps, p.chunk, ms]
                  for ms, p in rows], mine / rows[0][0]


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    do_sweep = len(sys.argv) > 3 and sys.argv[3] == "sweep"
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(TOOL_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from samplenet_tpu_torch.ops.cuda import chamfer_kernel as ck
    from samplenet_tpu_torch.ops.cuda._build import library, library_path

    library()
    card = cs.card_line()
    costs = pair_costs(cs, library_path())
    print(f"[{tag}] SASS lane-instructions a pair, by (lanes, queries, "
          f"snap): " + ", ".join(f"{k} {v:.3f}" for k, v in costs.items())
          + f" ({card})", flush=True)
    planned = hasattr(ck, "kernel_plan")

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

    def host_ms(fn, calls: int = 100) -> float:
        """The host's ms a call over back-to-back calls without a sync:
        the wrapper's glue and the launch, where the card keeps up."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e3

    dev, table, slow = {}, {}, {}
    for i, (name, (b, n1, n2, snap)) in enumerate(cs.NN_SHAPES.items()):
        rng = np.random.default_rng(cs.SEED + 71 + i)
        x = torch.from_numpy(rng.standard_normal((b, n1, 3)).astype(
            np.float32)).to(cs.DEVICE)
        y = torch.from_numpy(rng.standard_normal((b, n2, 3)).astype(
            np.float32)).to(cs.DEVICE)
        fn = ck.nn_snap if snap else ck.nn_direction

        def call(fn=fn, x=x, y=y):
            return fn(x, y)

        outs = call()
        ms, dev[name] = median_ms(call), cs._device_ms(torch, call, ITERS)
        host = host_ms(call)
        bd = cs._nn_bound(b, n1, n2, snap)
        if planned:
            plan = ck.kernel_plan(x.device.index, b, n1, n2)
            key = (plan.lanes, plan.queries, snap)
            how = (f"plan L{plan.lanes} Q{plan.queries} w{plan.warps} "
                   f"c{plan.chunk}; ")
        else:
            key, how = (None, None, snap), ""
        floor = (f"{cs.nn_issue_floor(b, n1, n2, costs[key])!r} ms"
                 if key in costs else "not counted")
        print(f"[{tag}] {'nn_snap' if snap else 'nn_direction'} {name} "
              f"(B={b}, {n1} over {n2}): {how}{ms!r} ms per call, "
              f"{dev[name]!r} ms device, {host!r} ms host a call (bound "
              f"{bd[0]!r} ms, {bd[1]}; issue "
              f"floor {floor}); bits: {digest(*outs)} ({card})", flush=True)
        if do_sweep and planned:
            line, table[name], slow[name] = sweep(torch, ck, x, y, snap,
                                                  outs)
            print(f"[{tag}] plans at {name} (graph-replay ms a call): "
                  f"{line} ({card})", flush=True)
        if name in cs.NN_LIBRARY_SHAPES:
            def lib_route(x=x, y=y):
                return torch.cdist(x, y, compute_mode=(
                    "donot_use_mm_for_euclid_dist")).amin(2)

            print(f"[{tag}] library route at {name} (two calls: cdist, "
                  f"amin; other rounding, no index): "
                  f"{median_ms(lib_route)!r} ms per call, "
                  f"{cs._device_ms(torch, lib_route, ITERS)!r} ms device "
                  f"({card})", flush=True)
        del x, y, outs
        torch.cuda.empty_cache()
    print(f"[{tag}] per train step: {cs._nn_per_step(dev)} ({card})",
          flush=True)
    if table:
        worst = max(slow, key=slow.get)
        gmean = math.exp(sum(map(math.log, slow.values())) / len(slow))
        print(f"[{tag}] the chosen plans against the sweep's fastest: "
              f"geometric mean {gmean!r}x over {len(slow)} shapes, worst "
              f"{slow[worst]!r}x at {worst} ({card})", flush=True)
        out = os.path.join(TOOL_ROOT, "log", f"nn_sweep_{tag}.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": card, "shapes": cs.NN_SHAPES, "columns": [
                "lanes", "queries", "warps", "chunk", "ms"], "plans": table},
                f)
        print(f"[{tag}] the sweep's every reading: {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
