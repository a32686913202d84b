#!/usr/bin/env python3
"""Where torch.profiler loses kernel events on the card, and what keeps
them.

    python3 tools/diagnostics/profiler_drops.py

Each reading profiles CALLS calls, call i doubling a tensor of (i + 1)
MiB-blocks of floats (so the kernels' durations grow with i), four ways:
"plain", one profile around the calls (chip_smoke.py's old
`_device_ms`); "warm call", the calls run once inside the profile before
a user range that holds them a second time, the kernels counted from the
range's start; "sleep", 20 ms on the host inside the profile before the
calls; "schedule", schedule(wait=0, warmup=1, active=1) with the events
taken in on_trace_ready. A line gives, for each, the kernels the record
holds (of CALLS) and their durations in us, in the order they started.
Readings are taken in one process: fresh; after SESSIONS short profile
sessions; after two child processes that profile their own kernels at
once, as chip_smoke.py's CLI runs do; and after a second and a third
pair of them. Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import (
    ProfilerActivity,
    profile,
    record_function,
    schedule,
)

CALLS = 10
BLOCK = 1 << 20
SESSIONS = 200
CHILD = """
import torch
from torch.profiler import ProfilerActivity, profile
x = torch.ones(1 << 22, device="cuda")
for _ in range(20):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(50):
            x = x * 1.0
        torch.cuda.synchronize()
"""


def kernels(prof, starts: bool = False) -> list:
    """The doubling kernels' durations (us) in the order they started
    (with `starts`, (duration, start) pairs)."""
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "elementwise" in e.name),
                    key=lambda e: e.time_range.start)
    return [(e.time_range.elapsed_us(), e.time_range.start) if starts
            else e.time_range.elapsed_us() for e in events]


def reading(x: torch.Tensor, label: str) -> None:
    def calls():
        for i in range(CALLS):
            _ = x[:(i + 1) * BLOCK] * 2.0
        torch.cuda.synchronize()

    calls()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    got = {}
    with profile(activities=acts) as prof:
        calls()
    got["plain"] = kernels(prof)
    with profile(activities=acts) as prof:
        calls()
        with record_function("timed"):
            calls()
    mark = min(e.time_range.start for e in prof.events()
               if e.name == "timed" and e.device_type == DeviceType.CPU)
    got["warm call"] = [d for d, t in kernels(prof, starts=True) if t >= mark]
    with profile(activities=acts) as prof:
        time.sleep(0.02)
        calls()
    got["sleep"] = kernels(prof)
    kept = []
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.append(kernels(p))) as prof:
        for _ in range(2):
            calls()
            prof.step()
    got["schedule"] = kept[0] if kept else []
    print(f"[{label}] " + "; ".join(
        f"{way}: {len(ds)} of {CALLS} ({[round(d, 1) for d in ds]})"
        for way, ds in got.items()), flush=True)


def children() -> None:
    procs = [subprocess.Popen([sys.executable, "-c", CHILD])
             for _ in range(2)]
    for p in procs:
        if p.wait(timeout=600) != 0:
            raise RuntimeError("a child process failed")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    x = torch.ones(CALLS * BLOCK, device="cuda")
    for r in range(3):
        reading(x, f"fresh {r}")
    y = torch.ones(1024, device="cuda")
    for _ in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            y = y * 1.0
            torch.cuda.synchronize()
    for r in range(3):
        reading(x, f"after {SESSIONS} sessions {r}")
    children()
    for r in range(3):
        reading(x, f"after child profilers {r}")
    children()
    for r in range(3):
        reading(x, f"after a second pair {r}")
    children()
    for r in range(3):
        reading(x, f"after a third pair {r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
