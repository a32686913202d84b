"""Profiling and tracing surface (samplenet_tpu/utils/profiling.py on
torch.profiler).

  * `trace(log_dir)`: a torch.profiler trace of the block, CPU and, where
    there is a card, CUDA activity, written to log_dir/trace.json (Chrome
    trace format; Perfetto reads it).
  * `annotate(name)`: a named region in that trace (record_function).
  * `force_sync(value)`: waits for the device that holds `value` and pulls
    its sum to the host.
  * `StepTimer`: per-step wall-clock EMA, synchronised on a step output.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiles the block; yields the profiler, writes log_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named trace region: `with annotate("step"): ...`."""
    return torch.profiler.record_function(name)


def force_sync(value: torch.Tensor) -> float:
    """Finishes the work of `value`'s device; returns the sum pulled."""
    if value.device.type == "cuda":
        torch.cuda.synchronize(value.device)
    return float(value.sum())


class StepTimer:
    """EMA step timer; call mark(output) each step with any step output."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self.ema_ms: float | None = None
        self._last = time.perf_counter()

    def mark(self, output: torch.Tensor | None = None) -> float:
        if output is not None:
            force_sync(output)
        now = time.perf_counter()
        dt_ms = (now - self._last) * 1e3
        self._last = now
        self.ema_ms = (dt_ms if self.ema_ms is None
                       else self.momentum * self.ema_ms
                       + (1 - self.momentum) * dt_ms)
        return dt_ms
