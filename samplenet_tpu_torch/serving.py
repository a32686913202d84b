"""Serving engine: fixed-shape batched sampler and request coalescing.

Mirrors samplenet_tpu/serving.py:23-89 (`BatchedSampler`) and :217-329
(`MicroBatcher`, copied: the JAX package's module cannot be imported
without jax). Where the JAX sampler AOT-compiles one fixed shape, this one
pads every batch to `max_batch` so the device always runs one shape, and
its `dispatch` enqueues the forward on the current CUDA stream without
waiting; `fetch` waits by copying the result to the host. StableHLO export
and `ArtifactSampler` wait for a later slice.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch


class BatchedSampler:
    """Fixed-shape eval sampler over a SampleNet on `device`.

    Pads incoming batches up to `max_batch` (replicating the last cloud so
    matching stays well-defined) and slices results back.
    """

    def __init__(self, model: torch.nn.Module, *, max_batch: int,
                 num_points: int, device: torch.device | str):
        self.model = model.eval()
        self.max_batch = max_batch
        self.num_points = num_points
        self.device = torch.device(device)

    def dispatch(self, clouds: np.ndarray):
        """Enqueue one padded batch on the device WITHOUT waiting; returns an
        opaque handle for `fetch`, so a server can enqueue batch k+1 while
        batch k runs."""
        b = len(clouds)
        if b > self.max_batch:
            raise ValueError(f"dispatch batch {b} > max_batch {self.max_batch}")
        if clouds.shape[1:] != (self.num_points, 3):
            raise ValueError(
                f"expected [n, {self.num_points}, 3] clouds, got "
                f"{clouds.shape}")
        clouds = np.asarray(clouds, np.float32)
        if b < self.max_batch:
            pad = np.repeat(clouds[-1:], self.max_batch - b, axis=0)
            clouds = np.concatenate([clouds, pad])
        x = torch.from_numpy(np.ascontiguousarray(clouds)).to(self.device)
        with torch.inference_mode():
            _, out = self.model(x)
        return out, b

    def fetch(self, handle) -> np.ndarray:
        """Block until a dispatched batch is done; return the real rows."""
        out, b = handle
        return out[:b].cpu().numpy()

    def __call__(self, clouds: np.ndarray, *, window: int = 6) -> np.ndarray:
        b = len(clouds)
        if b > self.max_batch:
            # chunks pipelined with a bounded in-flight window, so device
            # memory holds O(window) padded batches
            handles: deque = deque()
            outs = []
            for s in range(0, b, self.max_batch):
                handles.append(self.dispatch(clouds[s : s + self.max_batch]))
                if len(handles) >= window:
                    outs.append(self.fetch(handles.popleft()))
            while handles:
                outs.append(self.fetch(handles.popleft()))
            return np.concatenate(outs)
        return self.fetch(self.dispatch(clouds))


class MicroBatcher:
    """Coalesces concurrent single-cloud requests into one device dispatch.

    `submit(cloud)` returns a Future immediately; a drain thread gathers up
    to `max_batch` queued requests (waiting at most `max_wait_ms` after the
    first), stacks them, runs the sampler once, and resolves every Future.
    Up to `pipeline_depth` batches are in flight; when the request queue
    idles, every in-flight batch is flushed at once.
    """

    def __init__(self, sampler: BatchedSampler, *, max_wait_ms: float = 5.0,
                 pipeline_depth: int = 4):
        self._sampler = sampler
        self._max_wait = max_wait_ms / 1e3
        self._depth = max(1, pipeline_depth)
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def submit(self, cloud: np.ndarray) -> Future:
        if self._closed:
            # after close() the drain thread has exited (or is exiting); an
            # enqueued request would sit behind the None sentinel forever
            raise RuntimeError("MicroBatcher.submit() after close()")
        if cloud.shape != (self._sampler.num_points, 3):
            raise ValueError(
                f"expected [{self._sampler.num_points}, 3] cloud, "
                f"got {cloud.shape}")
        fut: Future = Future()
        self._queue.put((np.asarray(cloud, np.float32), fut))
        return fut

    def _drain(self) -> None:
        inflight: deque = deque()  # (batch, device handle)

        def flush_one() -> None:
            batch, handle = inflight.popleft()
            try:
                outs = self._sampler.fetch(handle)
                for (_, fut), out in zip(batch, outs):
                    fut.set_result(out)
            except Exception as exc:  # resolve, don't wedge callers
                for _, fut in batch:
                    fut.set_exception(exc)

        while True:
            # take new work if it is already waiting; otherwise flush any
            # in-flight batches before blocking
            try:
                first = self._queue.get_nowait()
            except queue.Empty:
                if inflight:
                    flush_one()
                    continue
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    if self._closed:
                        return
                    continue
            if first is None:
                while inflight:
                    flush_one()
                return
            batch = [first]
            deadline = time.monotonic() + self._max_wait
            while len(batch) < self._sampler.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    self._closed = True
                    break
                batch.append(item)
            clouds = np.stack([c for c, _ in batch])
            try:
                inflight.append((batch, self._sampler.dispatch(clouds)))
            except Exception as exc:
                for _, fut in batch:
                    fut.set_exception(exc)
            while len(inflight) >= self._depth:
                flush_one()
            if self._closed:
                while inflight:
                    flush_one()
                return

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=5)
