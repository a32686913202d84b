"""Serving engine: fixed-shape batched sampler, torch.export artifacts and
request coalescing.

Mirrors samplenet_tpu/serving.py: `BatchedSampler` (:23-89), the exported
program and its versioned file (:92-175), `ArtifactSampler` (:178-214) and
`MicroBatcher` (:217-329, copied: the JAX package's module cannot be
imported without jax). Where the JAX sampler AOT-compiles one fixed shape,
this one pads every batch to `max_batch` so the device always runs one
shape, and its `dispatch` enqueues the forward on the current CUDA stream
without waiting; `fetch` waits by copying the result to the host.

Where the JAX package serialises StableHLO, the port writes a
`torch.export` program of the eval forward `model(x)[1]` at one fixed
shape. The eval path's kernels are the torch.library ops samplenet::
point_mlp_max, samplenet::nn_direction and samplenet::fps
(ops/cuda/*_kernel.py), so the program holds them as nodes of its own:
on the card it launches the hand-written kernels, on the CPU their plain
versions. Loading one needs the port's op registry (ops/cuda, imported
here), not its model code or weights. A program is bound to the device
it was exported on: tensors it makes (first_occurrence_mask's mask, the
FPS arguments) carry that device, so `ArtifactSampler` refuses any other.
"""

from __future__ import annotations

import io
import json
import queue
import struct
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

import samplenet_tpu_torch.ops.cuda  # noqa: F401  (registers samplenet::*)


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
            out = self._forward(x)
        return out, b

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)[1]

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


class _EvalForward(torch.nn.Module):
    """model(x)[1] with the weights as the program's own (frozen)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)[1]


class _FunctionalForward(torch.nn.Module):
    """model(x)[1] on weights passed in: the model is kept off the module
    tree, so the program holds none of its tensors."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        object.__setattr__(self, "_model", model)

    def forward(self, state: dict, x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self._model, state, (x,))[1]


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def export_program(model: torch.nn.Module, *, batch: int, num_points: int,
                   freeze_params: bool = False,
                   device: torch.device | str = "cuda") -> bytes:
    """The eval forward `model(x)[1]` on [batch, num_points, 3] float32
    clouds on `device`, as `torch.export.save` bytes.

    With `freeze_params` the weights travel inside the program, so
    `load_program` gives fn(clouds) -> sampled with no model code or
    weights file (the serving artifact). Without it the program takes
    (state_dict, clouds) through torch.func.functional_call, the JAX
    package's fn(variables, clouds), and holds no weights. The model's
    tensors must lie on `device`."""
    device = torch.device(device)
    if not all(_same_device(t.device, device)
               for t in model.state_dict().values()):
        raise ValueError(f"export_program: the model's tensors are not all "
                         f"on {device}")
    x = torch.zeros((batch, num_points, 3), dtype=torch.float32,
                    device=device)
    if freeze_params:
        module, args = _EvalForward(model), (x,)
    else:
        module, args = _FunctionalForward(model), (dict(model.state_dict()), x)
    with torch.no_grad():
        program = torch.export.export(module, args)
    program.example_inputs = None      # no clouds or weights in the bytes
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_program(blob: bytes):
    """Reload an exported sampler: fn(clouds) for a frozen program,
    fn(state_dict, clouds) otherwise (the counterpart of load_stablehlo).
    Its tensors land on the device it was exported on."""
    return torch.export.load(io.BytesIO(blob)).module()


# ------------------------------------------------- versioned artifact files

ARTIFACT_MAGIC = b"SNTPT"
ARTIFACT_VERSION = 1
JAX_ARTIFACT_MAGIC = b"SNTPU"     # samplenet_tpu/serving.py's StableHLO files


def save_exported(path: str, model: torch.nn.Module, *, batch: int,
                  num_points: int, metadata: dict | None = None,
                  freeze_params: bool = False,
                  device: torch.device | str = "cuda") -> None:
    """Write a versioned sampler artifact: magic, format version and header
    length (<II), a JSON header (the shape contract, the torch version, the
    export device, `metadata`), then the `export_program` bytes.
    `freeze_params` bakes the weights in (loadable by ArtifactSampler)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    blob = export_program(model, batch=batch, num_points=num_points,
                          freeze_params=freeze_params, device=device)
    header = {
        "artifact_version": ARTIFACT_VERSION,
        "batch": batch,
        "num_points": num_points,
        "frozen_params": freeze_params,
        "torch_version": torch.__version__,
        "device": str(device),
        **(metadata or {}),
    }
    if getattr(model, "fused", {}).get("eval_bf16"):
        header["eval_bf16"] = True
    hbytes = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(ARTIFACT_MAGIC)
        f.write(struct.pack("<II", ARTIFACT_VERSION, len(hbytes)))
        f.write(hbytes)
        f.write(blob)


def read_artifact(path: str) -> tuple[dict, bytes]:
    """(header, program bytes) of an artifact file. Rejects a JAX artifact,
    unknown magic, or a newer format version than this build reads."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw.startswith(JAX_ARTIFACT_MAGIC):
        raise ValueError(
            f"{path}: a StableHLO artifact of the JAX package "
            f"(samplenet_tpu.serving.save_exported); samplenet_tpu_torch "
            f"reads its own torch.export artifacts only")
    if not raw.startswith(ARTIFACT_MAGIC):
        raise ValueError(f"{path}: not a samplenet_tpu_torch sampler "
                         f"artifact")
    off = len(ARTIFACT_MAGIC)
    version, hlen = struct.unpack_from("<II", raw, off)
    if version > ARTIFACT_VERSION:
        raise ValueError(
            f"{path}: artifact format v{version} is newer than this "
            f"build's v{ARTIFACT_VERSION}")
    off += 8
    header = json.loads(raw[off:off + hlen].decode())
    return header, raw[off + hlen:]


def load_exported(path: str):
    """Load a versioned artifact: (fn, header), fn as `load_program`."""
    header, blob = read_artifact(path)
    return load_program(blob), header


class ArtifactSampler(BatchedSampler):
    """BatchedSampler over a frozen artifact: no model code or weights file
    at the serving host, the shape contract from the header; a drop-in for
    MicroBatcher and serve.py. `device` (by default the header's) must be
    the one the program was exported on."""

    def __init__(self, path: str, device: torch.device | str | None = None):
        header, blob = read_artifact(path)
        if not header.get("frozen_params"):
            raise ValueError(
                f"{path}: artifact was exported without freeze_params — "
                "it needs a state_dict at call time; serve from weights "
                "instead, or re-export with freeze_params=True")
        bound = torch.device(header["device"])
        device = bound if device is None else torch.device(device)
        if not _same_device(device, bound):
            raise ValueError(
                f"{path}: exported on {bound}, asked to serve on {device}; "
                f"a program is bound to its export device (re-export there)")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{path}: exported on {bound}, but CUDA is "
                               f"not available")
        self._fn = load_program(blob)
        self.header = header
        self.max_batch = int(header["batch"])
        self.num_points = int(header["num_points"])
        self.device = bound

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._fn(x)


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
