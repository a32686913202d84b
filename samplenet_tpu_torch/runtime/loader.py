"""ctypes bindings for the port's native C++ data-loading runtime.

Mirrors samplenet_tpu/runtime/loader.py:23-134 on the port's own copy of
the source (runtime/native/loader.cpp). `NativeLoader` wraps the threaded
prefetch pipeline: workers shuffle, augment (rotate-about-up + clipped
jitter) and batch clouds off the GIL while the device runs the previous
step; `load_ply_native` is the C++ PLY parser (data/shapenet.py::
load_point_clouds reads with it).

The library is built with g++ at first use into `build/native/<hash>/`
at the checkout root (listed in .gitignore), keyed by the source, the
flags and the host's CPU (the flags target it: -march=native), as
ops/cuda/_build.py keys the kernels; a later process loads it. Where it
cannot be built, `native_available` is False and every entry point
raises with the compiler's message: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libsnloader.so"
# the JAX package's Makefile flags (samplenet_tpu/runtime/native/Makefile)
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-pthread", "-shared")

_lib: ctypes.CDLL | None = None
_error: str | None = None
_lock = threading.Lock()


def _host_key() -> bytes:
    """The CPU the -march=native build targets: /proc/cpuinfo's model name
    and flags where it exists."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        return b""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_key())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compiles the library unless it exists for this source and host;
    raises RuntimeError where g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native loader of "
                           "samplenet_tpu_torch cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building the "
                           f"native loader:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)    # atomic: a concurrent loader sees all or nothing
    return out


def _load_lib() -> ctypes.CDLL:
    """The bound library, built first if needed; raises (every call, with
    the first failure's message) where it cannot be built."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError) as e:
                _error = str(e)
        if _lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.sn_load_ply.restype = ctypes.c_int64
    lib.sn_load_ply.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64]
    lib.sn_pipeline_create.restype = ctypes.c_void_p
    lib.sn_pipeline_create.argtypes = [
        f32p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
    lib.sn_pipeline_epoch_batches.restype = ctypes.c_int64
    lib.sn_pipeline_epoch_batches.argtypes = [ctypes.c_void_p]
    lib.sn_pipeline_next.restype = ctypes.c_int
    lib.sn_pipeline_next.argtypes = [ctypes.c_void_p, f32p, i32p]
    lib.sn_pipeline_destroy.restype = None
    lib.sn_pipeline_destroy.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the library is built or can be built here."""
    try:
        _load_lib()
    except RuntimeError:
        return False
    return True


def load_ply_native(path: str) -> np.ndarray:
    """Parses a PLY file's vertex element in C++; returns [N, 3] float32
    xyz."""
    lib = _load_lib()
    count = lib.sn_load_ply(path.encode(), None, 0)
    if count <= 0:
        raise ValueError(f"failed to parse {path}")
    out = np.empty((count, 3), np.float32)
    got = lib.sn_load_ply(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size)
    if got != count:
        raise ValueError(f"short read parsing {path}")
    return out


class NativeLoader:
    """One-epoch prefetching batch iterator over an in-memory dataset
    (:81-134): the order shuffled by `seed`, len // batch_size full
    batches, each cloud rotated about Y by a uniform angle and jittered
    (sigma 0.01, clipped at 0.05) with `augment`. With one worker the
    batches come in order and their augmentation is a function of the
    seed; with more the workers race for batches.

        with NativeLoader(data, labels, 32, augment=True, seed=e) as it:
            for points, labels in it: ...
    """

    def __init__(self, data: np.ndarray, labels: np.ndarray | None,
                 batch_size: int, *, augment: bool = False, seed: int = 0,
                 num_workers: int = 2):
        lib = _load_lib()
        self._lib = lib
        self._handle = None
        self._data = np.ascontiguousarray(data, np.float32)
        self._labels = (np.ascontiguousarray(labels, np.int32)
                        if labels is not None else None)
        self.batch_size = batch_size
        self.num_points = self._data.shape[1]
        self._handle = lib.sn_pipeline_create(
            self._data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            (self._labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
             if self._labels is not None else None),
            len(self._data), self.num_points, batch_size, int(augment),
            seed, num_workers)
        self.epoch_batches = lib.sn_pipeline_epoch_batches(self._handle)

    def __iter__(self):
        points = np.empty((self.batch_size, self.num_points, 3), np.float32)
        labels = np.empty((self.batch_size,), np.int32)
        while True:
            ok = self._lib.sn_pipeline_next(
                self._handle,
                points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if not ok:
                return
            yield points.copy(), labels.copy()

    def close(self) -> None:
        if self._handle:
            self._lib.sn_pipeline_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
