"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

`samplenet_tpu_torch/csrc/*.cu` compile, at first use, into one shared
library with a plain C interface under `build/kernels/<source hash>/` at
the checkout root (listed in .gitignore): one nvcc per source, all started
together, then one link, so the build takes as long as the slowest source.
A later process with the same sources loads the existing library. Nothing
here runs at import time, and a missing nvcc or a failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "kernels"
LIB_NAME = "libsamplenet_kernels.so"
NVCC_FLAGS = (           # compiling one source into an object
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def find_nvcc() -> str | None:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    return None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple[Path, float]:
    """Compiles the kernels unless the library for these sources exists.
    Returns (library path, seconds spent compiling; 0.0 when it existed)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels of samplenet_tpu_torch cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in _sources()]
    t0 = time.perf_counter()
    jobs = []
    for src, obj in zip(_sources(), objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], None
    for cmd, proc in jobs:           # waits for every compile, failed or not
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode and failed is None:
            failed = (proc.returncode, stderr)
    if failed is None:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode:
            failed = (proc.returncode, proc.stderr)
    seconds = time.perf_counter() - t0
    (out.parent / "build.log").write_text("".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed is not None:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{failed[1][-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    pp, sz = ctypes.POINTER(p), ctypes.c_size_t
    lib.snt_error_string.argtypes = [i]
    lib.snt_error_string.restype = ctypes.c_char_p
    lib.snt_nn_direction.argtypes = [p, p, p, p, *[i] * 7, p]
    lib.snt_nn_direction.restype = i
    lib.snt_nn_snap.argtypes = [p, p, p, p, p, *[i] * 7, p]
    lib.snt_nn_snap.restype = i
    lib.snt_nn_smem.argtypes = [i, i]
    lib.snt_nn_smem.restype = sz
    lib.snt_nn_limit.argtypes = [i]
    lib.snt_nn_limit.restype = i
    lib.snt_fps.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.snt_fps.restype = i
    lib.snt_fps_smem.argtypes = [i, i]
    lib.snt_fps_smem.restype = sz
    lib.snt_fps_max_threads.argtypes = [i, i]
    lib.snt_fps_max_threads.restype = i
    lib.snt_fps_shared_points.argtypes = []
    lib.snt_fps_shared_points.restype = i
    lib.snt_point_mlp_max_smem.argtypes = [ctypes.POINTER(i), i, i]
    lib.snt_point_mlp_max_smem.restype = ctypes.c_size_t
    lib.snt_point_mlp_max.argtypes = [p, p, ctypes.POINTER(i), i, i, p, i, i,
                                      p]
    lib.snt_point_mlp_max.restype = i
    lib.snt_soft_project_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                         p]
    lib.snt_soft_project_fwd.restype = i
    lib.snt_soft_project_fwd_smem.argtypes = [i]
    lib.snt_soft_project_fwd_smem.restype = sz
    lib.snt_soft_project_fwd_max_warps.argtypes = []
    lib.snt_soft_project_fwd_max_warps.restype = i
    lib.snt_soft_project_fwd_max_slices.argtypes = []
    lib.snt_soft_project_fwd_max_slices.restype = i
    lib.snt_soft_project_bwd_smem.argtypes = [i, i, i]
    lib.snt_soft_project_bwd_smem.restype = sz
    lib.snt_soft_project_bwd_limit.argtypes = [i]
    lib.snt_soft_project_bwd_limit.restype = i
    lib.snt_soft_project_bwd.argtypes = [*[p] * 10, *[i] * 7, p]
    lib.snt_soft_project_bwd.restype = i
    lib.snt_pmt_dense_smem.argtypes = [i, i, i]
    lib.snt_pmt_dense_smem.restype = sz
    lib.snt_pmt_bwd_dz_smem.argtypes = [i, i, i, i]
    lib.snt_pmt_bwd_dz_smem.restype = sz
    lib.snt_pmt_bwd_dw_smem.argtypes = [i]
    lib.snt_pmt_bwd_dw_smem.restype = sz
    lib.snt_pmt_dense.argtypes = [p, i, pp, i, i, p, i, p, p, i, i, i, i, i,
                                  p]
    lib.snt_pmt_dense.restype = i
    lib.snt_pmt_pool.argtypes = [p, pp, i, i, i, i, p, p, p]
    lib.snt_pmt_pool.restype = i
    lib.snt_pmt_rows.argtypes = [p, pp, i, i, p, p, p, i, i, i, p, i, p]
    lib.snt_pmt_rows.restype = i
    lib.snt_pmt_bwd_dz.argtypes = [p, pp, p, p, p, i, i, p, p, p, p, i, p, p,
                                   i, i, i, i, i, i, i, p]
    lib.snt_pmt_bwd_dz.restype = i
    lib.snt_pmt_bwd_dw.argtypes = [p, i, i, pp, i, p, i, p, i, i, i, i, i, p]
    lib.snt_pmt_bwd_dw.restype = i
    lib.snt_emd_smem.argtypes = [i]
    lib.snt_emd_smem.restype = sz
    lib.snt_emd_rows_per_block.argtypes = []
    lib.snt_emd_rows_per_block.restype = i
    lib.snt_emd_cost.argtypes = [p, p, i, i, i, i, *[p] * 11, p]
    lib.snt_emd_cost.restype = i
    lib.snt_emd_underflow.argtypes = []
    lib.snt_emd_underflow.restype = ctypes.c_float
    lib.snt_emd_underflow_check.argtypes = [p, p]
    lib.snt_emd_underflow_check.restype = i
    lib.snt_emd_unit_rows.argtypes = []
    lib.snt_emd_unit_rows.restype = i
    return lib


def check(err: int, name: str) -> None:
    """Raises if a C entry point reported a CUDA error."""
    if err:
        msg = library().snt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """The current stream of `t`'s device, as the pointer the C side takes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def max_dynamic_smem(device: torch.device) -> int:
    """Shared memory one block may opt into on `device` (232,448 bytes on
    an H100)."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))
