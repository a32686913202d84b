#!/usr/bin/env python3
"""Peak rates of the card's multiply pipes as the port's kernels reach them.

    python3 tools/diagnostics/mma_peak.py

Builds a small CUDA library in the checkout's build/ directory (nvcc,
sm_90a) and times, with CUDA events on the default stream, loops of
independent operations spread over every SM (4 blocks of 256 threads an
SM, 8 independent accumulators a thread):

- mma.sync.aligned.m16n8k8 tf32 (the f32 tile's instruction),
- mma.sync.aligned.m16n8k16 bf16,
- FFMA on the FP32 SIMT pipes,

and prints each as TFLOP/s (a multiply-add counts 2) beside the card's
name and power limit. The tile in csrc/mma_tile.cuh takes three tf32
products per f32 multiply-add, so its f32-equivalent ceiling is a third
of the tf32 rate printed here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>

__global__ void tf32_loop(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1u, threadIdx.x + 2u, 3u};
  uint32_t b[2] = {threadIdx.x * 3u, 7u};
  float c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void bf16_loop(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1u, threadIdx.x + 2u, 3u};
  uint32_t b[2] = {threadIdx.x * 3u, 7u};
  float c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void ffma_loop(float* out, int iters) {
  float x = threadIdx.x * 1e-3f, y = 1.0f - threadIdx.x * 1e-6f;
  float c[8] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = fmaf(x, y, c[j]);
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += c[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// milliseconds of one launch of `which` (0 tf32, 1 bf16, 2 ffma), after a
// warm-up launch
extern "C" float run(int which, int blocks, int iters) {
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * 256);
  void (*k)(float*, int) = which == 0 ? tf32_loop : which == 1 ? bf16_loop : ffma_loop;
  k<<<blocks, 256>>>(out, iters);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  k<<<blocks, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.0f;
}
"""


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    from samplenet_tpu_torch.ops.cuda._build import find_nvcc

    if not torch.cuda.is_available():
        print("mma_peak: no CUDA device", file=sys.stderr)
        return 1
    out_dir = os.path.join(HERE, "build", "mma_peak")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "peak.cu"), os.path.join(out_dir, "peak.so")
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    dll = ctypes.CDLL(lib)
    dll.run.restype = ctypes.c_float
    dll.run.argtypes = [ctypes.c_int] * 3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 4096
    warps = blocks * 256 // 32
    for which, name, flop in ((0, "mma.sync m16n8k8 tf32", 2 * 16 * 8 * 8),
                              (1, "mma.sync m16n8k16 bf16", 2 * 16 * 8 * 16),
                              (2, "FFMA (FP32 SIMT)", None)):
        ms = dll.run(which, blocks, iters)
        if ms <= 0:
            raise RuntimeError(f"{name}: launch failed")
        total = (warps * iters * 8 * flop if flop
                 else blocks * 256 * iters * 8 * 2)
        print(f"{name}: {total / ms / 1e9!r} TFLOP/s ({ms!r} ms for "
              f"{total / 1e12!r} TFLOP; {card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
