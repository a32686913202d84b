#!/usr/bin/env python3
"""Where an FPS pick's time goes in the cluster variant, by clock64 stamps.

    python3 tools/diagnostics/fps_pick_split.py

Builds a stamped copy of the cluster variant's completion step (csrc/
fps.cu's fps_cluster_kernel, registers layout, no given prefix) into the
checkout's build/ directory (nvcc, sm_90a) and runs it on the card. Thread
0 of block 0 of cloud 0 reads clock64 four times a pick and sums, over the
k picks, the cycles of:

- the point updates (its R running distances and their first maximum,
  then the warp's redux),
- the block barrier (the warps' slots written, __syncthreads),
- the cluster barrier: in the exchange of `fps_cluster_kernel` as it was
  ("sync": warp 0 posts the block's maximum in its own slot, then
  cluster.sync()) or as it is ("post": warp 0 stores the block's maximum
  into every block's slot through distributed shared memory and arrives
  on that block's mbarrier; every thread waits on its own), thread 0
  being in warp 0,
- the slot reads: the C slots (read through distributed shared memory
  by every warp in "sync", locally in "post"; with C = 1 the 32 warp
  slots) and the pick's reduction.

Each row prints the four parts in cycles a pick (and in us at the card's
largest SM clock), the kernel's time per pick from CUDA events, and
whether its picks equal the shipped kernel's (samplenet_tpu_torch.ops.
fps with the first pick given as point 0). Rows "exchange only" run the
same step with no point work (each thread's distances fixed): their time
a pick is the least a pick costs at that C, the latency floor of the
cluster rows of PERF.md. The stamps cost cycles of their own; compare
rows with each other, not with the shipped kernel's time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace cg = cooperative_groups;
constexpr unsigned kFull = 0xffffffffu, kNoIndex = 0xffffffffu;
constexpr int T = 1024, kWarps = 32;

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int C, int R, bool kPost, bool kWork>
__global__ void __launch_bounds__(T)
split_kernel(const float* __restrict__ points, int n, int k,
             int* __restrict__ idx_out, long long* __restrict__ parts) {
  extern __shared__ float slice[];
  __shared__ uint2 wslots[2][kWarps];
  __shared__ uint2 ckey[2][C];
  __shared__ float4 cxyz[2][C];
  __shared__ unsigned long long posted[2];
  int rank = 0;
  if constexpr (C > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / C;
  const float* pb = points + static_cast<size_t>(b) * n * 3;
  constexpr long long S = static_cast<long long>(T) * R;
  const long long s0 = rank * S;
  const int nl = static_cast<int>(max(0LL, min(S, n - s0)));
  if constexpr (C > 1) {
    if (kPost && tid == 0) {
      for (int q = 0; q < 2; ++q) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                     ::"r"(saddr(&posted[q])), "r"(C) : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cg::this_cluster().sync();
  }
  float pd[R];
  for (int e = tid; e < 3 * nl; e += T) slice[e] = __ldg(pb + 3 * s0 + e);
#pragma unroll
  for (int j = 0; j < R; ++j) pd[j] = tid + j * T < nl ? CUDART_INF_F : 0.0f;
  __syncthreads();
  long long sum[4] = {0, 0, 0, 0};
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  unsigned phases = 0u;
  for (int t = 0; t < k; ++t) {
    const int q = t & 1;
    const long long c0 = clock64();
    unsigned best = 0u, bi = static_cast<unsigned>(s0 + tid);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int l = tid + j * T;
      if (kWork && t > 0 && l < nl) {
        pd[j] = min_nan(pd[j], sqdist(slice[3 * l], slice[3 * l + 1],
                                      slice[3 * l + 2], sx, sy, sz));
      }
      const unsigned key = __float_as_uint(pd[j]);
      if (key > best) {
        best = key;
        bi = static_cast<unsigned>(s0 + l);
      }
    }
    unsigned hi = __reduce_max_sync(kFull, best);
    unsigned lo = __reduce_min_sync(kFull, best == hi ? bi : kNoIndex);
    const long long c1 = clock64();
    if (lane == 0) wslots[q][warp] = make_uint2(hi, lo);
    __syncthreads();
    const long long c2 = clock64();
    long long c3 = c2;
    if constexpr (C == 1) {
      const uint2 w = wslots[q][lane];
      hi = __reduce_max_sync(kFull, w.x);
      lo = __reduce_min_sync(kFull, w.x == hi ? w.y : kNoIndex);
      const long long l = lo < static_cast<unsigned>(n) ? lo : 0;
      sx = slice[3 * l];
      sy = slice[3 * l + 1];
      sz = slice[3 * l + 2];
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      if (warp == 0) {
        const uint2 w = wslots[q][lane];
        hi = __reduce_max_sync(kFull, w.x);
        lo = __reduce_min_sync(kFull, w.x == hi ? w.y : kNoIndex);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (lo < static_cast<unsigned>(n)) {
          const long long l = lo - s0;
          v = make_float4(slice[3 * l], slice[3 * l + 1], slice[3 * l + 2], 0.0f);
        }
        if (!kPost && lane == 0) {
          ckey[q][0] = make_uint2(hi, lo);
          cxyz[q][0] = v;
        }
        if (kPost && lane < C) {
          *cluster.map_shared_rank(&ckey[q][rank], lane) = make_uint2(hi, lo);
          *cluster.map_shared_rank(&cxyz[q][rank], lane) = v;
          unsigned remote;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                       : "=r"(remote) : "r"(saddr(&posted[q])), "r"(lane));
          asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
                       ::"r"(remote) : "memory");
        }
      }
      if constexpr (kPost) {
        unsigned done = 0;
        while (!done) {
          asm volatile(
              "{\n .reg .pred p;\n"
              " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
              " selp.u32 %0, 1, 0, p;\n}\n"
              : "=r"(done) : "r"(saddr(&posted[q])), "r"((phases >> q) & 1u)
              : "memory");
        }
        phases ^= 1u << q;
      } else {
        cluster.sync();
      }
      c3 = clock64();
      uint2 c = make_uint2(0u, kNoIndex);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (lane < C) {
        c = kPost ? ckey[q][lane] : *cluster.map_shared_rank(&ckey[q][0], lane);
        v = kPost ? cxyz[q][lane] : *cluster.map_shared_rank(&cxyz[q][0], lane);
      }
      hi = __reduce_max_sync(kFull, c.x);
      lo = __reduce_min_sync(kFull, c.x == hi ? c.y : kNoIndex);
      const int src = __ffs(__ballot_sync(kFull, c.x == hi && c.y == lo)) - 1;
      sx = __shfl_sync(kFull, v.x, src);
      sy = __shfl_sync(kFull, v.y, src);
      sz = __shfl_sync(kFull, v.z, src);
    }
    const long long c4 = clock64();
    if (rank == 0 && tid == 0) {
      sum[0] += c1 - c0;
      sum[1] += c2 - c1;
      sum[2] += c3 - c2;
      sum[3] += c4 - c3;
      idx_out[static_cast<size_t>(b) * k + t] = static_cast<int>(lo);
    }
  }
  if constexpr (C > 1) cg::this_cluster().sync();
  if (b == 0 && rank == 0 && tid == 0) {
    for (int i = 0; i < 4; ++i) parts[i] = sum[i];
  }
}

template <int C, int R, bool kPost, bool kWork>
float launch(const float* pts, int b, int n, int k, int* idx, long long* parts) {
  auto kernel = split_kernel<C, R, kPost, kWork>;
  const size_t smem = static_cast<size_t>(T) * R * 12;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * C);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, kernel, pts, n, k, idx, parts);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  cudaLaunchKernelEx(&cfg, kernel, pts, n, k, idx, parts);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.0f;
}

#define VARIANTS(X)                                   \
  X(0, 8, 4, false, true)   X(1, 8, 1, false, true)   \
  X(2, 2, 16, true, true)   X(3, 1, 8, true, true)    \
  X(4, 8, 16, false, true)  X(5, 8, 16, true, true)   \
  X(6, 1, 8, true, false)   X(7, 2, 16, true, false)  \
  X(8, 4, 8, true, false)   X(9, 8, 4, true, false)   \
  X(10, 8, 4, false, false)

// milliseconds of one launch of variant v (after a warm-up), or -1
extern "C" float run(int v, const float* pts, int b, int n, int k, int* idx,
                     long long* parts) {
#define RUN(V, C, R, P, W) \
  if (v == V) return launch<C, R, P, W>(pts, b, n, k, idx, parts);
  VARIANTS(RUN)
#undef RUN
  return -1.0f;
}

extern "C" int clock_khz() {
  int dev = 0, khz = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  return khz;
}
"""
# (variant, label, C, R, exchange, work, B, N, k)
ROWS = (
    (0, "as it was", 8, 4, "sync", True, 50, 32768, 64),
    (2, "as it is", 2, 16, "post", True, 50, 32768, 64),
    (1, "as it was", 8, 1, "sync", True, 2, 8192, 8192),
    (3, "as it is", 1, 8, "post", True, 2, 8192, 8192),
    (4, "as it was", 8, 16, "sync", True, 2, 100003, 1024),
    (5, "as it is", 8, 16, "post", True, 2, 100003, 1024),
    (10, "exchange only, as it was", 8, 4, "sync", False, 50, 32768, 64),
    (6, "exchange only", 1, 8, "post", False, 2, 8192, 1024),
    (7, "exchange only", 2, 16, "post", False, 50, 32768, 1024),
    (8, "exchange only", 4, 8, "post", False, 50, 32768, 1024),
    (9, "exchange only", 8, 4, "post", False, 50, 32768, 1024),
)
PARTS = ("point updates", "block barrier", "cluster barrier", "slot reads")


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from samplenet_tpu_torch.ops.cuda import fps
    from samplenet_tpu_torch.ops.cuda._build import CSRC, find_nvcc

    if not torch.cuda.is_available():
        print("fps_pick_split: no CUDA device", file=sys.stderr)
        return 1
    out_dir = os.path.join(HERE, "build", "fps_pick_split")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "split.cu")
    lib = os.path.join(out_dir, "split.so")
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(CSRC), "-o", lib, src], check=True)
    dll = ctypes.CDLL(lib)
    dll.run.restype = ctypes.c_float
    dll.run.argtypes = [ctypes.c_int, ctypes.c_void_p, *[ctypes.c_int] * 3,
                        ctypes.c_void_p, ctypes.c_void_p]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    ghz = dll.clock_khz() / 1e6
    for v, label, c, r, exchange, work, b, n, k in ROWS:
        rng = np.random.default_rng(n + k)
        pts = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(
            np.float32)).cuda()
        idx = torch.empty((b, k), dtype=torch.int32, device="cuda")
        parts = torch.zeros(4, dtype=torch.int64, device="cuda")
        ms = dll.run(v, pts.data_ptr(), b, n, k, idx.data_ptr(),
                     parts.data_ptr())
        torch.cuda.synchronize()
        if ms < 0:
            raise RuntimeError(f"variant {v} failed to launch")
        cyc = [float(x) / k for x in parts.cpu().tolist()]
        same = ""
        if work:
            given = torch.zeros((b, k), dtype=torch.int32, device="cuda")
            one = torch.ones(b, dtype=torch.int32, device="cuda")
            same = (f"; picks equal the shipped kernel's: "
                    f"{torch.equal(fps(pts, given, one, k)[0], idx)}")
        split = ", ".join(f"{name} {x!r} cycles ({x / ghz / 1e3!r} us)"
                          for name, x in zip(PARTS, cyc))
        print(f"fps pick split, {label}: C={c}, R={r}, {exchange} exchange, "
              f"(B, N, k) = {(b, n, k)}: {split}; a pick "
              f"{sum(cyc)!r} cycles; kernel {ms!r} ms = "
              f"{ms / k * 1e3!r} us a pick (events; max SM clock {ghz!r} "
              f"GHz){same} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
