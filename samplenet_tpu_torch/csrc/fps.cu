// Seeded farthest point sampling that emits the picked indices and points.
//
// Replaces: samplenet_tpu/ops/pallas/fps_kernel.py::_fps_kernel (:27,
//   `pl.pallas_call` :126), which serves all four Pallas entry points
//   (farthest_point_sample_pallas(_with_points) :174/:194,
//   fps_from_given_pallas(_with_points) :216/:230).
//
// Semantics: for t < count[b] the pick is given[b, t]; after that it is the
// first index of the maximum of the running min-distance, which starts at
// +inf. The plain variant is count = 1 with given[:, 0] = start.
//
// What bounds it on the H100: at the serving path's shape (B=1024 clouds,
// k=32 steps, N=1024 points) it is 33.5M distance updates, about 0.3 GFLOP,
// and 12.6 MB read once. The work is tiny; the bound is the latency of k
// dependent steps, each a block-wide argmax behind two barriers.
//
// Design: one block per cloud. Points and the running min-distance live in
// shared memory as structure-of-arrays (16 bytes a point), so HBM sees each
// input once. Each thread owns points tid, tid+kThreads, ... and keeps the
// first index of its maximum with a strict '>'; warp shuffles and one
// cross-warp pass merge with ties to the lower index, as torch.argmax
// breaks them. Many clouds' blocks share an SM and hide each other's
// barrier latency. Distances are (dx*dx + dy*dy) + dz*dz with
// __fmul_rn/__fadd_rn (no FMA contraction), in the order of
// fps_kernel.py:58, and the emitted xyz are copies, so idx and xyz equal the
// plain version (ops/cuda/fps_kernel.py::fps_plain) bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "sqdist.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// (value, index) merge for an argmax whose ties go to the lower index.
__device__ __forceinline__ void take_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ points,  // [B, n, 3]
           const int* __restrict__ given,     // [B, k]
           const int* __restrict__ count,     // [B]
           int* __restrict__ idx_out,         // [B, k]
           float* __restrict__ xyz_out,       // [B, k, 3]
           int n, int k) {
  extern __shared__ float smem[];
  float* px = smem;
  float* py = px + n;
  float* pz = py + n;
  float* pd = pz + n;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int far_shared;

  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* pb = points + static_cast<size_t>(b) * n * 3;
  for (int e = threadIdx.x; e < n * 3; e += kThreads) {
    const float v = pb[e];
    const int p = e / 3, c = e % 3;
    (c == 0 ? px : (c == 1 ? py : pz))[p] = v;
  }
  for (int p = threadIdx.x; p < n; p += kThreads) pd[p] = CUDART_INF_F;
  const int cnt = count[b];
  int far = 0;  // argmax of an all-inf buffer
  __syncthreads();

  for (int t = 0; t < k; ++t) {
    const int sel = t < cnt ? given[static_cast<size_t>(b) * k + t] : far;
    // An out-of-range given index reads as the origin, as the Pallas
    // kernel's one-hot select does; it never reads outside the cloud.
    const bool in_range = sel >= 0 && sel < n;
    const float sx = in_range ? px[sel] : 0.0f;
    const float sy = in_range ? py[sel] : 0.0f;
    const float sz = in_range ? pz[sel] : 0.0f;
    if (threadIdx.x == 0) {
      const size_t o = static_cast<size_t>(b) * k + t;
      idx_out[o] = sel;
      xyz_out[o * 3 + 0] = sx;
      xyz_out[o * 3 + 1] = sy;
      xyz_out[o * 3 + 2] = sz;
    }
    float v = -CUDART_INF_F;
    int i = INT_MAX;
    for (int p = threadIdx.x; p < n; p += kThreads) {
      const float d = sqdist(px[p], py[p], pz[p], sx, sy, sz);
      const float m = d < pd[p] ? d : pd[p];
      pd[p] = m;
      if (m > v) {
        v = m;
        i = p;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      take_max(v, i, __shfl_down_sync(0xffffffffu, v, off),
               __shfl_down_sync(0xffffffffu, i, off));
    }
    if (lane == 0) {
      red_v[warp] = v;
      red_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? red_v[lane] : -CUDART_INF_F;
      i = lane < kWarps ? red_i[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        take_max(v, i, __shfl_down_sync(0xffffffffu, v, off),
                 __shfl_down_sync(0xffffffffu, i, off));
      }
      if (lane == 0) far_shared = i;
    }
    __syncthreads();
    far = far_shared;
  }
}

}  // namespace

extern "C" int snt_fps(const float* points, const int* given,
                       const int* count, int* idx, float* xyz, int b, int n,
                       int k, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * 4 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fps_kernel<<<b, kThreads, smem, stream>>>(points, given, count, idx, xyz,
                                           n, k);
  return static_cast<int>(cudaGetLastError());
}
