// Seeded farthest point sampling that emits the picked indices and points.
//
// Replaces: samplenet_tpu/ops/pallas/fps_kernel.py::_fps_kernel (:27,
//   `pl.pallas_call` :126), which serves all four Pallas entry points
//   (farthest_point_sample_pallas(_with_points) :174/:194,
//   fps_from_given_pallas(_with_points) :216/:230).
//
// Semantics: for t < count[b] the pick is given[b, t]; after that it is the
// first index of the maximum of the running min-distance, which starts at
// +inf. The plain variant is count = 1 with given[:, 0] = start. NaN follows
// the JAX package and the plain version (ops/cuda/fps_kernel.py::fps_plain:
// torch.minimum, torch.argmax): the running minimum propagates NaN, and the
// argmax ranks NaN above every number, ties (NaN ties included) going to
// the lowest index; a picked point with a NaN coordinate makes every
// distance NaN, so the next pick is index 0.
//
// What bounds it on the H100: at the serving path's shape (B=1024 clouds,
// k=32 picks, N=1024 points) it is at most 33.5M distance updates, about
// 0.3 GFLOP, and 12.6 MB read once: microseconds of the FP32 pipes or of
// HBM. The picks after the given prefix are k dependent steps, each an
// argmax over the cloud, so the kernel is bound by the instructions issued
// a step and by the latency of the step's reduction.
//
// Design: one block of `warps` warps a cloud (the launch plan,
// ops/cuda/fps_plan.py, sets warps and R from the shape). Thread t holds
// points t, t + T, ..., t + (R-1) T of the cloud (T threads) and their
// running min-distances in registers; the cloud also lies in shared memory
// as it lies in HBM ([N*3] floats, loaded as float4), where the picks'
// coordinates are read. Clouds too long for the registers take the
// variant that rereads each point's xyz from shared memory every step.
//
//   * The given prefix is one pass: min is exact and independent of order,
//     NaN included, so each point takes the min over the count[b] given
//     points (their xyz staged as float4) with no argmax and no barrier.
//   * Each completion step: a thread keeps the first of its maxima by the
//     distance's bits (non-negative floats order as their bits; min.NaN
//     gives the canonical NaN 0x7fffffff, which sorts above +inf), a warp
//     takes the maximum bits and then the least index among them with
//     redux.sync, and the warps meet in double-buffered slots behind one
//     barrier. The last pick updates nothing.
//   * Points past N are padding at (0, 0, 0) with distance +0: their bits
//     never exceed a real point's and their indices are higher, so they
//     never win.
//   * idx and xyz are written once at the end, coalesced, xyz copied from
//     the staged cloud.
//
// Distances are (dx*dx + dy*dy) + dz*dz with __fmul_rn/__fadd_rn (no FMA
// contraction), in the order of fps_kernel.py:58 and of the plain version,
// and the emitted xyz are copies, so idx and xyz equal the plain version
// bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "sqdist.cuh"

namespace {

constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoIndex = 0xffffffffu;
constexpr int kSharedPoints = 16;  // R of the variant that rereads xyz

// The widest block a kernel of R points a thread may launch: its registers
// (4 R floats a thread with xyz held, R with xyz reread) set it.
__host__ __device__ constexpr int max_threads(int r, bool shared) {
  return shared ? 1024 : (r >= 32 ? 256 : (r >= 16 ? 512 : 1024));
}

// Dynamic shared memory, in this order: the warps' slots (2 x 32 uint2),
// the cloud ([3n] floats, padded to 16 bytes), the given points' xyz
// (float4 [k]) and the picks (int [k]).
constexpr size_t kSlotBytes = 2 * kMaxWarps * sizeof(uint2);

__host__ __device__ constexpr size_t cloud_bytes(int n) {
  return (static_cast<size_t>(n) * 12 + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t fps_smem(int n, int k) {
  return kSlotBytes + cloud_bytes(n) + static_cast<size_t>(k) * 20;
}

template <int R, bool kShared>
__global__ void __launch_bounds__(max_threads(R, kShared))
fps_kernel(const float* __restrict__ points,  // [B, n, 3]
           const int* __restrict__ given,     // [B, k]
           const int* __restrict__ count,     // [B]
           int* __restrict__ idx_out,         // [B, k]
           float* __restrict__ xyz_out,       // [B, k, 3]
           int n, int k) {
  extern __shared__ float4 smem4[];
  uint2* slots = reinterpret_cast<uint2*>(smem4);              // [2][32]
  float* cloud = reinterpret_cast<float*>(smem4 + kSlotBytes / 16);
  float4* gxyz = smem4 + (kSlotBytes + cloud_bytes(n)) / 16;   // [k]
  int* picks = reinterpret_cast<int*>(gxyz + k);               // [k]

  const int threads = blockDim.x;
  const int warps = threads / 32;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x;
  const float* pb = points + static_cast<size_t>(b) * n * 3;
  const int cnt = min(max(count[b], 0), k);

  // The cloud, 16 bytes a load where it starts on 16 bytes.
  const int nf = 3 * n;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(pb) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(pb);
    float4* dst = smem4 + kSlotBytes / 16;
    for (int e = tid; e < nf / 4; e += threads) dst[e] = __ldg(src + e);
    head = nf / 4 * 4;
  }
  for (int e = head + tid; e < nf; e += threads) cloud[e] = __ldg(pb + e);
  // The given prefix: the first picks, their points read from HBM while
  // the cloud lands. An out-of-range index reads as the origin, as the
  // Pallas kernel's one-hot select does; nothing is read outside the cloud.
  for (int t = tid; t < cnt; t += threads) {
    const int g = given[static_cast<size_t>(b) * k + t];
    picks[t] = g;
    gxyz[t] = g >= 0 && g < n
                  ? make_float4(__ldg(pb + 3 * g), __ldg(pb + 3 * g + 1),
                                __ldg(pb + 3 * g + 2), 0.0f)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  // This thread's points: held (xyz and distance) or, in the shared
  // variant, the distance only, xyz reread at index min(p, n - 1) (a
  // padding point then copies point n - 1, whose index is lower).
  float px[kShared ? 1 : R], py[kShared ? 1 : R], pz[kShared ? 1 : R];
  float pd[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int p = tid + j * threads;
    const bool real = p < n;
    if constexpr (!kShared) {
      px[j] = real ? cloud[3 * p] : 0.0f;
      py[j] = real ? cloud[3 * p + 1] : 0.0f;
      pz[j] = real ? cloud[3 * p + 2] : 0.0f;
    }
    pd[j] = real ? CUDART_INF_F : 0.0f;
  }

  auto update = [&](float sx, float sy, float sz) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float x, y, z;
      if constexpr (kShared) {
        const int q = min(tid + j * threads, n - 1);
        x = cloud[3 * q];
        y = cloud[3 * q + 1];
        z = cloud[3 * q + 2];
      } else {
        x = px[j];
        y = py[j];
        z = pz[j];
      }
      pd[j] = min_nan(pd[j], sqdist(x, y, z, sx, sy, sz));
    }
  };

  for (int t = 0; t < cnt; ++t) {
    const float4 g = gxyz[t];
    update(g.x, g.y, g.z);
  }

  for (int t = cnt; t < k; ++t) {
    unsigned best = 0u;  // point j = 0's bits are >= 0: a valid start
    int bj = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const unsigned key = __float_as_uint(pd[j]);
      if (key > best) {
        best = key;
        bj = j;
      }
    }
    unsigned hi = __reduce_max_sync(kFull, best);
    unsigned lo = __reduce_min_sync(
        kFull, best == hi ? static_cast<unsigned>(tid + bj * threads)
                          : kNoIndex);
    if (warps > 1) {
      // Step t writes slot row t & 1; a warp reaches step t + 2's write
      // only past step t + 1's barrier, after every warp read row t & 1.
      uint2* row = slots + (t & 1) * kMaxWarps;
      if (lane == 0) row[warp] = make_uint2(hi, lo);
      __syncthreads();
      const uint2 s = lane < warps ? row[lane] : make_uint2(0u, kNoIndex);
      hi = __reduce_max_sync(kFull, s.x);
      lo = __reduce_min_sync(kFull, s.x == hi ? s.y : kNoIndex);
    }
    const int far = static_cast<int>(lo);
    if (tid == 0) picks[t] = far;
    if (t + 1 < k) update(cloud[3 * far], cloud[3 * far + 1],
                          cloud[3 * far + 2]);
  }
  __syncthreads();

  const size_t o = static_cast<size_t>(b) * k;
  for (int t = tid; t < k; t += threads) idx_out[o + t] = picks[t];
  for (int e = tid; e < 3 * k; e += threads) {
    const int t = e / 3;
    const int p = picks[t];
    xyz_out[o * 3 + e] = p >= 0 && p < n ? cloud[3 * p + (e - 3 * t)] : 0.0f;
  }
}

template <int R, bool kShared>
cudaError_t launch(const float* points, const int* given, const int* count,
                   int* idx, float* xyz, int b, int n, int k, int warps,
                   cudaStream_t stream) {
  if (32 * warps > max_threads(R, kShared) ||
      static_cast<long long>(32) * warps * R < n) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = fps_smem(n, k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<R, kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_kernel<R, kShared><<<b, 32 * warps, smem, stream>>>(points, given,
                                                          count, idx, xyz,
                                                          n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t snt_fps_smem(int n, int k) { return fps_smem(n, k); }

extern "C" int snt_fps_max_threads(int r, int shared) {
  return max_threads(r, shared != 0);
}

extern "C" int snt_fps_shared_points() { return kSharedPoints; }

// warps (a block has 32 * warps threads, one block a cloud), r (points a
// thread) and shared (xyz reread from shared memory; r must then be
// kSharedPoints) come from the launch plan.
extern "C" int snt_fps(const float* points, const int* given,
                       const int* count, int* idx, float* xyz, int b, int n,
                       int k, int warps, int r, int shared,
                       cudaStream_t stream) {
  if (b < 1 || n < 1 || k < 1 || warps < 1 || warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (shared) {
    if (r == kSharedPoints) {
      err = launch<kSharedPoints, true>(points, given, count, idx, xyz, b, n,
                                        k, warps, stream);
    }
  } else {
    switch (r) {
#define SNT_FPS_CASE(R)                                                     \
  case R:                                                                   \
    err = launch<R, false>(points, given, count, idx, xyz, b, n, k, warps,  \
                           stream);                                         \
    break;
      SNT_FPS_CASE(1)
      SNT_FPS_CASE(2)
      SNT_FPS_CASE(4)
      SNT_FPS_CASE(8)
      SNT_FPS_CASE(16)
      SNT_FPS_CASE(32)
#undef SNT_FPS_CASE
      default:
        break;
    }
  }
  return static_cast<int>(err);
}
