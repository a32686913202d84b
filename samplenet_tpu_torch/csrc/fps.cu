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
//
// The cluster variant takes the clouds that one block cannot hold: more
// than 16,384 points, or a cloud and picks beyond a block's shared memory
// (the plan sends it only the shapes the kernel above refuses). A cloud is
// C blocks of 1024 threads, C in {1, 2, 4, 8} a build (one thread-block
// cluster where C > 1), so that its running distances spread over C SMs;
// the launch plan (ops/cuda/fps_plan.py) takes the fewest waves of clouds
// the card runs at once (cudaOccupancyMaxActiveClusters), then the
// smallest C.
//   * Registers (R = 1..16 points a thread, C * 1024 * R >= N): block c
//     stages its slice, points [c S, c S + S) with S = 1024 R, in its
//     shared memory (12 bytes a point) and thread t holds the running
//     distances of slice points t, t + 1024, ... in registers. Streamed
//     (any N, C = 16, a non-portable cluster: each pick rereads the cloud
//     from L2, so twice the SMs of C = 8 each read half as much): thread t
//     of block c takes points c * 1024 + t + i * 1024 C, their running
//     distances in a [B, N] workspace in device
//     memory that the wrapper allocates, their xyz read from device memory
//     (L2) every step.
//   * The given prefix: its points staged 256 at a time (a fixed buffer,
//     so k costs no shared memory); each point takes the min over them.
//   * Each completion step updates the thread's points with the last pick
//     and keeps their first maximum by bits, as above; the warps meet in
//     double-buffered slots behind one barrier. With C = 1 every warp then
//     reads the slots and takes the pick, whose xyz is in the slice: one
//     barrier a step, the picks written straight to device memory. With
//     C > 1 warp 0 takes the block's (bits, index) and that point's xyz,
//     and lane j posts them into block j's slot for this block (a store
//     through distributed shared memory, then an arrival with release at
//     cluster scope on block j's mbarrier of the step's parity): one
//     exchange a step. Every thread waits on its own block's mbarrier for
//     the C posts, reads the C slots locally and takes the same maximum,
//     lowest index first, and the pick's xyz from the winning slot. A
//     block posts step t + 2 into a slot only after every block's post of
//     step t + 1 reached it, which each block makes after all its warps
//     read step t's slots: two slots and two mbarriers are enough. Block 0
//     writes the picks as they come.
// The order of each running minimum and the tie rule are the block
// variant's, so the outputs equal the plain version's bit for bit under
// every R.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
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

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 1024;  // a block of the cluster variant
constexpr int kMaxCluster = 8;         // its largest cluster: the portable size
constexpr int kStreamCluster = 16;     // the streamed variant's cluster
                                       // (non-portable: twice the SMs, and
                                       // their L2 reads, of 8 a cloud)
constexpr int kGivenChunk = 256;       // given points staged at a time
constexpr int kMaxClusterPoints = 16;  // R with the slice in shared memory

// Dynamic shared memory of the cluster variant: the block's slice of the
// cloud, 12 bytes a point (none when streamed).
__host__ __device__ constexpr size_t cluster_smem(int r) {
  return static_cast<size_t>(kClusterThreads) * r * 12;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One arrival, with release at cluster scope, on the mbarrier at `bar`'s
// place in the shared memory of the cluster's block `rank`: the arriving
// thread's earlier stores (its posts) are seen by whoever waits there.
__device__ __forceinline__ void arrive_remote(unsigned long long* bar, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               ::"r"(remote) : "memory");
}

// Waits, with acquire at cluster scope, until the phase of parity `parity`
// of this block's mbarrier `bar` completes.
__device__ __forceinline__ void wait_phase(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// A cloud is C blocks (one cluster where C > 1). R > 0: the slice in
// shared memory and R running distances a thread in registers; R = 0:
// streamed, the distances in dist [B, n].
template <int C, int R>
__global__ void __launch_bounds__(kClusterThreads)
fps_cluster_kernel(const float* __restrict__ points,  // [B, n, 3]
                   const int* __restrict__ given,     // [B, k]
                   const int* __restrict__ count,     // [B]
                   int* __restrict__ idx_out,         // [B, k]
                   float* __restrict__ xyz_out,       // [B, k, 3]
                   float* __restrict__ dist,          // [B, n] if R == 0
                   int n, int k) {
  constexpr int T = kClusterThreads;
  constexpr int kWarps = T / 32;
  extern __shared__ float slice[];             // [3 S] if R > 0
  __shared__ uint2 wslots[2][kWarps];
  __shared__ uint2 ckey[2][C];                 // each block's (bits, index),
  __shared__ float4 cxyz[2][C];                // that point's xyz, by rank
  __shared__ unsigned long long posted[2];     // C posts of a step's parity
  __shared__ float4 gbuf[kGivenChunk];
  int rank = 0;
  if constexpr (C > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = static_cast<int>(blockIdx.x / C);
  const float* pb = points + static_cast<size_t>(b) * n * 3;
  const int cnt = min(max(count[b], 0), k);
  const size_t o = static_cast<size_t>(b) * k;
  // registers: this block's slice [s0, s0 + nl); streamed: this thread's
  // points first, first + stride, ...
  constexpr long long S = static_cast<long long>(T) * (R > 0 ? R : 1);
  const long long s0 = rank * S;
  const int nl = R > 0 ? static_cast<int>(max(0LL, min(S, n - s0))) : 0;
  const long long first = static_cast<long long>(rank) * T + tid;
  const long long stride = static_cast<long long>(T) * C;
  float* db = dist + (R > 0 ? 0 : static_cast<size_t>(b) * n);

  if constexpr (C > 1) {
    if (tid == 0) {
      for (int q = 0; q < 2; ++q) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                     ::"r"(smem_addr(&posted[q])), "r"(C) : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cg::this_cluster().sync();  // no peer arrives before the init
  }
  float pd[R > 0 ? R : 1];
  if constexpr (R > 0) {
    for (int e = tid; e < 3 * nl; e += T) slice[e] = __ldg(pb + 3 * s0 + e);
#pragma unroll
    for (int j = 0; j < R; ++j) pd[j] = tid + j * T < nl ? CUDART_INF_F : 0.0f;
  } else {
    for (long long p = first; p < n; p += stride) db[p] = CUDART_INF_F;
  }
  // the given prefix: the picks written by block 0, an index out of range
  // reading as the origin, as the block variant does
  if (rank == 0) {
    for (int t = tid; t < cnt; t += T) {
      const int g = given[o + t];
      const bool in = g >= 0 && g < n;
      idx_out[o + t] = g;
      for (int c = 0; c < 3; ++c) {
        xyz_out[(o + t) * 3 + c] = in ? __ldg(pb + 3 * static_cast<size_t>(g) + c)
                                      : 0.0f;
      }
    }
  }
  for (int t0 = 0; t0 < cnt; t0 += kGivenChunk) {
    const int tn = min(kGivenChunk, cnt - t0);
    __syncthreads();  // the previous chunk is read (and the slice staged)
    for (int t = tid; t < tn; t += T) {
      const int g = given[o + t0 + t];
      const float* gp = pb + 3 * static_cast<size_t>(g);
      gbuf[t] = g >= 0 && g < n
                    ? make_float4(__ldg(gp), __ldg(gp + 1), __ldg(gp + 2), 0.0f)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    if constexpr (R > 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int l = tid + j * T;
        if (l < nl) {
          const float x = slice[3 * l], y = slice[3 * l + 1],
                      z = slice[3 * l + 2];
          float d = pd[j];
          for (int t = 0; t < tn; ++t) {
            const float4 g = gbuf[t];
            d = min_nan(d, sqdist(x, y, z, g.x, g.y, g.z));
          }
          pd[j] = d;
        }
      }
    } else {
      for (long long p = first; p < n; p += stride) {
        const float x = __ldg(pb + 3 * p), y = __ldg(pb + 3 * p + 1),
                    z = __ldg(pb + 3 * p + 2);
        float d = db[p];
        for (int t = 0; t < tn; ++t) {
          const float4 g = gbuf[t];
          d = min_nan(d, sqdist(x, y, z, g.x, g.y, g.z));
        }
        db[p] = d;
      }
    }
  }
  __syncthreads();  // the slice is staged, even where no prefix ran

  float sx = 0.0f, sy = 0.0f, sz = 0.0f;  // the last pick, once there is one
  unsigned phases = 0u;                   // bit q: the parity posted[q] waits on
  for (int t = cnt; t < k; ++t) {
    const bool update = t > cnt;
    const int q = t & 1;
    unsigned best = 0u, bi = kNoIndex;
    if constexpr (R > 0) {
      bi = static_cast<unsigned>(s0 + tid);  // point j = 0: a valid start
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int l = tid + j * T;
        if (update && l < nl) {
          pd[j] = min_nan(pd[j], sqdist(slice[3 * l], slice[3 * l + 1],
                                        slice[3 * l + 2], sx, sy, sz));
        }
        const unsigned key = __float_as_uint(pd[j]);
        if (key > best) {
          best = key;
          bi = static_cast<unsigned>(s0 + l);
        }
      }
    } else {
      for (long long p = first; p < n; p += stride) {
        float d = db[p];
        if (update) {
          d = min_nan(d, sqdist(__ldg(pb + 3 * p), __ldg(pb + 3 * p + 1),
                                __ldg(pb + 3 * p + 2), sx, sy, sz));
          db[p] = d;
        }
        const unsigned key = __float_as_uint(d);
        if (key > best || bi == kNoIndex) {
          best = key;
          bi = static_cast<unsigned>(p);
        }
      }
    }
    // the warp's, then the block's (bits, lowest index)
    unsigned hi = __reduce_max_sync(kFull, best);
    unsigned lo = __reduce_min_sync(kFull, best == hi ? bi : kNoIndex);
    if (lane == 0) wslots[q][warp] = make_uint2(hi, lo);
    __syncthreads();
    if constexpr (C == 1) {  // every warp reads the slots: the pick
      const uint2 w = wslots[q][lane];  // kWarps == 32 slots
      hi = __reduce_max_sync(kFull, w.x);
      lo = __reduce_min_sync(kFull, w.x == hi ? w.y : kNoIndex);
      const long long l = lo < static_cast<unsigned>(n) ? lo : 0;
      sx = slice[3 * l];
      sy = slice[3 * l + 1];
      sz = slice[3 * l + 2];
    } else {
      if (warp == 0) {  // the block's maximum, posted to every block
        const uint2 w = wslots[q][lane];
        hi = __reduce_max_sync(kFull, w.x);
        lo = __reduce_min_sync(kFull, w.x == hi ? w.y : kNoIndex);
        if (lane < C) {
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (lo < static_cast<unsigned>(n)) {
            if constexpr (R > 0) {
              const long long l = lo - s0;
              v = make_float4(slice[3 * l], slice[3 * l + 1], slice[3 * l + 2],
                              0.0f);
            } else {
              const float* pp = pb + 3 * static_cast<size_t>(lo);
              v = make_float4(__ldg(pp), __ldg(pp + 1), __ldg(pp + 2), 0.0f);
            }
          }
          cg::cluster_group cluster = cg::this_cluster();
          *cluster.map_shared_rank(&ckey[q][rank], lane) = make_uint2(hi, lo);
          *cluster.map_shared_rank(&cxyz[q][rank], lane) = v;
          arrive_remote(&posted[q], lane);
        }
      }
      // the cluster's: every warp reads the C posts in its own block
      wait_phase(&posted[q], (phases >> q) & 1u);
      phases ^= 1u << q;
      uint2 c = make_uint2(0u, kNoIndex);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (lane < C) {
        c = ckey[q][lane];
        v = cxyz[q][lane];
      }
      hi = __reduce_max_sync(kFull, c.x);
      lo = __reduce_min_sync(kFull, c.x == hi ? c.y : kNoIndex);
      const int src = __ffs(__ballot_sync(kFull, c.x == hi && c.y == lo)) - 1;
      sx = __shfl_sync(kFull, v.x, src);
      sy = __shfl_sync(kFull, v.y, src);
      sz = __shfl_sync(kFull, v.z, src);
    }
    if (rank == 0 && tid == 0) {
      idx_out[o + t] = static_cast<int>(lo);
      xyz_out[(o + t) * 3 + 0] = sx;
      xyz_out[(o + t) * 3 + 1] = sy;
      xyz_out[(o + t) * 3 + 2] = sz;
    }
  }
  if constexpr (C > 1) cg::this_cluster().sync();  // the last posts landed
}

template <int C, int R>
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           int b, cudaStream_t stream) {
  const size_t smem = cluster_smem(R);
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_cluster_kernel<C, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (C > kMaxCluster) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_cluster_kernel<C, R>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = {};
  cfg->gridDim = dim3(static_cast<unsigned>(b) * C);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = C > 1 ? 1 : 0;
  return cudaSuccess;
}

template <int C, int R>
cudaError_t launch_cluster(const float* points, const int* given,
                           const int* count, int* idx, float* xyz,
                           float* dist, int b, int n, int k,
                           cudaStream_t stream) {
  if (R == 0 ? dist == nullptr
             : static_cast<long long>(C) * kClusterThreads * R < n) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config<C, R>(&cfg, attr, b, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<C, R>, points, given,
                           count, idx, xyz, dist, n, k);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clouds of the kernel for (C, R) that the card runs at once (a cloud a
// cluster), or -1 where the query fails
template <int C, int R>
int active_clouds() {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (cluster_config<C, R>(&cfg, attr, 1, nullptr) != cudaSuccess) return -1;
  int clouds = -1;
  if constexpr (C > 1) {
    if (cudaOccupancyMaxActiveClusters(&clouds, fps_cluster_kernel<C, R>, &cfg) !=
        cudaSuccess) {
      return -1;
    }
  } else {
    int per_sm = 0, device = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fps_cluster_kernel<C, R>, kClusterThreads,
            cfg.dynamicSmemBytes) != cudaSuccess ||
        cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess) {
      return -1;
    }
    clouds = per_sm * sms;
  }
  return clouds;
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

extern "C" size_t snt_fps_cluster_smem(int r) { return cluster_smem(r); }

// The cluster variant's limits: 0 its largest cluster, 1 its block's
// threads, 2 the given points staged at a time, 3 its largest R, 4 the
// streamed variant's cluster.
extern "C" int snt_fps_cluster_limit(int which) {
  const int limits[] = {kMaxCluster, kClusterThreads, kGivenChunk,
                        kMaxClusterPoints, kStreamCluster};
  return which >= 0 && which < 5 ? limits[which] : -1;
}

// The cluster variant's builds: C in {1, 2, 4, 8} with R in {1, 2, 4, 8,
// 16}, and the streamed R = 0 at C = kStreamCluster.
#define SNT_FPS_CLUSTER_BUILDS(X) \
  X(1, 1) X(1, 2) X(1, 4) X(1, 8) X(1, 16) \
  X(2, 1) X(2, 2) X(2, 4) X(2, 8) X(2, 16) \
  X(4, 1) X(4, 2) X(4, 4) X(4, 8) X(4, 16) \
  X(8, 1) X(8, 2) X(8, 4) X(8, 8) X(8, 16) X(kStreamCluster, 0)

// Clouds the card runs at once with the build (c, r), or -1 where there is
// no such build or the query fails.
extern "C" int snt_fps_cluster_active(int c, int r) {
#define SNT_FPS_ACTIVE(CC, RR) \
  if (c == CC && r == RR) return active_clouds<CC, RR>();
  SNT_FPS_CLUSTER_BUILDS(SNT_FPS_ACTIVE)
#undef SNT_FPS_ACTIVE
  return -1;
}

// The cluster variant: c blocks a cloud (one cluster where c > 1), r points
// a thread in registers (c * 1024 * r >= n), or r = 0, the running
// distances streamed through dist [B, n], the caller's workspace; (c, r)
// one of SNT_FPS_CLUSTER_BUILDS.
extern "C" int snt_fps_cluster(const float* points, const int* given,
                               const int* count, int* idx, float* xyz,
                               float* dist, int b, int n, int k, int c, int r,
                               cudaStream_t stream) {
  if (b < 1 || n < 1 || k < 1 ||
      static_cast<long long>(b) * kStreamCluster > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define SNT_FPS_LAUNCH(CC, RR)                                               \
  if (c == CC && r == RR) {                                                  \
    return static_cast<int>(launch_cluster<CC, RR>(points, given, count, idx, \
                                                   xyz, dist, b, n, k,       \
                                                   stream));                 \
  }
  SNT_FPS_CLUSTER_BUILDS(SNT_FPS_LAUNCH)
#undef SNT_FPS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
