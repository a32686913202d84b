// Train-mode per-point MLP chain with exact batch-global BatchNorm + global
// max, forward and backward.
//
// Replaces: samplenet_tpu/ops/pallas/point_mlp_exact_kernel.py::
//   point_mlp_exact_train_max (entry :499; `pl.pallas_call` :226 stats,
//   :244 chain, :262 top, :315 per-layer backward).
//
// Per layer l (z_l = h_{l-1} W_l, the dense bias never enters: BN cancels
// it), over all P = B*N points: mu_l = mean z_l, var_l = mean z_l^2 -
// mu_l^2 (biased, fast variance), xhat = (z_l - mu_l) * rstd_l,
// h_l = relu(gamma_l * xhat + beta_l); pooled = max over each cloud of h_L.
//
// Design: the TPU kernel recomputes the chain in VMEM (L stats passes, a
// chain pass, a top pass, L backward passes) because its HBM was small.
// The H100 has 80 GB, so this one keeps every pre-BN z_l in HBM instead
// (P x sum(C_l) floats: 1.9 GB at the train shape) and never recomputes a
// matmul: forward and backward each run one pass per layer.
//
//   pme_dense   z_l = act(in) W_l over 64-point tiles held in shared
//               memory (4 points x 4 channels per thread, as in
//               point_mlp_max.cu), where act is the previous layer's BN +
//               ReLU applied as the tile is loaded; each block also sums z
//               and z^2 per channel over its tiles, in point order, into
//               one partial row that the caller reduces (no atomics).
//   pme_pool    per cloud and channel, max over points of h_L and the
//               first point that attains it (a NaN wins, as in torch).
//   pme_rows    per block (one 64-point tile, or one cloud for the top
//               layer), sum dy and sum dy*xhat for one layer (dy = dh
//               where h > 0): BN's two global coupling vectors, which are
//               d beta and d gamma. For the top layer dh is sparse: the
//               pooled cotangent at each cloud's argmax.
//   pme_bwd     dz = rstd * (gamma*dy - r1 - xhat*r2) (r1, r2 from the
//               reduced rows), then per block the partial dW = h_prev^T dz
//               accumulated in shared memory over its tiles, and
//               dh_prev = dz W^T (dx for the first layer) to HBM.
//
// Every partial (stats rows, BN rows, dW) is summed by the caller with a
// torch reduction over a grid fixed by the shape, so two runs give the
// same bits. Each 64-point tile is summed in f32 and the tiles' sums are
// accumulated in f64: the lower layers' gradients are sums over all B*N
// points of terms that BN's correction makes nearly cancel, and an f32
// running sum over a block's ~4k points loses more than the terms'
// own rounding. BN uses __fsub_rn/__fmul_rn/__fmaf_rn in one helper, so
// the forward's ReLU mask and the backward's agree exactly.
//
// What bounds it on the H100: at B=1024, N=1024, widths 3->64->64->64->128
// ->128 the chain is 32,960 multiply-adds per point: 69 GFLOP forward and
// 138 GFLOP backward (dW and dh), 0.21 TFLOP a step on the f32 SIMT pipes
// (67 TFLOP/s published): about 3 ms at peak. HBM traffic is about 1.9 GB
// of z written and read in the forward, and in the backward z, dh and the
// layer below's z read once per layer (about 6 GB): about 2.5 ms at
// 3.35 TB/s. bf16 operands, wgmma and fusing pme_rows into pme_bwd are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBwdThreads = 512;  // pme_bwd: one 200 KB block per SM
constexpr int kTileP = 64;
constexpr int kStride = kTileP + 4;  // 4 x odd: conflict-free float4 stores

struct BN {  // one layer's exact batch normalisation
  const float* mu;
  const float* rstd;
  const float* gamma;
  const float* beta;
};

__device__ __forceinline__ float bn_xhat(float z, float mu, float rstd) {
  return __fmul_rn(__fsub_rn(z, mu), rstd);
}

// ReLU that keeps a NaN, as torch.relu does
__device__ __forceinline__ float relu_nan(float v) {
  return (v > 0.0f || v != v) ? v : 0.0f;
}

__device__ __forceinline__ float bn_relu(const BN& bn, int c, float z) {
  return relu_nan(__fmaf_rn(bn.gamma[c], bn_xhat(z, bn.mu[c], bn.rstd[c]),
                            bn.beta[c]));
}

// Loads tile rows [p0, p0 + np) of in [P, cin] channel-major into
// hs[c * kStride + p] for c < cin_pad, as act(in) (BN + ReLU of `prev`
// when has_prev), with a block of kT threads; padded points and channels
// are 0.
template <int kT>
__device__ __forceinline__ void load_act_tile(
    float* hs, const float* __restrict__ in, int cin, int cin_pad,
    const BN& prev, int has_prev, long long p0, int np) {
  for (int e = threadIdx.x; e < kTileP * cin_pad; e += kT) {
    const int p = e / cin_pad, c = e % cin_pad;
    float v = 0.0f;
    if (p < np && c < cin) {
      v = in[(p0 + p) * cin + c];
      if (has_prev) v = bn_relu(prev, c, v);
    }
    hs[c * kStride + p] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
pme_dense_kernel(const float* __restrict__ in, int cin, BN prev, int has_prev,
                 const float* __restrict__ w,  // [cin, cout] row-major
                 int cout, float* __restrict__ z,  // [P, cout]
                 double* __restrict__ rows,        // [grid, 2, cout]
                 long long n_points) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [cin][kStride]
  float* zs = hs + cin * kStride;               // [cout][kStride]
  double* acc = reinterpret_cast<double*>(zs + cout * kStride);  // [2][cout]
  for (int c = threadIdx.x; c < 2 * cout; c += kThreads) acc[c] = 0.0;
  const long long tiles = (n_points + kTileP - 1) / kTileP;
  const int oq = cout / 4;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long p0 = t * kTileP;
    const int np = static_cast<int>(min(static_cast<long long>(kTileP), n_points - p0));
    __syncthreads();  // the previous tile's hs and zs are no longer read
    load_act_tile<kThreads>(hs, in, cin, cin, prev, has_prev, p0, np);
    __syncthreads();
    for (int u = threadIdx.x; u < (kTileP / 4) * oq; u += kThreads) {
      const int o0 = (u % oq) * 4;
      const int pp = (u / oq) * 4;
      float a[4][4] = {};
      for (int i = 0; i < cin; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + i * kStride + pp);
        const float4 wv = __ldg(reinterpret_cast<const float4*>(
            w + static_cast<size_t>(i) * cout + o0));
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int pi = 0; pi < 4; ++pi) {
#pragma unroll
          for (int oj = 0; oj < 4; ++oj) a[pi][oj] += hr[pi] * wr[oj];
        }
      }
#pragma unroll
      for (int oj = 0; oj < 4; ++oj) {
        *reinterpret_cast<float4*>(zs + (o0 + oj) * kStride + pp) =
            make_float4(a[0][oj], a[1][oj], a[2][oj], a[3][oj]);
      }
#pragma unroll
      for (int pi = 0; pi < 4; ++pi) {
        if (pp + pi < np) {
          *reinterpret_cast<float4*>(z + (p0 + pp + pi) * cout + o0) =
              make_float4(a[pi][0], a[pi][1], a[pi][2], a[pi][3]);
        }
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cout; c += kThreads) {  // owner of column c
      float s = 0.0f, s2 = 0.0f;
      for (int p = 0; p < np; ++p) {
        const float v = zs[c * kStride + p];
        s += v;
        s2 += v * v;
      }
      acc[c] += s;
      acc[cout + c] += s2;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * cout; c += kThreads) {
    rows[static_cast<size_t>(blockIdx.x) * 2 * cout + c] = acc[c];
  }
}

__global__ void __launch_bounds__(kThreads)
pme_pool_kernel(const float* __restrict__ z,  // [B, n, c]
                BN bn, int n, int c_out,
                float* __restrict__ pooled,   // [B, c]
                int* __restrict__ argmax) {   // [B, c]
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < c_out; c += kThreads) {
    const float* zb = z + static_cast<size_t>(b) * n * c_out + c;
    float best = -1.0f;  // h >= 0 (or NaN), so point 0 always replaces it
    int bi = 0;
    for (int p = 0; p < n; ++p) {
      const float h = bn_relu(bn, c, zb[static_cast<size_t>(p) * c_out]);
      if (best == best && (h > best || h != h)) {  // first max; first NaN wins
        best = h;
        bi = p;
      }
    }
    pooled[static_cast<size_t>(b) * c_out + c] = best;
    argmax[static_cast<size_t>(b) * c_out + c] = bi;
  }
}

// dh at point gp, channel c: dense [P, c] or, when dh == nullptr, the
// pooled cotangent g[b, c] at the cloud's argmax point and 0 elsewhere.
__device__ __forceinline__ float dh_at(const float* __restrict__ dh,
                                       const float* __restrict__ g,
                                       const int* __restrict__ argmax, int n,
                                       int c_out, long long gp, int c) {
  if (dh != nullptr) return dh[gp * c_out + c];
  const long long b = gp / n;
  const int p = static_cast<int>(gp - b * n);
  return argmax[b * c_out + c] == p ? g[b * c_out + c] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
pme_rows_kernel(const float* __restrict__ z, BN bn, int c_out,
                const float* __restrict__ dh, const float* __restrict__ g,
                const int* __restrict__ argmax, int n, long long n_points,
                int n_clouds, double* __restrict__ rows) {  // [grid, 2, c]
  for (int c = threadIdx.x; c < c_out; c += blockDim.x) {
    double s = 0.0, s2 = 0.0;
    if (dh == nullptr) {  // top layer: one nonzero dh per (cloud, channel)
      for (int b = blockIdx.x; b < n_clouds; b += gridDim.x) {
        const long long gp = static_cast<long long>(b) * n + argmax[static_cast<size_t>(b) * c_out + c];
        const float zz = z[gp * c_out + c];
        const float xh = bn_xhat(zz, bn.mu[c], bn.rstd[c]);
        const float h = relu_nan(__fmaf_rn(bn.gamma[c], xh, bn.beta[c]));
        const float dy = h > 0.0f ? g[static_cast<size_t>(b) * c_out + c] : 0.0f;
        s += dy;
        s2 += dy * xh;
      }
    } else {
      const long long tiles = (n_points + kTileP - 1) / kTileP;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long p1 = min(n_points, (t + 1) * kTileP);
        float ts = 0.0f, ts2 = 0.0f;
        for (long long gp = t * kTileP; gp < p1; ++gp) {
          const float zz = z[gp * c_out + c];
          const float xh = bn_xhat(zz, bn.mu[c], bn.rstd[c]);
          const float h = relu_nan(__fmaf_rn(bn.gamma[c], xh, bn.beta[c]));
          const float dy = h > 0.0f ? dh[gp * c_out + c] : 0.0f;
          ts += dy;
          ts2 += dy * xh;
        }
        s += ts;
        s2 += ts2;
      }
    }
    rows[static_cast<size_t>(blockIdx.x) * 2 * c_out + c] = s;
    rows[static_cast<size_t>(blockIdx.x) * 2 * c_out + c_out + c] = s2;
  }
}

__global__ void __launch_bounds__(kBwdThreads)
pme_bwd_kernel(const float* __restrict__ in, int cin, int cin_pad, BN prev,
               int has_prev, const float* __restrict__ z, BN bn, int cout,
               const float* __restrict__ dh, const float* __restrict__ g,
               const int* __restrict__ argmax, int n,
               const float* __restrict__ r1, const float* __restrict__ r2,
               const float* __restrict__ wt,     // [cout, cin_pad] = W^T
               double* __restrict__ dw_part,     // [grid, cin_pad, cout]
               float* __restrict__ dh_prev,      // [P, cin_pad]
               long long n_points) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [cin_pad][kStride]
  float* dzs = hs + cin_pad * kStride;          // [cout][kStride]
  double* dws = reinterpret_cast<double*>(dzs + cout * kStride);  // [cin_pad][cout]
  const int iq = cin_pad / 4, oq = cout / 4;
  for (int e = threadIdx.x; e < cin_pad * cout; e += kBwdThreads) dws[e] = 0.0;
  const long long tiles = (n_points + kTileP - 1) / kTileP;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long p0 = t * kTileP;
    const int np = static_cast<int>(min(static_cast<long long>(kTileP), n_points - p0));
    __syncthreads();  // the previous tile's hs and dzs are no longer read
    load_act_tile<kBwdThreads>(hs, in, cin, cin_pad, prev, has_prev, p0, np);
    for (int e = threadIdx.x; e < kTileP * cout; e += kBwdThreads) {
      const int p = e / cout, o = e % cout;
      float v = 0.0f;
      if (p < np) {
        const long long gp = p0 + p;
        const float xh = bn_xhat(z[gp * cout + o], bn.mu[o], bn.rstd[o]);
        const float h = relu_nan(__fmaf_rn(bn.gamma[o], xh, bn.beta[o]));
        const float dy = h > 0.0f ? dh_at(dh, g, argmax, n, cout, gp, o) : 0.0f;
        v = bn.rstd[o] * (bn.gamma[o] * dy - r1[o] - xh * r2[o]);
      }
      dzs[o * kStride + p] = v;
    }
    __syncthreads();
    // dW[i, o] += sum_p h_prev[p, i] dz[p, o]: each thread owns 4x4 blocks
    for (int u = threadIdx.x; u < iq * oq; u += kBwdThreads) {
      const int i0 = (u / oq) * 4, o0 = (u % oq) * 4;
      float a[4][4] = {};
      for (int p = 0; p < kTileP; p += 4) {  // padded points carry dz = 0
        float4 hv[4], dv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          hv[r] = *reinterpret_cast<const float4*>(hs + (i0 + r) * kStride + p);
          dv[r] = *reinterpret_cast<const float4*>(dzs + (o0 + r) * kStride + p);
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int oj = 0; oj < 4; ++oj) {
            a[ii][oj] += hv[ii].x * dv[oj].x + hv[ii].y * dv[oj].y +
                         hv[ii].z * dv[oj].z + hv[ii].w * dv[oj].w;
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
        for (int oj = 0; oj < 4; ++oj) dws[(i0 + ii) * cout + o0 + oj] += a[ii][oj];
      }
    }
    // dh_prev[p, i] = sum_o dz[p, o] W[i, o]: 4 points x 4 channels each
    for (int u = threadIdx.x; u < (kTileP / 4) * iq; u += kBwdThreads) {
      const int i0 = (u % iq) * 4;
      const int pp = (u / iq) * 4;
      float a[4][4] = {};
      for (int o = 0; o < cout; ++o) {
        const float4 dv = *reinterpret_cast<const float4*>(dzs + o * kStride + pp);
        const float4 wv = __ldg(reinterpret_cast<const float4*>(
            wt + static_cast<size_t>(o) * cin_pad + i0));
        const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int pi = 0; pi < 4; ++pi) {
#pragma unroll
          for (int ij = 0; ij < 4; ++ij) a[pi][ij] += dr[pi] * wr[ij];
        }
      }
#pragma unroll
      for (int pi = 0; pi < 4; ++pi) {
        if (pp + pi < np) {
          *reinterpret_cast<float4*>(dh_prev + (p0 + pp + pi) * cin_pad + i0) =
              make_float4(a[pi][0], a[pi][1], a[pi][2], a[pi][3]);
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < cin_pad * cout; e += kBwdThreads) {
    dw_part[static_cast<size_t>(blockIdx.x) * cin_pad * cout + e] = dws[e];
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

BN make_bn(const float* const* v) { return BN{v[0], v[1], v[2], v[3]}; }

}  // namespace

extern "C" size_t snt_pme_dense_smem(int cin, int cout) {
  return static_cast<size_t>(cin + cout) * kStride * sizeof(float) +
         2 * static_cast<size_t>(cout) * sizeof(double);
}

extern "C" size_t snt_pme_bwd_smem(int cin_pad, int cout) {
  return static_cast<size_t>(cin_pad + cout) * kStride * sizeof(float) +
         static_cast<size_t>(cin_pad) * cout * sizeof(double);
}

// prev_bn holds (mu, rstd, gamma, beta) of the layer below, or is null for
// the first layer (then `in` is x itself).
extern "C" int snt_pme_dense(const float* in, int cin, const float* const* prev_bn,
                             const float* w, int cout, float* z, double* rows,
                             long long n_points, int grid, cudaStream_t stream) {
  if (cout % 4 || cin < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = snt_pme_dense_smem(cin, cout);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(pme_dense_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BN prev = prev_bn ? make_bn(prev_bn) : BN{nullptr, nullptr, nullptr, nullptr};
  pme_dense_kernel<<<grid, kThreads, smem, stream>>>(
      in, cin, prev, prev_bn != nullptr, w, cout, z, rows, n_points);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int snt_pme_pool(const float* z, const float* const* bn, int b, int n,
                            int c_out, float* pooled, int* argmax,
                            cudaStream_t stream) {
  pme_pool_kernel<<<b, kThreads, 0, stream>>>(z, make_bn(bn), n, c_out, pooled,
                                              argmax);
  return static_cast<int>(cudaGetLastError());
}

// dh null: the top layer, dh from the pooled cotangent g at argmax.
extern "C" int snt_pme_rows(const float* z, const float* const* bn, int c_out,
                            const float* dh, const float* g, const int* argmax,
                            int b, int n, double* rows, int grid,
                            cudaStream_t stream) {
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = c_out < kThreads ? (c_out + 31) / 32 * 32 : kThreads;
  pme_rows_kernel<<<grid, threads, 0, stream>>>(
      z, make_bn(bn), c_out, dh, g, argmax, n, static_cast<long long>(b) * n, b,
      rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int snt_pme_bwd(const float* in, int cin, int cin_pad,
                           const float* const* prev_bn, const float* z,
                           const float* const* bn, int cout, const float* dh,
                           const float* g, const int* argmax, int b, int n,
                           const float* r1, const float* r2, const float* wt,
                           double* dw_part, float* dh_prev, int grid,
                           cudaStream_t stream) {
  if (cout % 4 || cin_pad % 4 || cin > cin_pad || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = snt_pme_bwd_smem(cin_pad, cout);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(pme_bwd_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BN prev = prev_bn ? make_bn(prev_bn) : BN{nullptr, nullptr, nullptr, nullptr};
  pme_bwd_kernel<<<grid, kBwdThreads, smem, stream>>>(
      in, cin, cin_pad, prev, prev_bn != nullptr, z, make_bn(bn), cout, dh, g,
      argmax, n, r1, r2, wt, dw_part, dh_prev, static_cast<long long>(b) * n);
  return static_cast<int>(cudaGetLastError());
}
