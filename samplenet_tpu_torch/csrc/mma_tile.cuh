// The per-point MLP's dense layer over one 64-point tile of activations in
// shared memory, times a weight matrix W [cin, cout] read through the
// read-only cache: on the H100's tensor cores (tile_product: the eval
// chain's layers of 8 or more input channels, point_mlp_max.cu, with f32
// operands; tile_product_bf16 with bf16 operands, also the train chains'
// forward in bf16, pmt_dense in point_mlp_train.cu) or on the FP32 pipes
// (simt_product: every layer of the train chains' forward in f32, and a
// first layer of fewer than 8 channels, or 16 in bf16).
//
// tile_product: the block's 8 warps split an output chunk of 64 points x
// 32*kNT channels 2 x 4: warp w owns points 32*(w & 1) .. +31 (two 16-row
// MMA tiles) and 8*kNT channels from 8*kNT*(w >> 1), so each B fragment it
// loads serves both of its row tiles and each A fragment its kNT column
// tiles. The f32 operands run on mma.sync m16n8k8 tf32 as 3xTF32: each
// operand v is rounded as cvt.rna does into hi = tf32(v) and lo =
// tf32(v - hi), and each K step of 8 sums a_lo*b_hi, a_hi*b_lo, then
// a_hi*b_hi (the small terms first) from zero on the tensor cores and adds
// that into the f32 accumulator with one round-to-nearest add. A product
// is then good to about 2^-22 of itself, where one TF32 product loses 11
// bits of each operand (the eval chain is held within 1e-4 of the plain
// f32 path). The tensor cores' own sums truncate: a running sum kept in
// them drifts toward zero by an ulp of the sum per step, which the card
// showed as outputs further from float64 than the plain f32 matmul's;
// summed from zero, each step's truncation is bounded by an ulp of that
// step's own products.
//
// simt_product: 4 points x 4 channels a thread, one FMA a product, in
// channel order: the sums the plain path's f32 matmul takes. The train
// chains need that order. Their gradients are held to twice the plain f32
// path's error against float64, and BN's ReLU masks decide that check:
// a pre-activation within f32 noise of zero falls on the side of zero its
// summation order puts it, and with the tensor cores' order some fell on
// the other side than the plain path's and float64's (one card test
// failed on 3 of 4.2M points). The train chains' bf16 modes are held
// norm-wise to the plain bf16 version instead, so they run on
// tile_product_bf16.
//
// tile_product_bf16: the same warp layout on mma.sync m16n8k16 bf16. A row
// of the tile holds two channels: word (pair row k, point p) carries
// bf16(h[2k][p]) in its low half and bf16(h[2k+1][p]) in its high half, and
// W comes packed the same way, [ceil(cin/2)][cout] words (row 2k of
// bf16(W) low). The products of bf16 operands are exact; each K step of 16
// channels is summed from zero on the tensor cores and added into the f32
// accumulator with one round-to-nearest add, as in tile_product.
//
// The activation tile is a [rows][64] array of 32-bit words, one row per
// input channel (per pair of channels in bf16), each row's 64 points
// XOR-swizzled by 8 * (row & 3): the A fragments' loads (rows k + t,
// points g for lane 4g + t) then hit 32 distinct banks, and groups of 4
// consecutive points stay contiguous and 16-byte aligned for
// simt_product's float4 reads. Rows past cin up to the K step hold zeros.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace mma {

constexpr int kTileP = 64;    // points per tile
constexpr int kThreads = 256;

// word (row k, point p) of an activation tile
__host__ __device__ __forceinline__ int aidx(int k, int p) {
  return k * kTileP + (p ^ ((k & 3) << 3));
}

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, 10
// mantissa bits kept) on the integer pipes: the magnitude rounds alone in
// the sign-magnitude bits; Inf and a quiet NaN stay so. On the H100 the
// tile ran faster so than with the cvt instruction.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo to 2^-23 of v, both TF32
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Where this thread's accumulators sit in the block's output chunk
// starting at channel n0: element e of fragment (mi, ni) is point
// m0 + 16 mi + g + 8 (e >> 1), channel n + 8 ni + (e & 1).
struct Frag {
  int g, t, m0, n;
  __device__ __forceinline__ Frag(int n0, int nt) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
    m0 = 32 * (w & 1);
    n = n0 + 8 * nt * (w >> 1) + 2 * t;
  }
};

// acc[mi][ni] += A W over k in [0, cin) for this thread's fragments of the
// chunk at n0; W [cin, cout] row-major in device memory, entries past cin
// or cout read as 0. Each K step's operands are loaded one step ahead,
// before the current step's products, so the loads' latency runs under
// them.
template <int kNT>
__device__ __forceinline__ void tile_product(float (&acc)[2][kNT][4],
                                             const uint32_t* __restrict__ as,
                                             const float* __restrict__ w,
                                             int cin, int cout, int n0) {
  const Frag f(n0, kNT);
  const int col0 = f.n - 2 * f.t + f.g;  // this lane's B column, ni = 0
  // raw operands of one K step: A rows k0 + t and k0 + t + 4, B the same
  float an[2][4], bn[kNT][2];
  auto load = [&](int k0) {
    const int ka = k0 + f.t, kb = ka + 4;
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int c = col0 + 8 * ni;
      const bool in = c < cout;
      bn[ni][0] = in && ka < cin ? __ldg(w + static_cast<size_t>(ka) * cout + c) : 0.0f;
      bn[ni][1] = in && kb < cin ? __ldg(w + static_cast<size_t>(kb) * cout + c) : 0.0f;
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int p = f.m0 + 16 * mi + f.g;
      an[mi][0] = __uint_as_float(as[aidx(ka, p)]);
      an[mi][1] = __uint_as_float(as[aidx(ka, p + 8)]);
      an[mi][2] = __uint_as_float(as[aidx(kb, p)]);
      an[mi][3] = __uint_as_float(as[aidx(kb, p + 8)]);
    }
  };
  load(0);
  for (int k0 = 0; k0 < cin; k0 += 8) {
    uint32_t ah[2][4], al[2][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int j = 0; j < 4; ++j) split(an[mi][j], ah[mi][j], al[mi][j]);
    }
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      split(bn[ni][0], bh[ni][0], bl[ni][0]);
      split(bn[ni][1], bh[ni][1], bl[ni][1]);
    }
    if (k0 + 8 < cin) load(k0 + 8);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {  // the step's sum, then one f32 add
      float step[kNT][4] = {};
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) mma_tf32(step[ni], al[mi], bh[ni]);
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) mma_tf32(step[ni], ah[mi], bl[ni]);
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) mma_tf32(step[ni], ah[mi], bh[ni]);
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += step[ni][e];
      }
    }
  }
}

// a[pi][oj] += A[i][pp + pi] * W[i][o0 + oj] for i = 0, 1, .., cin - 1 in
// that order, one FMA each on the FP32 pipes (pp a multiple of 4, o0 + 3 <
// cout, cout a multiple of 4): one float4 of the tile and one of W feed 16
// FMAs.
__device__ __forceinline__ void simt_product(float (&a)[4][4],
                                             const uint32_t* as,
                                             const float* __restrict__ w,
                                             int cin, int cout, int pp,
                                             int o0) {
  const float* hs = reinterpret_cast<const float*>(as);
#pragma unroll 4
  for (int i = 0; i < cin; ++i) {
    const float4 hv = *reinterpret_cast<const float4*>(hs + aidx(i, pp));
    const float4 wv = __ldg(reinterpret_cast<const float4*>(
        w + static_cast<size_t>(i) * cout + o0));
    const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int pi = 0; pi < 4; ++pi) {
#pragma unroll
      for (int oj = 0; oj < 4; ++oj) a[pi][oj] = __fmaf_rn(hr[pi], wr[oj], a[pi][oj]);
    }
  }
}

// bf16 operands: channels a K step, and the f32 value of bf16 rounding
constexpr int kBf16K = 16;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16(lo) in the low half, bf16(hi) in the high half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mi][ni] += A W over the kp pair rows of a bf16 tile, for this thread's
// fragments of the chunk at n0; wp [kp][cout] packed pairs in device memory,
// entries past kp or cout read as 0. As tile_product: each K step's
// operands are loaded one step ahead, and each step is summed from zero.
template <int kNT>
__device__ __forceinline__ void tile_product_bf16(float (&acc)[2][kNT][4],
                                                  const uint32_t* __restrict__ as,
                                                  const uint32_t* __restrict__ wp,
                                                  int kp, int cout, int n0) {
  const Frag f(n0, kNT);
  const int col0 = f.n - 2 * f.t + f.g;  // this lane's B column, ni = 0
  uint32_t an[2][4], bn[kNT][2];
  auto load = [&](int k0) {  // pair rows k0 + t and k0 + t + 4
    const int ka = k0 + f.t, kb = ka + 4;
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int c = col0 + 8 * ni;
      const bool in = c < cout;
      bn[ni][0] = in && ka < kp ? __ldg(wp + static_cast<size_t>(ka) * cout + c) : 0u;
      bn[ni][1] = in && kb < kp ? __ldg(wp + static_cast<size_t>(kb) * cout + c) : 0u;
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int p = f.m0 + 16 * mi + f.g;
      an[mi][0] = as[aidx(ka, p)];
      an[mi][1] = as[aidx(ka, p + 8)];
      an[mi][2] = as[aidx(kb, p)];
      an[mi][3] = as[aidx(kb, p + 8)];
    }
  };
  load(0);
  for (int k0 = 0; k0 < kp; k0 += kBf16K / 2) {
    uint32_t a[2][4], b[kNT][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int j = 0; j < 4; ++j) a[mi][j] = an[mi][j];
    }
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      b[ni][0] = bn[ni][0];
      b[ni][1] = bn[ni][1];
    }
    if (k0 + kBf16K / 2 < kp) load(k0 + kBf16K / 2);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {  // the step's sum, then one f32 add
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        float step[4] = {};
        mma_bf16(step, a[mi], b[ni]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += step[e];
      }
    }
  }
}

// Rows of a bf16 tile of c channels: pairs of channels, to the K step of 16
__host__ __device__ __forceinline__ int pair_rows(int c) {
  return (c + kBf16K - 1) / kBf16K * (kBf16K / 2);
}

// Rows of the activation tile for cin input channels: cin rounded up to
// the tensor cores' K step of 8, or to 4 for simt_product.
__host__ __device__ __forceinline__ int tile_rows(int cin, bool mma_path) {
  return mma_path ? (cin + 7) / 8 * 8 : (cin + 3) / 4 * 4;
}

// Channels of one output chunk: 32 * kNT, kNT chosen from cout
__host__ __device__ __forceinline__ int chunk_nt(int cout) {
  return cout >= 128 ? 4 : cout >= 64 ? 2 : 1;
}

}  // namespace mma
