// Staging a cloud's points in shared memory as float4 (x, y, z, -) with
// cp.async, so that the next chunk loads while a block scans the current
// one (nn_direction.cu, soft_projection.cu's pruned wide forward).

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copies points [c0, c0 + cn) of the cloud at yb into buf as float4, one
// point a thread at a time, and commits the copies as one group.
__device__ __forceinline__ void stage(float4* buf, const float* yb, int c0,
                                      int cn) {
  for (int p = threadIdx.x; p < cn; p += blockDim.x) {
    const float* s = yb + static_cast<size_t>(c0 + p) * 3;
    cp_async4(&buf[p].x, s);
    cp_async4(&buf[p].y, s + 1);
    cp_async4(&buf[p].z, s + 2);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}
