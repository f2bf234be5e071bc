// Helpers shared by the bundle-adjustment kernels (ba_linearize.cu, ba_schur.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpusfm_ba {

constexpr int kThreads = 256;  // every BA kernel runs 256-thread blocks
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load_w(const float* w, size_t i) { return w[i]; }
__device__ __forceinline__ float load_w(const __nv_bfloat16* w, size_t i) {
  return __bfloat162float(w[i]);
}
__device__ __forceinline__ void store_w(float* w, size_t i, float v) { w[i] = v; }
__device__ __forceinline__ void store_w(__nv_bfloat16* w, size_t i, float v) {
  w[i] = __float2bfloat16_rn(v);
}

// Sums K per-thread values over the block in a fixed order (a shuffle tree
// inside each warp, then the warps in index order) and hands the K sums to
// threads 0..K-1 through `sums` (shared, K floats).  Every thread of the
// block must call it.
template <int K>
__device__ __forceinline__ void block_sum(const float (&acc)[K], float* sums) {
  __shared__ float part[kWarps][K];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    sums[threadIdx.x] = s;
  }
  __syncthreads();
}

}  // namespace tpusfm_ba
