// Helpers shared by the bundle-adjustment kernels (ba_linearize.cu,
// ba_schur.cu, ba_segsum.cu).
//
// Two-level segment sums.  A segment (a camera, a group) may hold every row
// of the table: one intrinsic group holds 1.5M rows at the 500-camera bench
// shape, too much for the one block per segment that gives a fixed
// summation order.  So a segment's rows (seg_perm[seg_start[s] ..
// seg_start[s+1]), in increasing row order) are cut into chunks of
// chunk_rows rows, numbered chunk_start[s] .. chunk_start[s+1] over all
// segments (ObsLayout in ops/obs_table.py).  Each chunk gets one block,
// which sums its rows with a fixed shuffle tree into a partial row.  The
// partials of a segment are then added in chunk order, in one of two ways:
//
// - chunk_finish_kernel, a second launch with one thread per output value
//   that adds the segment's partials serially (K3's camera pass and K6);
// - finish_chunk, inside the chunk kernel itself (K2's camera and group
//   passes, K4): a segment of one chunk writes its sum directly; otherwise
//   each chunk block writes its partial, runs __threadfence() and adds one
//   to the segment's int32 arrival counter, and the block that arrives
//   last adds the segment's partials (thread t takes chunks t, t + 256, ...
//   in order, then the block_sum tree adds the threads) and sets the
//   counter back to 0.
//
// Determinism: no float atomics.  The integer atomic only decides which
// block finishes; the float order is fixed by the chunk index, so two calls
// on the same inputs give the same bits.  The arrival counters belong to
// the layout (ObsLayout.arrivals, zeroed when it is built) and every call
// leaves them at 0, so two calls on one layout must not run on two streams
// at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpusfm_ba {

constexpr int kThreads = 256;  // every BA kernel runs 256-thread blocks
constexpr int kWarps = kThreads / 32;

// Makes `device` the calling thread's current device for the life of the
// scope and restores the previous one after it.  Every launcher takes it in
// place of a Python device guard around the call: most calls find `device`
// current already, which costs one cudaGetDevice.
struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
};

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

// The rows [begin, end) of seg_perm that chunk b covers and its segment;
// false when b is past the last chunk (grids are sized by a bound).
struct ChunkRows {
  int seg, begin, end;
};

__device__ __forceinline__ bool chunk_rows_of(const int* __restrict__ seg_start,
                                              const int* __restrict__ chunk_start, int n,
                                              int chunk_rows, int b, ChunkRows& c) {
  if (b >= chunk_start[n]) return false;
  // The largest s with chunk_start[s] <= b; empty segments share their
  // successor's start, so s is the segment that owns chunk b.
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (chunk_start[mid] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  c.seg = lo;
  c.begin = seg_start[lo] + (b - chunk_start[lo]) * chunk_rows;
  c.end = min(c.begin + chunk_rows, seg_start[lo + 1]);
  return true;
}

// The second launch of a two-level segment sum: out[s][v] = sum over the
// chunks of segment s, in order, of part[chunk][v] (k values per row); 0 for
// an empty segment.  One thread per output value.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_finish_kernel(const T* __restrict__ part, const int* __restrict__ chunk_start, int n, int k,
                    T* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * k) return;
  const int s = i / k, v = i - s * k;
  T acc = 0;
  const int end = chunk_start[s + 1];
  for (int c = chunk_start[s]; c < end; ++c) acc += part[(size_t)c * k + v];
  out[i] = acc;
}

// Writes zeros to the output row of an empty segment: block b < n covers
// segment b (every grid of chunk blocks has at least n blocks), since no
// chunk block meets an empty segment.
template <int K>
__device__ __forceinline__ void zero_empty_segment(const int* __restrict__ chunk_start, int n,
                                                   float* __restrict__ out) {
  const int b = blockIdx.x;
  if (b < n && chunk_start[b + 1] == chunk_start[b] && threadIdx.x < K)
    out[(size_t)b * K + threadIdx.x] = 0.f;
}

// The one-launch finish of a two-level sum (see the note at the top), called
// by every thread of chunk block b of segment seg after block_sum<K> has
// left the chunk's sums in `sums` (shared, K floats, reused here).  Writes
// out[seg] once the segment's last chunk is in.
template <int K>
__device__ __forceinline__ void finish_chunk(float* sums, const int* __restrict__ chunk_start,
                                             int seg, int b, float* __restrict__ part,
                                             int* __restrict__ arrivals,
                                             float* __restrict__ out) {
  __shared__ bool last;
  const int c0 = chunk_start[seg], nc = chunk_start[seg + 1] - c0;
  if (nc == 1) {
    if (threadIdx.x < K) out[(size_t)seg * K + threadIdx.x] = sums[threadIdx.x];
    return;
  }
  if (threadIdx.x < K) part[(size_t)b * K + threadIdx.x] = sums[threadIdx.x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals + seg, 1) == nc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  for (int c = threadIdx.x; c < nc; c += kThreads) {
    const float* p = part + (size_t)(c0 + c) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += __ldcg(p + k);
  }
  block_sum<K>(acc, sums);
  if (threadIdx.x < K) out[(size_t)seg * K + threadIdx.x] = sums[threadIdx.x];
  if (threadIdx.x == 0) arrivals[seg] = 0;
}

inline int launch_chunk_finish(const float* part, const int* chunk_start, int n, int k,
                               float* out, cudaStream_t stream) {
  chunk_finish_kernel<float><<<(n * k + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, chunk_start, n, k, out);
  return (int)cudaGetLastError();
}

}  // namespace tpusfm_ba
