// Segment sums of a transposed value table (kernels K6 and K7 of the port).
//
// K6 replaces the TPU kernel `_segsum_table_t_kernel` of
// tpusfm/ops/obs_table.py (wrapper `segsum_table_t`, obs_table.py:1694):
// out (n, k) = the sum of the columns of valsT (k, O) by an unsorted id
// (camera or intrinsic group), ids outside [0, n) dropped.  K7 replaces
// `_segsum_sorted_t_kernel` (wrapper `segsum_sorted_t`, :1749): out (p, k)
// = the sum of the columns by a non-decreasing rank, rows with rank >= p
// dropped.  The BA kernel path's unfused linearization (camera models other
// than RADIAL3, or more than 2048 cameras or groups) reduces its
// per-observation Jacobian products through them: k = 36 + 6 (+ 6E) per
// camera, E*E + E per group, 12 per point rank; and the Schur-diagonal
// preconditioner its 36 per-camera values through K6.
//
// What bounds them: one add per value read, so memory.  K7 reads each
// value once in order.  K6 reaches a segment's rows through a permutation,
// so every value costs a 32-byte sector: up to 8x the bytes of the values.
// The TPU kernels' one-hot MXU contractions and rank windows do not carry
// over; ranks need not be dense.
//
// Determinism: no atomics.  K7 gives each (rank, value) one thread that
// adds the rank's rows [rank_start[r], rank_start[r+1]) in order.  K6 is a
// two-level sum over fixed chunks of each segment's rows (ba_common.cuh):
// a block sums a chunk 16 values at a time with a fixed shuffle tree, then
// each segment's chunks are added in order.  Two calls on the same inputs
// give the same bits.

#include "ba_common.cuh"

namespace {

using namespace tpusfm_ba;

constexpr int kValsPerPass = 16;  // values one block sums per sweep of its chunk

// K6 pass 1: one block per chunk writes the chunk's sums of all k values.
__global__ void __launch_bounds__(kThreads)
segsum_table_chunk_kernel(const float* __restrict__ valsT, int k, int O,
                          const int* __restrict__ seg_perm, const int* __restrict__ seg_start,
                          const int* __restrict__ chunk_start, int n, int chunk_rows,
                          float* __restrict__ part) {
  __shared__ float sums[kValsPerPass];
  ChunkRows ch;
  if (!chunk_rows_of(seg_start, chunk_start, n, chunk_rows, blockIdx.x, ch)) return;
  for (int v0 = 0; v0 < k; v0 += kValsPerPass) {
    float acc[kValsPerPass];
#pragma unroll
    for (int j = 0; j < kValsPerPass; ++j) acc[j] = 0.f;
    for (int i = ch.begin + threadIdx.x; i < ch.end; i += kThreads) {
      const float* col = valsT + seg_perm[i];
#pragma unroll
      for (int j = 0; j < kValsPerPass; ++j)
        if (v0 + j < k) acc[j] += col[(size_t)(v0 + j) * O];
    }
    block_sum<kValsPerPass>(acc, sums);
    if (threadIdx.x < kValsPerPass && v0 + (int)threadIdx.x < k)
      part[(size_t)blockIdx.x * k + v0 + threadIdx.x] = sums[threadIdx.x];
  }
}

// K7: one thread per (value, rank); neighbouring threads take neighbouring
// ranks of one value, whose rows are neighbours in the sorted table.
__global__ void __launch_bounds__(kThreads)
segsum_sorted_kernel(const float* __restrict__ valsT, int k, int O,
                     const int* __restrict__ rank_start, int P, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)P * k) return;
  const int v = (int)(i / P);
  const int r = (int)(i - (long long)v * P);
  const float* row = valsT + (size_t)v * O;
  float acc = 0.f;
  const int end = rank_start[r + 1];
  for (int o = rank_start[r]; o < end; ++o) acc += row[o];
  out[(size_t)r * k + v] = acc;
}

}  // namespace

// K6.  valsT (k, O) f32; seg_perm (O), seg_start and chunk_start (n + 1)
// from ObsLayout over the id column, at most n_chunks chunks of chunk_rows
// rows; part (n_chunks, k) scratch.  Writes out (n, k) and returns the CUDA
// error code of the launches (0 = success).
extern "C" int tpusfm_ba_segsum_table(const float* valsT, int k, int O, const int* seg_perm,
                                      const int* seg_start, const int* chunk_start, int n,
                                      int n_chunks, int chunk_rows, float* part, float* out,
                                      cudaStream_t stream) {
  if (k <= 0 || O <= 0 || n <= 0 || n_chunks <= 0 || chunk_rows <= 0)
    return (int)cudaErrorInvalidValue;
  segsum_table_chunk_kernel<<<n_chunks, kThreads, 0, stream>>>(valsT, k, O, seg_perm, seg_start,
                                                               chunk_start, n, chunk_rows, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_chunk_finish(part, chunk_start, n, k, out, stream);
}

// K7.  valsT (k, O) f32; rank_start (P + 1) from ObsLayout over the sorted
// ranks.  Writes out (P, k) and returns the CUDA error code of the launch.
extern "C" int tpusfm_ba_segsum_sorted(const float* valsT, int k, int O, const int* rank_start,
                                       int P, float* out, cudaStream_t stream) {
  if (k <= 0 || O <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)P * k;
  segsum_sorted_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      valsT, k, O, rank_start, P, out);
  return (int)cudaGetLastError();
}
