// Segment sums of a value table (kernels K6 and K7 of the port).
//
// K6 replaces the TPU kernel `_segsum_table_t_kernel` of
// tpusfm/ops/obs_table.py (wrapper `segsum_table_t`, obs_table.py:1694):
// out (n, k) = the sum of the table's rows by an unsorted id (camera or
// intrinsic group), ids outside [0, n) dropped.  K7 replaces
// `_segsum_sorted_t_kernel` (wrapper `segsum_sorted_t`, :1749): out (p, k)
// = the sum of the columns of a (k, O) table, lane-major or the view of a
// row-major (O, k) table (the reference's sublane `segsum_sorted`), by a
// non-decreasing rank, rows with rank >= p dropped.  The BA kernel path's unfused
// linearization (camera models other than RADIAL3, or more than 2048
// cameras or groups) reduces its per-observation Jacobian products through
// them: k = 36 + 6 (+ 6E) per camera, E*E + E per group, 12 per point rank;
// and the Schur-diagonal preconditioner its 36 per-camera values through K6.
//
// What bounds them: one add per value read, so memory: the k values of
// every row read once.  K7 reads each value once in order.  K6 reaches a
// segment's rows through a permutation (seg_perm), so it sums rows and not
// lanes: it reads the table row-major (O, k), where a permuted row's k
// values are contiguous (384 bytes at k = 96) and one warp reads them whole
// in coalesced 128-byte pieces.  The producers hold that layout already
// (the wrapper takes the (k, O) view of an (O, k) table without a copy).
// A lane-major (k, O) table, as K2's unreduced mode writes it, first goes
// through K6's own tile transpose (32 x 32 tiles through shared memory,
// coalesced on both sides) into a row-major scratch, which costs one more
// read and write of the table.  The TPU kernels' one-hot MXU contractions
// and rank windows do not carry over; ranks need not be dense.
//
// K6 is a two-level sum over fixed chunks of 2,048 rows of each segment
// (ba_common.cuh), one block to a chunk.  A table of many chunks is bound
// by memory: 256-thread blocks whose warps keep 4 rows' loads in flight
// need 40 registers a thread, so six blocks (48 warps) share an SM and one
// block's final reduction overlaps the others' reads; 8 rows in flight cost
// 64 registers and two of those six blocks, and measured slower.  A table
// of few chunks, or one segment that holds most of a small table (the
// engine's padding rows sit on one camera), is bound by the latency of each
// warp's row walk: there a chunk gets a 1024-thread block whose 32 warps
// walk 64 rows each, 8 at a time, instead of 8 warps walking 256 rows.
//
// Determinism: no atomics.  K7 gives each (rank, value) one thread that
// adds the rank's rows [rank_start[r], rank_start[r+1]) in order.  In K6's
// block for a chunk of W warps, warp w takes the 32-row groups w, w + W,
// ... in order and its lane l sums columns l, l + 32, l + 64, l + 96 of
// each row; the warps' partial rows are then added in warp order through
// shared memory, and each segment's chunks in chunk order.  The block size
// follows from the chunk count and the card's SM count alone, so two calls
// on the same inputs give the same bits, and so do the two layouts of one
// table.

#include "ba_common.cuh"

namespace {

using namespace tpusfm_ba;

constexpr int kColsPerLane = 4;                  // columns one lane sums per sweep
constexpr int kColsPerPass = 32 * kColsPerLane;  // columns one block sums per sweep
constexpr unsigned kFull = 0xffffffffu;
// Below this many chunks per SM, K6's row pass gives each chunk a block of
// 1024 threads; from it on, a block of 256 (see the note above).
constexpr int kFewChunksPerSm = 4;

// K6 pass 1: one block of kBlock threads per chunk writes the chunk's sums
// of all k values of the row-major table vals (O, k); each warp issues the
// loads of kRowsInFlight rows together.
template <int kBlock, int kRowsInFlight>
__global__ void __launch_bounds__(kBlock)
segsum_rows_chunk_kernel(const float* __restrict__ vals, int k,
                         const int* __restrict__ seg_perm, const int* __restrict__ seg_start,
                         const int* __restrict__ chunk_start, int n, int chunk_rows,
                         float* __restrict__ part) {
  constexpr int kRowWarps = kBlock / 32;
  __shared__ float warp_rows[kRowWarps][kColsPerPass];
  ChunkRows ch;
  if (!chunk_rows_of(seg_start, chunk_start, n, chunk_rows, blockIdx.x, ch)) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < k; c0 += kColsPerPass) {
    float acc[kColsPerLane];
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) acc[t] = 0.f;
    for (int g0 = ch.begin + warp * 32; g0 < ch.end; g0 += kRowWarps * 32) {
      // Lane l fetches the group's l-th row index; the warp walks the rows
      // in order, each row's index broadcast from its lane.
      const int my_row = g0 + lane < ch.end ? seg_perm[g0 + lane] : 0;
      const int cnt = min(32, ch.end - g0);
      for (int j = 0; j < cnt; j += kRowsInFlight) {
        float v[kRowsInFlight][kColsPerLane];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          const int o = __shfl_sync(kFull, my_row, (j + u) & 31);
          const float* row = vals + (size_t)o * k;
#pragma unroll
          for (int t = 0; t < kColsPerLane; ++t) {
            const int c = c0 + lane + 32 * t;
            v[u][t] = (j + u < cnt && c < k) ? __ldg(row + c) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u)
#pragma unroll
          for (int t = 0; t < kColsPerLane; ++t) acc[t] += v[u][t];
      }
    }
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) warp_rows[warp][lane + 32 * t] = acc[t];
    __syncthreads();
    if (threadIdx.x < kColsPerPass && c0 + (int)threadIdx.x < k) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w) s += warp_rows[w][threadIdx.x];
      part[(size_t)blockIdx.x * k + c0 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

// K6's layout pass: out (O, k) = the transpose of the lane-major in (k, O),
// one 32 x 32 tile per block of 32 x 8 threads, read along O and written
// along k.
__global__ void __launch_bounds__(kThreads)
transpose_tile_kernel(const float* __restrict__ in, int k, int O, float* __restrict__ out) {
  __shared__ float tile[32][33];
  const int o0 = blockIdx.x * 32, v0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += kThreads / 32) {
    const int v = v0 + j, o = o0 + threadIdx.x;
    if (v < k && o < O) tile[j][threadIdx.x] = in[(size_t)v * O + o];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += kThreads / 32) {
    const int o = o0 + j, v = v0 + threadIdx.x;
    if (v < k && o < O) out[(size_t)o * k + v] = tile[threadIdx.x][j];
  }
}

// K7: one thread per (value, rank).  Lane-major (k, O): neighbouring
// threads take neighbouring ranks of one value, whose rows are neighbours in
// the sorted table.  Row-major (O, k): neighbouring threads take neighbouring
// values of one rank, neighbours in each of its rows.  Each sum runs over the
// rank's rows in order, so the two layouts give the same bits.
template <bool kRowMajor>
__global__ void __launch_bounds__(kThreads)
segsum_sorted_kernel(const float* __restrict__ vals, int k, int O,
                     const int* __restrict__ rank_start, int P, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)P * k) return;
  const int v = kRowMajor ? (int)(i % k) : (int)(i / P);
  const int r = kRowMajor ? (int)(i / k) : (int)(i - (long long)v * P);
  const float* col = kRowMajor ? vals + v : vals + (size_t)v * O;
  const size_t step = kRowMajor ? (size_t)k : 1;
  float acc = 0.f;
  const int end = rank_start[r + 1];
  for (int o = rank_start[r]; o < end; ++o) acc += col[(size_t)o * step];
  out[(size_t)r * k + v] = acc;
}

}  // namespace

// K6.  vals f32: row-major (O, k) when lane_major = 0, lane-major (k, O)
// when 1, which is first transposed into scratch (O, k); seg_perm (O),
// seg_start and chunk_start (n + 1) from ObsLayout over the id column, at
// most n_chunks chunks of chunk_rows rows; part (n_chunks, k) scratch.
// Writes out (n, k) on device `device` and returns the CUDA error code of
// the launches (0 = success).
extern "C" int tpusfm_ba_segsum_table(int device, const float* vals, int lane_major, int k, int O,
                                      const int* seg_perm, const int* seg_start,
                                      const int* chunk_start, int n, int n_chunks, int chunk_rows,
                                      float* scratch, float* part, float* out,
                                      cudaStream_t stream) {
  if (k <= 0 || O <= 0 || n <= 0 || n_chunks <= 0 || chunk_rows <= 0 ||
      (lane_major && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaError_t err;
  if (lane_major) {
    const dim3 grid((O + 31) / 32, (k + 31) / 32);
    transpose_tile_kernel<<<grid, dim3(32, kThreads / 32), 0, stream>>>(vals, k, O, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    vals = scratch;
  }
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (n_chunks < kFewChunksPerSm * n_sm)
    segsum_rows_chunk_kernel<1024, 8><<<n_chunks, 1024, 0, stream>>>(
        vals, k, seg_perm, seg_start, chunk_start, n, chunk_rows, part);
  else
    segsum_rows_chunk_kernel<kThreads, 4><<<n_chunks, kThreads, 0, stream>>>(
        vals, k, seg_perm, seg_start, chunk_start, n, chunk_rows, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_chunk_finish(part, chunk_start, n, k, out, stream);
}

// K7.  vals f32: lane-major (k, O) when row_major = 0, row-major (O, k)
// when 1, both read in place; rank_start (P + 1) from ObsLayout over the
// sorted ranks.  Writes out (P, k) on device `device` and returns the CUDA
// error code of the launch.
extern "C" int tpusfm_ba_segsum_sorted(int device, const float* vals, int row_major, int k, int O,
                                       const int* rank_start, int P, float* out,
                                       cudaStream_t stream) {
  if (k <= 0 || O <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const long long total = (long long)P * k;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (row_major)
    segsum_sorted_kernel<true><<<blocks, kThreads, 0, stream>>>(vals, k, O, rank_start, P, out);
  else
    segsum_sorted_kernel<false><<<blocks, kThreads, 0, stream>>>(vals, k, O, rank_start, P, out);
  return (int)cudaGetLastError();
}
