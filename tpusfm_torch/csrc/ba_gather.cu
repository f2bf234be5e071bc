// Row gathers of the bundle-adjustment observation table (kernels K8 and
// K9 of the port).
//
// K8 replaces the TPU kernel `_gather_table_kernel` of
// tpusfm/ops/obs_table.py (wrapper `gather_table`, obs_table.py:105; body
// :95): out (O, D) = table[idx] for a small table (at most 4096 rows: poses
// D = 6, intrinsics 7 or 9, damped Hpp^-1 rows 9) and ids in any order.
// K9 replaces `_gather_sorted_kernel` (wrapper `gather_sorted`, :191; body
// :173): the same for the rank-space point table (D = 3) and
// non-decreasing ranks.  Both give a zero row for every id outside
// [0, N): negative ids, ids past the table, invalid rows at rank 2^30.
//
// On the TPU both are one-hot matrix products on the MXU (an f32 value
// rebuilt from three bf16 terms), K9 inside a two-block window of ranks
// that zeroes any row whose rank jumps past it.  On this card a gather is
// an indexed load, so one kernel serves both.
//
// What bounds it: bytes.  Each output row is 4D bytes written plus its
// 4-byte id, no arithmetic; the tables (a 4096 x 9 K8 table is 147 KB, the
// 50,000 x 3 K9 point table 600 KB) stay in L2.  So the kernel must write
// the output at the memory's rate and spend few instructions per element.
// A warp owns a tile of 32 consecutive output rows: lane l loads the id of
// row l once (coalesced), and the warp writes its tile's 32D contiguous
// floats, lane l the elements l, l + 32, ... (or, for a full tile, the
// 16-byte vectors l, l + 32, ...: a tile is 128D bytes, so vectors line up
// whenever the output does).  Each element takes its row's id from the
// owning lane by a shuffle and its value from the table through the
// read-only cache (table rows are 4D bytes, so they are read 4 bytes at a
// time).  The element's row and column within the tile come from a 32-bit
// division by D, a compile-time constant (multiply and shift) for the BA
// path's widths 3, 6, 7 and 9; any other D takes the same kernel with a
// run-time D.  Offsets are 32-bit unless the output or the table holds
// 2^31 elements or more.  Values are copied, not recomputed, so the output
// equals the plain twin bit for bit, and ranks need not be dense.

#include "ba_common.cuh"

namespace {

using namespace tpusfm_ba;

constexpr unsigned kFull = 0xffffffffu;

// table[id][c] for the id held by lane `r` of the warp (every lane must
// call it); 0 where that id is outside the table (held as -1), and no load
// where the element is not `live` (past the tile, where c may exceed d).
template <typename I>
__device__ __forceinline__ float tile_value(const float* __restrict__ table, int d, int id,
                                            int r, int c, bool live) {
  const int src = __shfl_sync(kFull, id, r);
  return live && src >= 0 ? __ldg(table + (I)src * d + c) : 0.f;
}

// One warp per tile of 32 output rows; kD > 0 fixes D at compile time,
// kD = 0 reads it from d.  I is the offset type (int or long long).
template <int kD, typename I>
__global__ void __launch_bounds__(kThreads)
gather_tiles_kernel(const float* __restrict__ table, int n, int d_rt, const int* __restrict__ idx,
                    int O, bool vec, float* __restrict__ out) {
  const int d = kD > 0 ? kD : d_rt;
  const int lane = threadIdx.x & 31;
  const I row0 = ((I)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (row0 >= O) return;  // uniform across the warp
  const int rows = min(32, (int)(O - row0));
  int id = lane < rows ? __ldg(idx + row0 + lane) : -1;
  if (id >= n) id = -1;  // negative ids are already below 0
  float* dst = out + row0 * d;
  if (kD > 0 && vec && rows == 32) {
    // 8D float4 per tile; every lane runs every step so the shuffles see
    // the whole warp, and the vectors past the tile are neither loaded (their
    // column would run past row 31's) nor stored.
#pragma unroll
    for (int j0 = 0; j0 < 8 * kD; j0 += 32) {
      const int j = j0 + lane;
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = 4 * j + t;
        const int r = min(e / kD, 31);
        v[t] = tile_value<I>(table, kD, id, r, e - r * kD, j < 8 * kD);
      }
      if (j < 8 * kD) reinterpret_cast<float4*>(dst)[j] = make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
  const int count = rows * d;
  for (int e0 = 0; e0 < 32 * d; e0 += 32) {
    const int e = e0 + lane;
    const int r = e / d;  // < 32; rows past the tile hold id -1
    const float v = tile_value<I>(table, d, id, r, e - r * d, true);
    if (e < count) dst[e] = v;
  }
}

template <int kD, typename I>
void launch_tiles(const float* table, int n, int d, const int* idx, int O, bool vec, float* out,
                  cudaStream_t stream) {
  const long long tiles = ((long long)O + 31) / 32;
  gather_tiles_kernel<kD, I><<<(unsigned)((tiles + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      table, n, d, idx, O, vec, out);
}

template <typename I>
void launch_gather(const float* table, int n, int d, const int* idx, int O, float* out,
                   cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  switch (d) {
    case 3: return launch_tiles<3, I>(table, n, d, idx, O, vec, out, stream);
    case 6: return launch_tiles<6, I>(table, n, d, idx, O, vec, out, stream);
    case 7: return launch_tiles<7, I>(table, n, d, idx, O, vec, out, stream);
    case 9: return launch_tiles<9, I>(table, n, d, idx, O, vec, out, stream);
    default: return launch_tiles<0, I>(table, n, d, idx, O, vec, out, stream);
  }
}

}  // namespace

// table (n, d) float32, idx (O) int32, out (O, d) float32, all contiguous
// on device `device`.  Launches on `stream` and returns the CUDA error code
// of the launch (0 = success).
extern "C" int tpusfm_ba_gather(int device, const float* table, int n, int d, const int* idx,
                                int O, float* out, cudaStream_t stream) {
  if (n < 0 || d <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  // A grid's last block may reach 8 tiles (256 rows) past the output.
  constexpr long long kInt32 = 1LL << 31;
  if (((long long)O + 256) * d < kInt32 && (long long)n * d < kInt32)
    launch_gather<int>(table, n, d, idx, O, out, stream);
  else
    launch_gather<long long>(table, n, d, idx, O, out, stream);
  return (int)cudaGetLastError();
}
