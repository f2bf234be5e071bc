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
// an indexed load, so one kernel serves both: one thread per output
// element, consecutive threads on consecutive elements of the (O, D)
// output, so its stores coalesce; the ids are read once per element
// through the read-only cache and the table rows are read with __ldg (a
// 4096 x 9 table is 147 KB, resident in L2).  With K9's sorted ranks,
// neighbouring threads read neighbouring table rows.  Values are copied,
// not recomputed, so the output equals the plain twin bit for bit, and
// ranks need not be dense.
//
// What bounds it: bytes.  Each output element is 4 bytes written plus its
// share of the 4-byte id and of the table row, no arithmetic.

#include "ba_common.cuh"

namespace {

using namespace tpusfm_ba;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table, int n, int d, const int* __restrict__ idx,
                   long long total, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long o = i / d;
  const int c = (int)(i - o * d);
  const int id = __ldg(idx + o);
  out[i] = (id >= 0 && id < n) ? __ldg(table + (size_t)id * d + c) : 0.f;
}

}  // namespace

// table (n, d) float32, idx (O) int32, out (O, d) float32, all contiguous
// on one device.  Launches on `stream` and returns the CUDA error code of
// the launch (0 = success).
extern "C" int tpusfm_ba_gather(const float* table, int n, int d, const int* idx, int O,
                                float* out, cudaStream_t stream) {
  if (n < 0 || d <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)O * d;
  const long long blocks = (total + kThreads - 1) / kThreads;
  gather_rows_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(table, n, d, idx, total, out);
  return (int)cudaGetLastError();
}
