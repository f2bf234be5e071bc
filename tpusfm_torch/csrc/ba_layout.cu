// The segment layout of an observation table (ObsLayout in
// ops/obs_table.py): the rows of each of n segments (cameras or intrinsic
// groups), as a stable permutation, built on the card with no host read.
//
// It replaces no TPU kernel.  The reference's kernels sum by one-hot
// products over windows of ids and need no sort (`_segsum_table_kernel`,
// tpusfm/ops/obs_table.py:128); the port's K2-K4 and K6 reach a segment's
// rows through `seg_perm` and cut them into chunks for a fixed summation
// order, so every kernel-path BA solve above 64 cameras builds this layout
// once, and so does each sublane `segsum_table` and `schur_bwd` call.  A
// stable `torch.sort` of the ids with a searchsorted, a cumsum and an
// equality test took ~22 launches and a device-to-host copy of the test's
// answer; this kernel takes three launches and leaves every answer on the
// card.
//
// It is a stable counting sort of the ids into n + 1 buckets: id c in
// [0, n) goes to bucket c, any other id to bucket n.  Outputs: seg_perm (O),
// the rows in bucket order, each bucket's rows in increasing row order (the
// unique permutation a stable sort gives, so bit-equal to it); seg_start
// (n + 1), the start of each bucket (seg_start[n] = the rows with an id in
// [0, n)); chunk_start (n + 1), the exclusive scan of each segment's
// ceil(rows / chunk_rows); arrivals (n), zeroed for finish_chunk
// (ba_common.cuh); in_order (1), 1 when the buckets are already in row
// order (seg_perm is the identity).
//
// The table is cut into tiles of R rows, one block a tile, W warps a block,
// each warp a contiguous sub-tile of R / W rows.
// - seg_count_kernel: each block counts its tile's rows into a shared
//   histogram of n + 1 ints (shared atomics: exact in any order) and writes
//   it bucket-major into counts[b][tile].
// - seg_tile_scan_kernel: a warp per bucket turns counts[b][.] into its
//   exclusive prefix over the tiles, in place, and writes the bucket's
//   total; it also sets in_order.
// - seg_scatter_kernel: each warp counts its sub-tile into shared offsets
//   of its own; one scan over the buckets gives seg_start (from the
//   totals; block 0 writes it, and chunk_start) and each bucket's start in
//   the tile (from the warps' counts), and so each warp's offset of each
//   bucket.  Each warp then walks its rows in order, 32 at a time:
//   __match_any_sync groups the lanes of one bucket, a lane's place is the
//   bucket's offset plus its lower peers, and the group's lowest lane
//   advances the offset.  So rows land in bucket order and, within a
//   bucket, in row order.  The walk also clears in_order where a row's
//   bucket exceeds the next row's.  Where the tile fits in shared memory
//   (every n up to a few thousand), the walk places each row in a shared
//   copy of the tile in bucket order, and the block then writes the tile
//   out position by position: a bucket's rows of one tile are one run of
//   seg_perm, so the stores are runs instead of one 4-byte store a row to
//   a scattered place.
//
// What bounds it: bytes.  The ids are read once to count and once to
// scatter, and seg_perm written once: at the 500-camera table (1,484,375
// rows) 18 MB, ~5.3 us.  The per-tile counts add (n + 1) ints a tile;
// R is chosen so that they number about as many as the rows (R >= n + 1),
// and W so that a block's W x (n + 1) shared offsets stay within 48 KB: a
// block holds 8 warps up to n = 1535, fewer above, and one warp with
// 128 KB of shared memory at n = 32,768, the largest n the wrapper sends
// here (no shared copy of the tile there).
//
// Determinism: the counts are integers, so their order does not matter,
// and each row's place follows from the row order alone.

#include "ba_common.cuh"

namespace {

using namespace tpusfm_ba;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanUnroll = 4;   // tile counts a lane loads at once in the tile scan
constexpr int kRowUnroll = 8;    // rows a lane loads at once

__device__ __forceinline__ int bucket_of(int id, int n) {
  return (unsigned)id < (unsigned)n ? id : n;
}

// Exclusive prefix sums of value(0), ..., value(m - 1) in index order,
// handed to out(i, prefix); returns the total.  Values and sums are int2,
// two scans at once.  Every thread of the block (a multiple of 32 threads,
// at most kThreads) must call it.
template <typename Value, typename Out>
__device__ __forceinline__ int2 block_scan(int m, Value value, Out out) {
  __shared__ int2 warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int2 carry = make_int2(0, 0);
  for (int base = 0; base < m; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int2 v = i < m ? value(i) : make_int2(0, 0);
    int2 x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int yx = __shfl_up_sync(kFull, x.x, off), yy = __shfl_up_sync(kFull, x.y, off);
      if (lane >= off) {
        x.x += yx;
        x.y += yy;
      }
    }
    if (lane == 31) warp_total[warp] = x;
    __syncthreads();
    int2 before = make_int2(0, 0), total = make_int2(0, 0);
    for (int w = 0; w < n_warps; ++w) {
      const int2 t = warp_total[w];
      if (w < warp) {
        before.x += t.x;
        before.y += t.y;
      }
      total.x += t.x;
      total.y += t.y;
    }
    if (i < m)
      out(i, make_int2(carry.x + before.x + x.x - v.x, carry.y + before.y + x.y - v.y));
    carry.x += total.x;
    carry.y += total.y;
    __syncthreads();  // warp_total is written again
  }
  return carry;
}

// Pass 1: block t counts the buckets of rows [t R, min((t + 1) R, O)) and
// writes counts[b * T + t] for every bucket b.
__global__ void __launch_bounds__(kThreads)
seg_count_kernel(const int* __restrict__ ids, int O, int n, int tile_rows, int T,
                 int* __restrict__ counts) {
  extern __shared__ int hist[];  // n + 1
  const int m = n + 1;
  for (int b = threadIdx.x; b < m; b += kThreads) hist[b] = 0;
  __syncthreads();
  const int begin = blockIdx.x * tile_rows, end = min(begin + tile_rows, O);
  for (int i0 = begin + threadIdx.x; i0 < end; i0 += kThreads * kRowUnroll) {
    int k[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int i = i0 + u * kThreads;
      k[u] = i < end ? bucket_of(__ldg(ids + i), n) : -1;
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u)
      if (k[u] >= 0) atomicAdd(hist + k[u], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < m; b += kThreads) counts[(size_t)b * T + blockIdx.x] = hist[b];
}

// Pass 2: warp b (of all blocks) turns counts[b][0..T) into its exclusive
// prefix over the tiles and writes totals[b]; sets *in_order = 1, which
// pass 3 clears where the rows are out of order.
__global__ void __launch_bounds__(kThreads)
seg_tile_scan_kernel(int* __restrict__ counts, int T, int n, int* __restrict__ totals,
                     int* __restrict__ in_order) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *in_order = 1;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b > n) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  int* row = counts + (size_t)b * T;
  int carry = 0;
  for (int t0 = 0; t0 < T; t0 += 32 * kScanUnroll) {
    int v[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int t = t0 + 32 * u + lane;
      v[u] = t < T ? row[t] : 0;
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      int x = v[u];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      const int t = t0 + 32 * u + lane;
      if (t < T) row[t] = carry + x - v[u];
      carry += __shfl_sync(kFull, x, 31);
    }
  }
  if (lane == 0) totals[b] = carry;
}

// Pass 3 (see the note at the top).  Block t < T places its tile; block 0
// (the only one when T = 0) also writes seg_start and chunk_start, and
// every block zeroes its share of the arrival counters.  Shared memory:
// the W warps' offsets (W x (n + 1) ints) and, with kStaged, each
// bucket's global start less its start in the tile (n + 1), then the
// tile's rows and buckets in bucket order (2 R).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
seg_scatter_kernel(const int* __restrict__ ids, int O, int n, int warp_rows, int T,
                   const int* __restrict__ counts, const int* __restrict__ totals, int chunk_rows,
                   int* __restrict__ seg_perm, int* __restrict__ seg_start,
                   int* __restrict__ chunk_start, int* __restrict__ arrivals,
                   int* __restrict__ in_order) {
  extern __shared__ int smem[];
  const int m = n + 1, t = blockIdx.x;
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile_rows = W * warp_rows;
  int* offs = smem;                 // W x m
  int* gbase = smem + W * m;        // m (kStaged)
  int* tile_row = gbase + m;        // tile_rows (kStaged)
  int* tile_key = tile_row + tile_rows;
  for (int b = t * blockDim.x + threadIdx.x; b < n; b += gridDim.x * blockDim.x) arrivals[b] = 0;
  if (t == 0) {
    const int2 chunks = block_scan(
        n, [&](int b) { return make_int2((__ldg(totals + b) + chunk_rows - 1) / chunk_rows, 0); },
        [&](int b, int2 p) { chunk_start[b] = p.x; });
    if (threadIdx.x == 0) chunk_start[n] = chunks.x;
  }
  const bool live = t < T;  // uniform across the block
  const int lo = t * tile_rows + warp * warp_rows, hi = min(lo + warp_rows, O);
  for (int i = threadIdx.x; i < W * m; i += blockDim.x) offs[i] = 0;
  __syncthreads();
  int* mine = offs + warp * m;
  if (live) {
    for (int i0 = lo + lane; i0 < hi; i0 += 32 * kRowUnroll) {
      int k[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int i = i0 + 32 * u;
        k[u] = i < hi ? bucket_of(__ldg(ids + i), n) : -1;
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u)
        if (k[u] >= 0) atomicAdd(mine + k[u], 1);
    }
  }
  __syncthreads();
  // One scan over the buckets: x the totals (seg_start), y this tile's
  // counts (each bucket's start in the tile); the warps' counts become
  // their exclusive prefixes on the way.
  block_scan(
      m,
      [&](int b) {
        int run = 0;
        for (int w = 0; w < W; ++w) {
          const int c = offs[w * m + b];
          offs[w * m + b] = run;
          run += c;
        }
        return make_int2(__ldg(totals + b), run);
      },
      [&](int b, int2 p) {
        if (t == 0) seg_start[b] = p.x;
        if (!live) return;
        const int tile_start = p.x + __ldg(counts + (size_t)b * T + t);
        if (kStaged) gbase[b] = tile_start - p.y;
        const int base = kStaged ? p.y : tile_start;
        for (int w = 0; w < W; ++w) offs[w * m + b] += base;
      });
  if (!live) return;  // uniform across the block
  const unsigned below = (1u << lane) - 1;
  bool ordered = true;
  int last = -1;  // the bucket of the warp's row before this step's first
  for (int g0 = lo; g0 < hi; g0 += 32 * kRowUnroll) {
    int k[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int i = g0 + 32 * u + lane;
      k[u] = i < hi ? bucket_of(__ldg(ids + i), n) : -1;
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int next = __shfl_down_sync(kFull, k[u], 1), first = __shfl_sync(kFull, k[u], 0);
      if ((lane < 31 && next >= 0 && k[u] > next) || (lane == 0 && first >= 0 && last > first))
        ordered = false;
      last = __shfl_sync(kFull, k[u], 31);
      const unsigned peers = __match_any_sync(kFull, k[u]);
      const int leader = __ffs(peers) - 1;
      int place = 0;
      if (k[u] >= 0 && lane == leader) {
        place = mine[k[u]];
        mine[k[u]] = place + __popc(peers);
      }
      place = __shfl_sync(kFull, place, leader) + __popc(peers & below);
      if (k[u] >= 0) {
        const int row = g0 + 32 * u + lane;
        if (kStaged) {
          tile_row[place] = row;
          tile_key[place] = k[u];
        } else {
          seg_perm[place] = row;
        }
      }
      __syncwarp();  // the leader's offset is read by the next step's leader
    }
  }
  // The warp's last row against the next warp's first.
  if (lane == 0 && lo < hi && hi < O &&
      bucket_of(__ldg(ids + hi - 1), n) > bucket_of(__ldg(ids + hi), n))
    ordered = false;
  if (kStaged) {
    __syncthreads();
    const int rows = min(tile_rows, O - t * tile_rows);
    for (int p = threadIdx.x; p < rows; p += blockDim.x)
      seg_perm[gbase[tile_key[p]] + p] = tile_row[p];
  }
  if (!__syncthreads_and(ordered) && threadIdx.x == 0) *in_order = 0;
}

}  // namespace

// The segment layout of ids (O) int32 into n + 1 buckets (see the note at
// the top): warps (1..8) warps a block, each over warp_rows rows (a multiple
// of 32), so T = ceil(O / (warps x warp_rows)) tiles, the tile staged in
// shared memory when `staged`; scratch holds (n + 1) x (T + 1) ints.
// Writes seg_perm (O), seg_start and chunk_start (n + 1), arrivals (n) and
// in_order (1), all int32 on device `device`, and returns the CUDA error
// code of the launches (0 = success).
extern "C" int tpusfm_ba_seg_layout(int device, const int* ids, int O, int n, int warps,
                                    int warp_rows, int staged, int chunk_rows, int* scratch,
                                    int* seg_perm, int* seg_start, int* chunk_start,
                                    int* arrivals, int* in_order, cudaStream_t stream) {
  const long long m = (long long)n + 1;
  const long long tile_rows = (long long)warps * warp_rows;
  const long long scatter_ints = warps * m + (staged ? m + 2 * tile_rows : 0);
  constexpr long long kMaxShared = 200 * 1024;
  if (n < 0 || O < 0 || warps < 1 || warps > kWarps || warp_rows <= 0 || warp_rows % 32 ||
      chunk_rows <= 0 || scatter_ints * 4 > kMaxShared || m * 4 > kMaxShared ||
      O + tile_rows >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const int T = (int)((O + tile_rows - 1) / tile_rows);
  int* counts = scratch;
  int* totals = counts + (size_t)m * T;
  const int count_smem = (int)(m * 4), scatter_smem = (int)(scatter_ints * 4);
  const auto scatter = staged ? seg_scatter_kernel<true> : seg_scatter_kernel<false>;
  cudaError_t err = cudaSuccess;
  if (count_smem > 48 * 1024)
    err = cudaFuncSetAttribute(seg_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               count_smem);
  if (err == cudaSuccess && scatter_smem > 48 * 1024)
    err = cudaFuncSetAttribute(scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               scatter_smem);
  if (err != cudaSuccess) return (int)err;
  if (T > 0) {
    seg_count_kernel<<<T, kThreads, count_smem, stream>>>(ids, O, n, (int)tile_rows, T, counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  seg_tile_scan_kernel<<<(int)((m + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      counts, T, n, totals, in_order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter<<<T > 0 ? T : 1, 32 * warps, scatter_smem, stream>>>(
      ids, O, n, warp_rows, T, counts, totals, chunk_rows, seg_perm, seg_start, chunk_start,
      arrivals, in_order);
  return (int)cudaGetLastError();
}
