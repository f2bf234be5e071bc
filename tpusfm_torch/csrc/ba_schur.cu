// Schur-complement matvec pieces over the BA coupling tables (kernels K3,
// K4 and K5 of the port).
//
// K3 replaces the TPU kernel `_schur_mv_t_kernel` of tpusfm/ops/obs_table.py
// (wrapper `schur_mv_t`, obs_table.py:2133): one CG matvec of the reduced
// camera system,
//     y_r = sum_{o in r} W_o^T v[cam_o]   (per rank, (P, 3)),
//     z_r = Hpp_r^-1 y_r,
//     bc_c = sum_{o in c} W_o z[rank_o],  out_c = Hcc_d,c v_c - bc_c
// (or bc itself without Hcc_d), W_o the (6, 3) block stored as column o of
// the (18, O) table in bf16 or f32.  K5 replaces `_schur_fwd_t_kernel`
// (wrapper `schur_fwd_t`, :1834): the first line alone, for blocks of any
// height D <= 9 (6 for poses, 7 for RADIAL3 and 9 for Brown-T2 intrinsic
// groups); the self-calibrating matvec runs it on Wc and on Wg.  K4 replaces
// `_schur_bwd_t_kernel` (wrapper `schur_bwd_t`, :1948): out_n = sum over the
// rows of id n of W_o z[rank_o], for the same heights.
//
// What bounds them: 6D FLOPs per observation and direction against 6D bytes
// of bf16 W plus ids and a 12-byte point row per observation: well under one
// FLOP per byte, so memory-bound.  The rows of a rank are contiguous in the
// rank-sorted table, so K5 and K3's rank pass give each rank one warp whose
// lanes take the rank's rows l, l + 32, ...: the loads of each W row and of
// the ids are coalesced, and a 2,048-rank table fills 256 blocks instead of
// the 8 that a thread per rank gives.  A track shorter than 32 rows leaves
// lanes idle (about half at the 200-view rung's ~16).
//
// The camera side is where W's lane-major layout costs: a camera's rows are
// scattered over the table, and reading W through the camera permutation
// costs up to 3D separate 32-byte sectors a row instead of 6D bytes, and
// the rank one more.  K4 avoids it when the caller gives it W in segment
// order (column i is row seg_perm[i], lane-major or row-major) with the
// layout's seg_ranks = ranks[seg_perm]: a chunk then reads W, the ranks
// and z[rank] (rank-sorted within a segment) contiguously.  K2's camera
// pass writes that copy of Wc, K8 gathers it on the unfused path, and a
// one-group table needs none: its permutation is the identity.  Without
// it K4 reads through the permutation, each thread its own rows, two in
// flight: from a row-major table (the reference's sublane `schur_bwd`) a
// scattered W row, rank and z row a row, three dependent loads whose
// latency sets its pace (reading W a warp's 32 rows at a time through
// shared memory, or first writing W z per row in table order as K3 does,
// measured slower; PERF.md).  K3 avoids it too: its
// rank pass, which reads
// each rank's W rows side by side anyway, goes on to write wz_o = W_o z_r
// for the rank's rows into a row-major (O, 6) float32 scratch (each lane
// keeps its first row's W block in registers meanwhile, so a rank of at
// most 32 rows reads W once), and its camera pass reads one permutation
// entry and 24 contiguous bytes a row, and no W, rank or z at all.  At the
// 500-camera shape the scratch is 36 MB, which the card's 50 MB L2 can
// hold from one pass to the next.  Rows
// outside every rank (rank >= P or < 0, sorted to the ends of the table)
// get zero rows there: the engine pads its table with such rows on camera
// 0, and the camera pass adds them.  The TPU kernels' one-hot
// contractions, 128-lane rank windows and bf16 three-way splits do not
// carry over: tables are indexed directly, so ranks need not be dense, and
// rows with rank >= P contribute nothing.
//
// Determinism: no float atomics.  The rank passes' lanes each sum their
// rows in order and the warp adds the 32 partial sums with a fixed shuffle
// tree.  The camera sums (K3's camera pass, K4) are two-level over fixed
// chunks of a segment's rows (ba_common.cuh): an intrinsic group, or
// camera 0 with the engine's padding, may hold most of the table.  A
// chunk's block gives thread t its rows t, t + 256, ... in order, then sums
// the threads with a fixed shuffle tree; K3's third launch adds each
// segment's chunks in order, and K4's last chunk block of a segment does
// (an int32 arrival counter picks that block; the float order is the chunk
// order).  Two calls on the same inputs give the same bits.

#include "ba_common.cuh"

namespace {

using namespace tpusfm_ba;

constexpr int kMaxD = 9;
// K3's camera pass reads kWzRowsInFlight scratch rows of W z at once.
constexpr int kWzRowsInFlight = 4;

// v[c] (D values) into vd; false for an id outside [0, n).
template <int D>
__device__ __forceinline__ bool load_v(int c, const float* __restrict__ vtab, int n,
                                       float (&vd)[D]) {
  if (c < 0 || c >= n) return false;
#pragma unroll
  for (int d = 0; d < D; ++d) vd[d] = __ldg(vtab + (size_t)c * D + d);
  return true;
}

// a += W_o^T v for one row whose 3D values w(0) .. w(3D-1) are (D, 3)
// row-major.  K5's lane-major and row-major reads both run it, so they
// give the same bits.
template <int D, typename WLoad>
__device__ __forceinline__ void add_row_wtv(WLoad w, const float (&vd)[D], float (&a)[3]) {
  float t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    t0 += w(d * 3 + 0) * vd[d];
    t1 += w(d * 3 + 1) * vd[d];
    t2 += w(d * 3 + 2) * vd[d];
  }
  a[0] += t0;
  a[1] += t1;
  a[2] += t2;
}

// Bytes of shared memory a warp stages 32 rows of a row-major (O, 3D)
// table in: the rows' span, plus the 16-byte word it starts inside.
template <typename WT, int D>
constexpr int kStageBytes = (32 * 3 * D * (int)sizeof(WT) + 16 + 15) / 16 * 16;

// Starts copying elements [0, m) of `src` (m <= 32 x 3D), which lie in the
// table [lo, hi), into the warp's 16-byte-aligned `stage`: element e lands
// at stage + (src & 15) + e * sizeof(WT).  The 16-byte words that cover
// the span go by cp.async, one a lane at a time, with no registers held
// (the caller waits with cp.async.wait_all and __syncwarp); a word that
// reaches past the table (at most its first and its last) goes element by
// element, and of it only the span's elements.  Every lane must call it.
template <typename WT>
__device__ __forceinline__ void stage_span(const WT* __restrict__ src, int m,
                                           const WT* __restrict__ lo, const WT* __restrict__ hi,
                                           uint8_t* stage) {
  const uintptr_t ps = reinterpret_cast<uintptr_t>(src);
  const uintptr_t pe = ps + (uintptr_t)m * sizeof(WT);
  const uintptr_t ts = reinterpret_cast<uintptr_t>(lo), te = reinterpret_cast<uintptr_t>(hi);
  const uintptr_t ab = ps & ~(uintptr_t)15;
  const int words = (int)((pe - ab + 15) >> 4);
  for (int i = (int)(threadIdx.x & 31); i < words; i += 32) {
    const uintptr_t g = ab + 16 * (uintptr_t)i;
    if (g >= ts && g + 16 <= te) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       static_cast<uint32_t>(__cvta_generic_to_shared(stage + 16 * i))),
                   "l"(g)
                   : "memory");
    } else {
      for (uintptr_t x = g > ps ? g : ps; x < g + 16 && x < pe; x += sizeof(WT))
        *reinterpret_cast<WT*>(stage + (x - ab)) = *reinterpret_cast<const WT*>(x);
    }
  }
}

// sum over the rows of rank r of W_o^T v[id_o], all D rows of W_o; rows
// whose id is outside [0, n) add nothing.  The 32 lanes of one warp share
// the work: lane l takes the rows begin + l, begin + l + 32, ... in order;
// the lanes' sums are added with a fixed shuffle tree and lane 0 holds the
// result.  Every lane of the warp must call it.
//
// W is read lane-major ((3D, O): value k of row o at k O + o, each load
// coalesced over the warp's 32 rows) or, with kRowMajor, row-major ((O, 3D):
// row o's 3D values contiguous).  A rank's rows are contiguous in the
// rank-sorted table, so the row-major read stages each run of 32 rows, one
// contiguous span of 32 x 3D values, into the warp's shared `stage` by
// 16-byte asynchronous copies (stage_span), loads the rows' ids and v rows
// while they land, and takes W from there; the arithmetic and its order
// are the lane-major read's.
//
// The reference's `_schur_fwd_t_kernel` (tpusfm/ops/obs_table.py:1811-1815)
// sums only d < 6 whatever D is, so on the TPU the intrinsic-group half of
// the self-calibrating matvec (D = 7 or 9) drops the lanes past the sixth
// and is not the transpose of its K4 half.  This port departs from it on
// purpose: every lane counts, as the wrapper's contract states.
template <typename WT, int D, bool kRowMajor>
__device__ __forceinline__ void rank_wtv_warp(const WT* __restrict__ w,
                                              const int* __restrict__ ids,
                                              const float* __restrict__ vtab, int n, int O,
                                              int begin, int end, uint8_t* stage, float (&a)[3]) {
  a[0] = a[1] = a[2] = 0.f;
  const int lane = threadIdx.x & 31;
  float vd[D];
  if constexpr (kRowMajor) {
    for (int o0 = begin; o0 < end; o0 += 32) {
      const int rows = min(32, end - o0);
      const WT* span = w + (size_t)o0 * (3 * D);
      stage_span(span, rows * 3 * D, w, w + (size_t)O * (3 * D), stage);
      const bool live = lane < rows && load_v<D>(__ldg(ids + o0 + lane), vtab, n, vd);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
      const WT* row = reinterpret_cast<const WT*>(
                          stage + (reinterpret_cast<uintptr_t>(span) & 15)) + lane * (3 * D);
      if (live) add_row_wtv<D>([&](int k) { return load_w(row, k); }, vd, a);
      __syncwarp();  // the stage is read before the next run overwrites it
    }
  } else {
    for (int o = begin + lane; o < end; o += 32)
      if (load_v<D>(__ldg(ids + o), vtab, n, vd))
        add_row_wtv<D>([&](int k) { return load_w(w, (size_t)k * O + o); }, vd, a);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a[0] += __shfl_down_sync(0xffffffffu, a[0], off);
    a[1] += __shfl_down_sync(0xffffffffu, a[1], off);
    a[2] += __shfl_down_sync(0xffffffffu, a[2], off);
  }
}

// K5: y = W^T v per rank, D rows per block; one warp per rank.  A warp's
// loads are in flight for one of its round trips (rank range, then W and
// ids, then v), so the read wants many warps an SM: the row-major read is
// held to the lane-major read's 32 registers (eight blocks an SM).
template <typename WT, int D, bool kRowMajor>
__global__ void __launch_bounds__(kThreads, kRowMajor ? 8 : 1)
schur_fwd_kernel(const WT* __restrict__ w, const int* __restrict__ ids,
                 const float* __restrict__ vtab, int n, const int* __restrict__ rank_start, int P,
                 int O, float* __restrict__ y) {
  constexpr int kStage = kRowMajor ? kStageBytes<WT, D> : 16;
  __shared__ __align__(16) uint8_t stage[kRowMajor ? kWarps : 1][kStage];
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= P) return;  // uniform across the warp
  float a[3];
  rank_wtv_warp<WT, D, kRowMajor>(w, ids, vtab, n, O, rank_start[r], rank_start[r + 1],
                                  stage[kRowMajor ? warp : 0], a);
  if ((threadIdx.x & 31) == 0) {
    y[(size_t)r * 3] = a[0];
    y[(size_t)r * 3 + 1] = a[1];
    y[(size_t)r * 3 + 2] = a[2];
  }
}

// One observation's (6, 3) W block, from column o of the (18, O) table.
template <typename WT>
__device__ __forceinline__ void load_w6x3(const WT* __restrict__ wT, int O, int o,
                                          float (&w)[18]) {
#pragma unroll
  for (int k = 0; k < 18; ++k) w[k] = load_w(wT, (size_t)k * O + o);
}

// a += W^T v[c] for one row (rank_wtv_warp's arithmetic); nothing for a
// camera id outside [0, C).
__device__ __forceinline__ void add_wtv(const float (&w)[18], int c,
                                        const float* __restrict__ vtab, int C, float (&a)[3]) {
  if (c < 0 || c >= C) return;
  const float* v = vtab + (size_t)c * 6;
  float t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    const float vd = __ldg(v + d);
    t0 += w[d * 3] * vd;
    t1 += w[d * 3 + 1] * vd;
    t2 += w[d * 3 + 2] * vd;
  }
  a[0] += t0;
  a[1] += t1;
  a[2] += t2;
}

// Row o of the (O, 6) scratch wz: W_o z.
__device__ __forceinline__ void store_wz(const float (&w)[18], const float (&z)[3],
                                         float* __restrict__ wz, int o) {
  float v[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) v[d] = w[d * 3] * z[0] + w[d * 3 + 1] * z[1] + w[d * 3 + 2] * z[2];
  float2* row = reinterpret_cast<float2*>(wz + (size_t)o * 6);
  row[0] = make_float2(v[0], v[1]);
  row[1] = make_float2(v[2], v[3]);
  row[2] = make_float2(v[4], v[5]);
}

// K3 pass 1: one warp per rank r writes y_r = sum W_o^T v[cam_o] and, for
// each of the rank's rows, wz_o = W_o z_r with z_r = Hpp_r^-1 y_r, into the
// row-major (O, 6) scratch wz.  Lane l takes the rank's rows l, l + 32, ...
// in order and the warp adds the lanes with a fixed shuffle tree (as
// rank_wtv_warp); each lane keeps its first row's W block in registers for
// the wz write, so a rank of at most 32 rows reads W once, and only rows
// past the 32nd are read again.  Before that, the grid's threads zero the
// rows of wz outside every rank, [0, rank_start[0]) and [rank_start[P], O),
// which the camera pass adds as they are.
template <typename WT>
__global__ void __launch_bounds__(kThreads)
schur_rank_wz_kernel(const WT* __restrict__ wT, const int* __restrict__ obs_cam,
                     const float* __restrict__ vtab, const float* __restrict__ hinv,
                     const int* __restrict__ rank_start, int C, int P, int O,
                     float* __restrict__ y, float* __restrict__ wz) {
  const float2 zero = make_float2(0.f, 0.f);
  const int head = rank_start[0], tail = rank_start[P];
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < head + O - tail;
       k += gridDim.x * kThreads) {
    float2* row = reinterpret_cast<float2*>(wz + (size_t)(k < head ? k : tail + k - head) * 6);
    row[0] = zero;
    row[1] = zero;
    row[2] = zero;
  }
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= P) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int first = rank_start[r] + lane, end = rank_start[r + 1];
  float w[18], a[3] = {0.f, 0.f, 0.f};
  if (first < end) {
    load_w6x3(wT, O, first, w);
    add_wtv(w, __ldg(obs_cam + first), vtab, C, a);
  }
  for (int o = first + 32; o < end; o += 32) {
    float wo[18];
    load_w6x3(wT, O, o, wo);
    add_wtv(wo, __ldg(obs_cam + o), vtab, C, a);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a[0] += __shfl_down_sync(0xffffffffu, a[0], off);
    a[1] += __shfl_down_sync(0xffffffffu, a[1], off);
    a[2] += __shfl_down_sync(0xffffffffu, a[2], off);
  }
  if (lane == 0) {
    y[(size_t)r * 3] = a[0];
    y[(size_t)r * 3 + 1] = a[1];
    y[(size_t)r * 3 + 2] = a[2];
  }
  const float* h = hinv + (size_t)r * 9;
  float z[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)  // lane 0 holds the sum; its z goes to every lane
    z[i] = __shfl_sync(0xffffffffu, h[i * 3] * a[0] + h[i * 3 + 1] * a[1] + h[i * 3 + 2] * a[2],
                       0);
  if (first < end) store_wz(w, z, wz, first);
  for (int o = first + 32; o < end; o += 32) {
    float wo[18];
    load_w6x3(wT, O, o, wo);
    store_wz(wo, z, wz, o);
  }
}

// K3 pass 2: one block per chunk of a camera's rows writes the chunk's sum
// of wz (6 values); thread t reads the permuted rows t, t + kThreads, ...,
// kWzRowsInFlight at a time, each row's 24 bytes whole.
__global__ void __launch_bounds__(kThreads)
schur_wz_chunk_kernel(const float* __restrict__ wz, const int* __restrict__ seg_perm,
                      const int* __restrict__ seg_start, const int* __restrict__ chunk_start,
                      int C, int chunk_rows, float* __restrict__ part) {
  __shared__ float sums[6];
  ChunkRows ch;
  if (!chunk_rows_of(seg_start, chunk_start, C, chunk_rows, blockIdx.x, ch)) return;
  float acc[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) acc[d] = 0.f;
  for (int i0 = ch.begin + threadIdx.x; i0 < ch.end; i0 += kThreads * kWzRowsInFlight) {
    int o[kWzRowsInFlight];
#pragma unroll
    for (int u = 0; u < kWzRowsInFlight; ++u) {
      const int i = i0 + u * kThreads;
      o[u] = i < ch.end ? __ldg(seg_perm + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kWzRowsInFlight; ++u) {
      if (o[u] < 0) continue;
      const float2* row = reinterpret_cast<const float2*>(wz + (size_t)o[u] * 6);
      const float2 w01 = __ldg(row), w23 = __ldg(row + 1), w45 = __ldg(row + 2);
      acc[0] += w01.x;
      acc[1] += w01.y;
      acc[2] += w23.x;
      acc[3] += w23.y;
      acc[4] += w45.x;
      acc[5] += w45.y;
    }
  }
  block_sum<6>(acc, sums);
  if (threadIdx.x < 6) part[(size_t)blockIdx.x * 6 + threadIdx.x] = sums[threadIdx.x];
}

// K3 pass 3: out_c = [Hcc_d,c v_c -] the sum of camera c's chunk partials
// in chunk order (0 for a camera with no rows); one thread per value.
template <bool kCombine>
__global__ void __launch_bounds__(kThreads)
schur_camera_finish_kernel(const float* __restrict__ part, const int* __restrict__ chunk_start,
                           int C, const float* __restrict__ hcc, const float* __restrict__ vtab,
                           float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= C * 6) return;
  const int c = i / 6, d = i - c * 6;
  float s = 0.f;
  const int end = chunk_start[c + 1];
  for (int k = chunk_start[c]; k < end; ++k) s += part[(size_t)k * 6 + d];
  if (kCombine) {
    const float* h = hcc + (size_t)c * 36 + d * 6;
    const float* v = vtab + (size_t)c * 6;
    float hv = 0.f;
#pragma unroll
    for (int e = 0; e < 6; ++e) hv += h[e] * v[e];
    s = hv - s;
  }
  out[i] = s;
}

// How K4 reaches the W column and rank of the i-th row of a segment order:
// through the permutation (column seg_perm[i] of the table and
// ranks[seg_perm[i]]), or in order (column i and ranks[i] of a table and a
// rank column already in segment order), each from a lane-major (3D, O) or
// a row-major (O, 3D) table.
enum WRead { kPermuted = 0, kOrderedLane = 1, kOrderedRow = 2, kPermutedRow = 3 };

// K4's rows in flight per thread.
constexpr int kBwdRowsInFlight = 2;

// K4's rows [begin, end) of a chunk for thread t: rows begin + t,
// begin + t + kThreads, ... in order, kBwdRowsInFlight at a time, each
// thread loading its own rows' W values; kPerm reaches row i's column and
// rank through seg_perm[i], else at i.
template <typename WT, int D, bool kPerm, bool kRowMajor>
__device__ __forceinline__ void bwd_rows_direct(const WT* __restrict__ wT,
                                                const int* __restrict__ ranks,
                                                const float* __restrict__ ztab, int Pz,
                                                const int* __restrict__ seg_perm, int O, int begin,
                                                int end, float (&acc)[D]) {
  constexpr int U = kBwdRowsInFlight;
  for (int i0 = begin + threadIdx.x; i0 < end; i0 += kThreads * U) {
    int o[U], r[U];
    float w[U][3 * D];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      o[u] = i >= end ? -1 : kPerm ? __ldg(seg_perm + i) : i;
      r[u] = o[u] < 0 ? -1 : __ldg(ranks + o[u]);
#pragma unroll
      for (int k = 0; k < 3 * D; ++k)
        w[u][k] = o[u] < 0 ? 0.f
                  : load_w(wT, kRowMajor ? (size_t)o[u] * (3 * D) + k : (size_t)k * O + o[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r[u] < 0 || r[u] >= Pz) continue;
      const float* zr = ztab + (size_t)r[u] * 3;
      const float z0 = __ldg(zr), z1 = __ldg(zr + 1), z2 = __ldg(zr + 2);
#pragma unroll
      for (int d = 0; d < D; ++d)
        acc[d] += w[u][d * 3] * z0 + w[u][d * 3 + 1] * z1 + w[u][d * 3 + 2] * z2;
    }
  }
}

// K4: one block per chunk of a segment's rows sums W_o z[rank_o] (D
// values) and the chunk's last block to arrive adds the segment's chunks
// (finish_chunk).  Thread t takes the chunk's rows t, t + kThreads, ... in
// order, whichever way it reaches them, so every read of one table gives
// the same bits.  The permuted reads look at the layout's in_order flag
// (device memory, null for none): where it is set, seg_perm is the
// identity and the kernel takes the ordered read of the same table, with
// no host read to choose it.
template <typename WT, int D, int kRead>
__global__ void __launch_bounds__(kThreads)
schur_bwd_kernel(const WT* __restrict__ wT, const int* __restrict__ ranks,
                 const float* __restrict__ ztab, int Pz, const int* __restrict__ seg_perm,
                 const int* __restrict__ seg_start, const int* __restrict__ chunk_start,
                 const int* __restrict__ in_order, int n, int O, int chunk_rows,
                 float* __restrict__ part, int* __restrict__ arrivals, float* __restrict__ out) {
  constexpr bool kPerm = kRead == kPermuted || kRead == kPermutedRow;
  constexpr bool kRowMajor = kRead == kOrderedRow || kRead == kPermutedRow;
  __shared__ float sums[D];
  zero_empty_segment<D>(chunk_start, n, out);
  ChunkRows ch;
  if (!chunk_rows_of(seg_start, chunk_start, n, chunk_rows, blockIdx.x, ch)) return;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  if (!kPerm || (in_order != nullptr && __ldg(in_order) != 0))
    bwd_rows_direct<WT, D, false, kRowMajor>(wT, ranks, ztab, Pz, seg_perm, O, ch.begin, ch.end,
                                             acc);
  else
    bwd_rows_direct<WT, D, true, kRowMajor>(wT, ranks, ztab, Pz, seg_perm, O, ch.begin, ch.end,
                                            acc);
  block_sum<D>(acc, sums);
  finish_chunk<D>(sums, chunk_start, ch.seg, blockIdx.x, part, arrivals, out);
}

template <typename WT, int D>
int launch_bwd_d(int read, const void* wT, const int* ranks, const float* ztab, int Pz,
                 const int* seg_perm, const int* seg_start, const int* chunk_start,
                 const int* in_order, int n, int O, int n_chunks, int chunk_rows, float* part,
                 int* arrivals, float* out, cudaStream_t stream) {
  const WT* w = static_cast<const WT*>(wT);
#define TPUSFM_BWD_LAUNCH(READ)                                                             \
  schur_bwd_kernel<WT, D, READ><<<n_chunks, kThreads, 0, stream>>>(                         \
      w, ranks, ztab, Pz, seg_perm, seg_start, chunk_start, in_order, n, O, chunk_rows, part, \
      arrivals, out)
  if (read == kPermuted)
    TPUSFM_BWD_LAUNCH(kPermuted);
  else if (read == kOrderedLane)
    TPUSFM_BWD_LAUNCH(kOrderedLane);
  else if (read == kOrderedRow)
    TPUSFM_BWD_LAUNCH(kOrderedRow);
  else
    TPUSFM_BWD_LAUNCH(kPermutedRow);
#undef TPUSFM_BWD_LAUNCH
  return (int)cudaGetLastError();
}

template <typename WT, int D>
int launch_fwd_d(int row_major, const void* wT, const int* ids, const float* vtab, int n,
                 const int* rank_start, int P, int O, float* y, cudaStream_t stream) {
  const WT* w = static_cast<const WT*>(wT);
  const int blocks = (P + kWarps - 1) / kWarps;
  if (row_major)
    schur_fwd_kernel<WT, D, true><<<blocks, kThreads, 0, stream>>>(w, ids, vtab, n, rank_start,
                                                                    P, O, y);
  else
    schur_fwd_kernel<WT, D, false><<<blocks, kThreads, 0, stream>>>(w, ids, vtab, n, rank_start,
                                                                     P, O, y);
  return (int)cudaGetLastError();
}

#define TPUSFM_D_CASES(CALL) \
  CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) CALL(9)

template <typename WT>
int launch_bwd(int D, int read, const void* wT, const int* ranks, const float* ztab, int Pz,
               const int* seg_perm, const int* seg_start, const int* chunk_start,
               const int* in_order, int n, int O, int n_chunks, int chunk_rows, float* part,
               int* arrivals, float* out, cudaStream_t stream) {
  switch (D) {
#define TPUSFM_BWD_CASE(DD)                                                                   \
  case DD:                                                                                   \
    return launch_bwd_d<WT, DD>(read, wT, ranks, ztab, Pz, seg_perm, seg_start, chunk_start, \
                                in_order, n, O, n_chunks, chunk_rows, part, arrivals, out,   \
                                stream);
    TPUSFM_D_CASES(TPUSFM_BWD_CASE)
#undef TPUSFM_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename WT>
int launch_fwd(int D, int row_major, const void* wT, const int* ids, const float* vtab, int n,
               const int* rank_start, int P, int O, float* y, cudaStream_t stream) {
  switch (D) {
#define TPUSFM_FWD_CASE(DD) \
  case DD:                  \
    return launch_fwd_d<WT, DD>(row_major, wT, ids, vtab, n, rank_start, P, O, y, stream);
    TPUSFM_D_CASES(TPUSFM_FWD_CASE)
#undef TPUSFM_FWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#undef TPUSFM_D_CASES

template <typename WT>
int launch_mv(const void* wT, const int* obs_cam, const float* vtab, const float* hinv,
              const float* hcc, const int* rank_start, const int* seg_perm, const int* seg_start,
              const int* chunk_start, int C, int P, int O, int n_chunks, int chunk_rows, float* y,
              float* wz, float* part, float* out, cudaStream_t stream) {
  schur_rank_wz_kernel<WT><<<(P + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const WT*>(wT), obs_cam, vtab, hinv, rank_start, C, P, O, y, wz);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  schur_wz_chunk_kernel<<<n_chunks, kThreads, 0, stream>>>(wz, seg_perm, seg_start, chunk_start,
                                                           C, chunk_rows, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (C * 6 + kThreads - 1) / kThreads;
  if (hcc)
    schur_camera_finish_kernel<true><<<blocks, kThreads, 0, stream>>>(part, chunk_start, C, hcc,
                                                                       vtab, out);
  else
    schur_camera_finish_kernel<false><<<blocks, kThreads, 0, stream>>>(part, chunk_start, C,
                                                                        nullptr, nullptr, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K3.  wT (18, O) bf16 (w_bf16 = 1) or f32; obs_cam (O) int32; vtab
// (C, 6), hinv (P, 3, 3), hcc (C, 6, 6) or null, all f32 contiguous on
// device `device`; rank_start (P + 1), seg_perm (O), seg_start and
// chunk_start (C + 1) from ObsLayout, at most n_chunks chunks of chunk_rows
// rows.  Writes y (P, 3), the scratch wz (O, 6) (8-byte aligned) and part
// (n_chunks, 6), and out (C, 6).  Returns the CUDA error code of the
// launches (0 = success).
extern "C" int tpusfm_ba_schur_mv(int device, const void* wT, int w_bf16, const int* obs_cam,
                                  const float* vtab, const float* hinv, const float* hcc,
                                  const int* rank_start, const int* seg_perm,
                                  const int* seg_start, const int* chunk_start, int C, int P,
                                  int O, int n_chunks, int chunk_rows, float* y, float* wz,
                                  float* part, float* out, cudaStream_t stream) {
  if (C <= 0 || P <= 0 || O <= 0 || n_chunks <= 0 || chunk_rows <= 0 ||
      (reinterpret_cast<uintptr_t>(wz) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return w_bf16 ? launch_mv<__nv_bfloat16>(wT, obs_cam, vtab, hinv, hcc, rank_start, seg_perm,
                                           seg_start, chunk_start, C, P, O, n_chunks, chunk_rows,
                                           y, wz, part, out, stream)
                : launch_mv<float>(wT, obs_cam, vtab, hinv, hcc, rank_start, seg_perm, seg_start,
                                   chunk_start, C, P, O, n_chunks, chunk_rows, y, wz, part, out,
                                   stream);
}

// K4.  wT (3D, O) bf16 or f32 with 1 <= D <= 9 and ranks (O) int32 into
// ztab (Pz, 3) f32, read as `read` says (WRead): kPermuted and
// kPermutedRow, wT lane-major (3D, O) or row-major (O, 3D) and ranks in
// table order, reached through seg_perm; kOrderedLane and kOrderedRow, wT
// lane-major or row-major and ranks both already in segment order (column
// i is row seg_perm[i]).  seg_perm (O),
// seg_start and chunk_start (n + 1), in_order (1, or null: the permuted
// reads then take the ordered one where it is set) and arrivals (n, zero,
// left zero) from ObsLayout, at most n_chunks chunks of chunk_rows rows;
// part (n_chunks, D) scratch.  Writes out (n, D) on device `device` and
// returns the CUDA error code of the launch.
extern "C" int tpusfm_ba_schur_bwd(int device, const void* wT, int w_bf16, int read, int D,
                                   const int* ranks, const float* ztab, int Pz,
                                   const int* seg_perm, const int* seg_start,
                                   const int* chunk_start, const int* in_order, int* arrivals,
                                   int n, int O, int n_chunks, int chunk_rows, float* part,
                                   float* out, cudaStream_t stream) {
  if (n <= 0 || O <= 0 || Pz < 0 || n_chunks < n || chunk_rows <= 0 || D < 1 || D > kMaxD ||
      read < kPermuted || read > kPermutedRow)
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return w_bf16 ? launch_bwd<__nv_bfloat16>(D, read, wT, ranks, ztab, Pz, seg_perm, seg_start,
                                            chunk_start, in_order, n, O, n_chunks, chunk_rows,
                                            part, arrivals, out, stream)
                : launch_bwd<float>(D, read, wT, ranks, ztab, Pz, seg_perm, seg_start,
                                    chunk_start, in_order, n, O, n_chunks, chunk_rows, part,
                                    arrivals, out, stream);
}

// K5.  wT bf16 or f32 with 1 <= D <= 9, lane-major (3D, O) when
// row_major = 0, row-major (O, 3D) when 1; ids (O) int32 into vtab (n, D)
// f32; rank_start (P + 1) from ObsLayout; all on device `device`.  The two
// reads give the same bits.  Writes y (P, 3) and returns the CUDA error
// code of the launch.
extern "C" int tpusfm_ba_schur_fwd(int device, const void* wT, int w_bf16, int row_major, int D,
                                   const int* ids, const float* vtab, int n,
                                   const int* rank_start, int P, int O, float* y,
                                   cudaStream_t stream) {
  if (n <= 0 || P <= 0 || O <= 0 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return w_bf16 ? launch_fwd<__nv_bfloat16>(D, row_major, wT, ids, vtab, n, rank_start, P, O, y,
                                            stream)
                : launch_fwd<float>(D, row_major, wT, ids, vtab, n, rank_start, P, O, y, stream);
}
