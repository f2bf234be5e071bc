// Fused BA linearization and reduction (kernel K2 of the port).
//
// Replaces the TPU kernel `_linearize_reduce_t_kernel` of
// tpusfm/ops/obs_table.py (wrapper `linearize_reduce_radial3_t`,
// obs_table.py:1532; per-observation math `_linearize_math_t` :1129), in both
// of its modes.  For every observation of a rank-sorted table it computes
// the RADIAL3 reprojection residual, the closed-form pose and point
// Jacobians and the Huber IRLS weight, and returns
//     camred (C, 28) = per camera [Hcc upper 21 | gc 6 | Huber cost],
//     ptred  (P, 9)  = per rank   [Hpp upper 6 | gp 3],
//     wcT    (18, O) = W_o = Jc^T Jp per observation (bf16 or f32).
// In refine mode (self-calibration) the intrinsic Jacobian Jg joins, each
// of its 7 lanes times the static refine mask (:1192-1207), so masked lanes
// give exact zeros, and the outputs become
//     camred (C, 70) = [Hcc 21 | gc 6 | Hcg row-major 42 | cost],
//     grpred (G, 35) = per group [Hgg upper 28 | gg 7],
//     wgT    (21, O) = Wg_o = Jg^T Jp per observation.
// The per-observation value tables never reach device memory; only the W
// tables do (the CG loop reads them every matvec).
//
// Unreduced mode (tpusfm_ba_linearize_unreduced) replaces the TPU kernels
// `_linearize_t_kernel` (wrapper `linearize_radial3_t`, obs_table.py:1325;
// body :1262) and their sublane-layout twins `_linearize_kernel` and
// `_linearize_big_kernel` (`linearize_radial3`, :540; :460, :498): the same
// per-observation math, not reduced, each row's values written as one
// column of the transposed tables
//     camvalsT (43, O) = [Hcc row-major 36 | gc 6 | cost],
//     ptvalsT  (12, O) = [Hpp row-major 9 | gp 3],
//     wcT      (18, O),
// and in refine mode camvalsT (85, O) = [Hcc 36 | gc 6 | Hcg 42 | cost],
// grpvalsT (56, O) = [Hgg row-major 49 | gg 7] and wgT (21, O).  One
// thread per observation, so a warp's 32 observations store 128
// contiguous bytes of each table row.  It reads ~40 bytes a row and
// writes 292 (f32 W; refine 660), against ~450 FLOPs (refine ~765): bound
// by the bytes it writes.
//
// What bounds it: about 300 FLOPs of per-observation math in each pass
// (refine adds ~100 for Jg and its products), against ~100 bytes moved per
// observation (ids, uv, weight, point, the bf16 W rows): a few FLOPs per
// byte, so memory- and latency-bound on this card.  The passes are built
// to keep many rows in flight and the stores coalesced.  The rank pass
// gives each rank a warp (lane l takes rows l, l + 32, ...): a 2,048-rank
// table fills 256 blocks, a long track is split 32 ways, and the lanes
// write neighbouring W columns.  The camera pass gives one block to each
// chunk of a camera's rows (ObsLayout's chunks), so the engine's padding
// rows on camera 0 spread over several blocks, and rows of weight exactly
// 0 (the padding among them) skip the math in every pass.  On request the
// camera pass, which meets the rows in camera order anyway, also writes W
// in that order (wseg), the copy K4 reads without the permutation.  None of
// the TPU machinery (one-hot MXU contractions, 128-lane windows, the
// three-way bf16 split) carries over: rows and tables are indexed directly,
// so ranks need not be dense.
//
// Determinism: no float atomics.  A rank's lanes each walk their rows in
// order and the warp adds them with a fixed shuffle tree.  Rows outside
// every rank range (rank >= P, e.g. invalid rows at 2^30) get W from a
// grid-stride tail and add to no point.  The camera pass recomputes the
// same math through the camera permutation (thread t takes a chunk's rows
// t, t + 256, ...), sums the block with a fixed shuffle tree and adds a
// camera's chunks in chunk order (finish_chunk, ba_common.cuh: an int32
// arrival counter picks the block that does).  The group pass does the
// same over the group's rows; one group usually holds every row (one
// physical camera).  Two calls on the same inputs therefore give the same
// bits.

#include "ba_common.cuh"

namespace {

using namespace tpusfm_ba;

constexpr float kZEps = 1e-8f;   // |z| floor (obs_table.py:1377)
constexpr int kCamDim = 21;      // [t (3) | R row-major (9) | Jr row-major (9)]
constexpr int kTailBlocks = 64;  // grid-stride blocks for rows outside every rank
constexpr int kGrpVals = 35;     // [Hgg upper 28 | gg 7]

struct RefineMask {
  float m[7];
};

struct ObsLin {
  float jcu[6], jcv[6];  // weighted d(u, v)/d pose [aa | t]
  float jpu[3], jpv[3];  // weighted d(u, v)/d point
  float jgu[7], jgv[7];  // weighted, masked d(u, v)/d intrinsics (refine mode only)
  float ru, rv;          // weighted residual
  float cost;            // Huber cost of the unweighted residual times w_in
};

// _linearize_math_t (obs_table.py:1129-1259) for one row.
template <bool kRefine>
__device__ __forceinline__ void linearize_obs(const float* __restrict__ cam,
                                              const float* __restrict__ in, float X0, float X1,
                                              float X2, float u, float v, float w_in, float delta,
                                              const RefineMask& mask, ObsLin& o) {
  const float* R = cam + 3;
  const float* Jr = cam + 12;
  const float Xc1 = R[0] * X0 + R[1] * X1 + R[2] * X2 + cam[0];
  const float Xc2 = R[3] * X0 + R[4] * X1 + R[5] * X2 + cam[1];
  const float z = R[6] * X0 + R[7] * X1 + R[8] * X2 + cam[2];
  const float zs = fabsf(z) < kZEps ? (z < 0.f ? -kZEps : kZEps) : z;
  const float iz = 1.f / zs;
  const bool valid = w_in > 0.f;
  // Masked rows take a benign ray so 0 * inf never poisons a sum.
  const float x = valid ? Xc1 * iz : 0.f;
  const float y = valid ? Xc2 * iz : 0.f;
  const float r2 = x * x + y * y;
  const float fx = in[0], fy = in[1], cx = in[2], cy = in[3];
  const float k1 = in[4], k2 = in[5], k3 = in[6];
  const float dist = 1.f + r2 * (k1 + r2 * (k2 + r2 * k3));
  const float de = k1 + r2 * (2.f * k2 + 3.f * k3 * r2);
  const float ru = fx * x * dist + cx - u;
  const float rv = fy * y * dist + cy - v;
  const float nrm = sqrtf(ru * ru + rv * rv);
  const float w = sqrtf(fminf(1.f, delta / fmaxf(nrm, 1e-12f))) * w_in;

  const float au = fx * (dist + 2.f * x * x * de);
  const float bu = 2.f * fx * x * y * de;
  const float cv = 2.f * fy * x * y * de;
  const float dv = fy * (dist + 2.f * y * y * de);
  const float Lu[3] = {au * iz, bu * iz, -(au * x + bu * y) * iz};
  const float Lv[3] = {cv * iz, dv * iz, -(cv * x + dv * y) * iz};

  // Columns of R [X]x, then N = dXc/daa = -(R [X]x) Jr.
  float a1[3], a2[3], a3[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a1[i] = X2 * R[i * 3 + 1] - X1 * R[i * 3 + 2];
    a2[i] = X0 * R[i * 3 + 2] - X2 * R[i * 3 + 0];
    a3[i] = X1 * R[i * 3 + 0] - X0 * R[i * 3 + 1];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float N[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      N[i] = -(Jr[0 * 3 + j] * a1[i] + Jr[1 * 3 + j] * a2[i] + Jr[2 * 3 + j] * a3[i]);
    o.jcu[j] = (Lu[0] * N[0] + Lu[1] * N[1] + Lu[2] * N[2]) * w;
    o.jcv[j] = (Lv[0] * N[0] + Lv[1] * N[1] + Lv[2] * N[2]) * w;
    o.jcu[3 + j] = Lu[j] * w;
    o.jcv[3 + j] = Lv[j] * w;
    o.jpu[j] = (Lu[0] * R[0 * 3 + j] + Lu[1] * R[1 * 3 + j] + Lu[2] * R[2 * 3 + j]) * w;
    o.jpv[j] = (Lv[0] * R[0 * 3 + j] + Lv[1] * R[1 * 3 + j] + Lv[2] * R[2 * 3 + j]) * w;
  }
  if (kRefine) {
    // d(u, v)/d [fx fy cx cy k1 k2 k3] (:1198-1207).
    const float* m = mask.m;
    const float r4 = r2 * r2;
    const float r6 = r4 * r2;
    o.jgu[0] = x * dist * m[0] * w;
    o.jgu[1] = 0.f;
    o.jgu[2] = m[2] * w;
    o.jgu[3] = 0.f;
    o.jgu[4] = fx * x * r2 * m[4] * w;
    o.jgu[5] = fx * x * r4 * m[5] * w;
    o.jgu[6] = fx * x * r6 * m[6] * w;
    o.jgv[0] = 0.f;
    o.jgv[1] = y * dist * m[1] * w;
    o.jgv[2] = 0.f;
    o.jgv[3] = m[3] * w;
    o.jgv[4] = fy * y * r2 * m[4] * w;
    o.jgv[5] = fy * y * r4 * m[5] * w;
    o.jgv[6] = fy * y * r6 * m[6] * w;
  }
  o.ru = ru * w;
  o.rv = rv * w;
  const float hcost = nrm <= delta ? 0.5f * nrm * nrm : delta * (nrm - 0.5f * delta);
  o.cost = valid ? hcost * w_in : 0.f;
}

struct Tables {
  const float* camtab;  // (C, 21)
  const float* grptab;  // (G, 7)
  const float* pts;     // (P, 3) by rank
  const int* obs_cam;
  const int* obs_grp;
  const int* ranks;
  const float* uvT;     // (2, O)
  const float* obs_w;
  int C, G, P, O;
  float delta;
  RefineMask mask;
};

// Linearizes row o with point X; false (and nothing computed) when the
// row's camera or group id is out of range, which makes it add nothing.
template <bool kRefine>
__device__ __forceinline__ bool linearize_row(const Tables& t, int o, float X0, float X1,
                                              float X2, ObsLin& lin) {
  const int c = t.obs_cam[o];
  const int g = t.obs_grp[o];
  if (c < 0 || c >= t.C || g < 0 || g >= t.G) return false;
  linearize_obs<kRefine>(t.camtab + (size_t)c * kCamDim, t.grptab + (size_t)g * 7, X0, X1, X2,
                         t.uvT[o], t.uvT[(size_t)t.O + o], t.obs_w[o], t.delta, t.mask, lin);
  return true;
}

// Linearizes row o with the point of its rank (a zero point at ranks
// outside [0, P)), as the camera and group passes meet rows.
template <bool kRefine>
__device__ __forceinline__ bool linearize_row_ranked(const Tables& t, int o, ObsLin& lin) {
  const int r = t.ranks[o];
  const bool in_table = r >= 0 && r < t.P;
  const float X0 = in_table ? t.pts[(size_t)r * 3] : 0.f;
  const float X1 = in_table ? t.pts[(size_t)r * 3 + 1] : 0.f;
  const float X2 = in_table ? t.pts[(size_t)r * 3 + 2] : 0.f;
  return linearize_row<kRefine>(t, o, X0, X1, X2, lin);
}

// W (and, in refine mode, Wg) of row o; zeros when lin is null.
template <typename WT, bool kRefine>
__device__ __forceinline__ void write_w(WT* wcT, WT* wgT, int O, int o, const ObsLin* lin) {
#pragma unroll
  for (int d = 0; d < 6; ++d)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      store_w(wcT, (size_t)(d * 3 + k) * O + o,
              lin ? lin->jcu[d] * lin->jpu[k] + lin->jcv[d] * lin->jpv[k] : 0.f);
  if (kRefine) {
#pragma unroll
    for (int e = 0; e < 7; ++e)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        store_w(wgT, (size_t)(e * 3 + k) * O + o,
                lin ? lin->jgu[e] * lin->jpu[k] + lin->jgv[e] * lin->jpv[k] : 0.f);
  }
}

// A row of weight exactly 0 gives W = 0 and exact-zero Jacobians, residual
// and cost (linearize_obs: `valid` is false, so x = y = 0, and w = ... *
// w_in = 0 multiplies every output), so the reduced passes skip its math
// and write a zero W row.  A negative weight is not skipped.
__device__ __forceinline__ bool weighted(const Tables& t, int o) { return t.obs_w[o] != 0.f; }

// Rank pass: blocks [0, rank_blocks) give each rank one warp, whose lane l
// takes the rank's rows l, l + 32, ... in order, writes their W (and Wg)
// columns (neighbouring lanes, neighbouring columns) and sums Hpp/gp; the
// warp adds its lanes with a fixed shuffle tree.  The last kTailBlocks
// blocks write W for the rows that belong to no rank, and zero the columns
// of the segment-ordered copy wseg past the last camera (rows whose camera
// id is outside [0, C)), which the camera pass does not reach.
template <typename WT, bool kRefine>
__global__ void __launch_bounds__(kThreads)
lin_rank_kernel(Tables t, const int* __restrict__ rank_start, const int* __restrict__ seg_start,
                float* __restrict__ ptred, WT* __restrict__ wcT, WT* __restrict__ wgT,
                WT* __restrict__ wseg, int rank_blocks) {
  ObsLin lin;
  if ((int)blockIdx.x < rank_blocks) {
    const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (r >= t.P) return;  // uniform across the warp
    const int lane = threadIdx.x & 31;
    const float X0 = t.pts[(size_t)r * 3], X1 = t.pts[(size_t)r * 3 + 1],
                X2 = t.pts[(size_t)r * 3 + 2];
    float acc[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int end = rank_start[r + 1];
    for (int o = rank_start[r] + lane; o < end; o += 32) {
      if (!weighted(t, o) || !linearize_row<kRefine>(t, o, X0, X1, X2, lin)) {
        write_w<WT, kRefine>(wcT, wgT, t.O, o, nullptr);
        continue;
      }
      write_w<WT, kRefine>(wcT, wgT, t.O, o, &lin);
      int k = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = i; j < 3; ++j) acc[k++] += lin.jpu[i] * lin.jpu[j] + lin.jpv[i] * lin.jpv[j];
#pragma unroll
      for (int i = 0; i < 3; ++i) acc[6 + i] += lin.jpu[i] * lin.ru + lin.jpv[i] * lin.rv;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 9; ++k) ptred[(size_t)r * 9 + k] = acc[k];
    return;
  }
  // Rows before rank 0 or at ranks >= P: zero point, no per-rank sum.
  const int head = rank_start[0];
  const int tail = rank_start[t.P];
  const int loose = head + (t.O - tail);
  const int seg_end = seg_start[t.C];
  const int total = loose + (wseg ? t.O - seg_end : 0);
  const int stride = kTailBlocks * kThreads;
  for (int i = (blockIdx.x - rank_blocks) * kThreads + threadIdx.x; i < total; i += stride) {
    if (i >= loose) {
      write_w<WT, false>(wseg, nullptr, t.O, seg_end + (i - loose), nullptr);
      continue;
    }
    const int o = i < head ? i : tail + (i - head);
    const bool ok = weighted(t, o) && linearize_row<kRefine>(t, o, 0.f, 0.f, 0.f, lin);
    write_w<WT, kRefine>(wcT, wgT, t.O, o, ok ? &lin : nullptr);
  }
}

// Camera pass: one block per chunk of a camera's rows sums their 28
// (refine: 70) camera values [Hcc upper 21 | gc 6 | (Hcg row-major 42) |
// cost]; thread t takes the chunk's rows t, t + 256, ... through the
// camera permutation, and the camera's last chunk block to arrive adds its
// chunks (finish_chunk).  With wseg it also writes each row's W into column
// i of wseg, the i-th row of the camera order.
template <typename WT, bool kRefine>
__global__ void __launch_bounds__(kThreads)
lin_camera_kernel(Tables t, const int* __restrict__ seg_perm, const int* __restrict__ seg_start,
                  const int* __restrict__ chunk_start, int chunk_rows, float* __restrict__ part,
                  int* __restrict__ arrivals, float* __restrict__ camred,
                  WT* __restrict__ wseg) {
  constexpr int K = kRefine ? 70 : 28;
  __shared__ float sums[K];
  zero_empty_segment<K>(chunk_start, t.C, camred);
  ChunkRows ch;
  if (!chunk_rows_of(seg_start, chunk_start, t.C, chunk_rows, blockIdx.x, ch)) return;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  ObsLin lin;
  for (int i = ch.begin + threadIdx.x; i < ch.end; i += kThreads) {
    const int o = seg_perm[i];
    const bool ok = weighted(t, o) && linearize_row_ranked<kRefine>(t, o, lin);
    if (wseg) write_w<WT, false>(wseg, nullptr, t.O, i, ok ? &lin : nullptr);
    if (!ok) continue;
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) acc[k++] += lin.jcu[a] * lin.jcu[b] + lin.jcv[a] * lin.jcv[b];
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += lin.jcu[a] * lin.ru + lin.jcv[a] * lin.rv;
    if (kRefine) {
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int e = 0; e < 7; ++e)
          acc[27 + a * 7 + e] += lin.jcu[a] * lin.jgu[e] + lin.jcv[a] * lin.jgv[e];
    }
    acc[K - 1] += lin.cost;
  }
  block_sum<K>(acc, sums);
  finish_chunk<K>(sums, chunk_start, ch.seg, blockIdx.x, part, arrivals, camred);
}

// Group pass (refine mode): one block per chunk of a group's rows sums
// [Hgg upper 28 | gg 7]; the group's last chunk block to arrive adds its
// chunks (finish_chunk).
__global__ void __launch_bounds__(kThreads)
lin_group_kernel(Tables t, const int* __restrict__ grp_perm, const int* __restrict__ grp_start,
                 const int* __restrict__ grp_chunk_start, int chunk_rows,
                 float* __restrict__ part, int* __restrict__ arrivals,
                 float* __restrict__ grpred) {
  __shared__ float sums[kGrpVals];
  zero_empty_segment<kGrpVals>(grp_chunk_start, t.G, grpred);
  ChunkRows ch;
  if (!chunk_rows_of(grp_start, grp_chunk_start, t.G, chunk_rows, blockIdx.x, ch)) return;
  float acc[kGrpVals];
#pragma unroll
  for (int k = 0; k < kGrpVals; ++k) acc[k] = 0.f;
  ObsLin lin;
  for (int i = ch.begin + threadIdx.x; i < ch.end; i += kThreads) {
    const int o = grp_perm[i];
    if (!weighted(t, o) || !linearize_row_ranked<true>(t, o, lin)) continue;
    int k = 0;
#pragma unroll
    for (int a = 0; a < 7; ++a)
#pragma unroll
      for (int b = a; b < 7; ++b) acc[k++] += lin.jgu[a] * lin.jgu[b] + lin.jgv[a] * lin.jgv[b];
#pragma unroll
    for (int a = 0; a < 7; ++a) acc[28 + a] += lin.jgu[a] * lin.ru + lin.jgv[a] * lin.rv;
  }
  block_sum<kGrpVals>(acc, sums);
  finish_chunk<kGrpVals>(sums, grp_chunk_start, ch.seg, blockIdx.x, part, arrivals, grpred);
}

// A segment layout as the camera and group passes read it (ObsLayout).
struct SegArgs {
  const int* perm;
  const int* start;
  const int* chunk_start;
  int* arrivals;
  int n_chunks;
};

template <typename WT, bool kRefine>
int launch(const Tables& t, const int* rank_start, const SegArgs& cams, const SegArgs& grps,
           int chunk_rows, float* camred, float* ptred, void* wcT, void* wseg, float* grpred,
           void* wgT, float* part, cudaStream_t stream) {
  const int rank_blocks = (t.P + kWarps - 1) / kWarps;
  lin_rank_kernel<WT, kRefine><<<rank_blocks + kTailBlocks, kThreads, 0, stream>>>(
      t, rank_start, cams.start, ptred, static_cast<WT*>(wcT), static_cast<WT*>(wgT),
      static_cast<WT*>(wseg), rank_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lin_camera_kernel<WT, kRefine><<<cams.n_chunks, kThreads, 0, stream>>>(
      t, cams.perm, cams.start, cams.chunk_start, chunk_rows, part, cams.arrivals, camred,
      static_cast<WT*>(wseg));
  err = cudaGetLastError();
  if (err != cudaSuccess || !kRefine) return (int)err;
  lin_group_kernel<<<grps.n_chunks, kThreads, 0, stream>>>(
      t, grps.perm, grps.start, grps.chunk_start, chunk_rows,
      part + (size_t)cams.n_chunks * (kRefine ? 70 : 28), grps.arrivals, grpred);
  return (int)cudaGetLastError();
}

// Unreduced mode: one thread per observation writes its column of every
// value table; a row whose camera or group id is out of range writes zeros.
template <typename WT, bool kRefine>
__global__ void __launch_bounds__(kThreads)
lin_unreduced_kernel(Tables t, float* __restrict__ camvalsT, float* __restrict__ ptvalsT,
                     WT* __restrict__ wcT, float* __restrict__ grpvalsT, WT* __restrict__ wgT) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= t.O) return;
  ObsLin lin;
  if (!linearize_row_ranked<kRefine>(t, o, lin)) lin = ObsLin{};
  const size_t O = t.O;
  float* cam = camvalsT + o;
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = 0; b < 6; ++b) cam[k++ * O] = lin.jcu[a] * lin.jcu[b] + lin.jcv[a] * lin.jcv[b];
#pragma unroll
  for (int a = 0; a < 6; ++a) cam[k++ * O] = lin.jcu[a] * lin.ru + lin.jcv[a] * lin.rv;
  if (kRefine) {
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int e = 0; e < 7; ++e) cam[k++ * O] = lin.jcu[a] * lin.jgu[e] + lin.jcv[a] * lin.jgv[e];
  }
  cam[k * O] = lin.cost;
  float* pt = ptvalsT + o;
  k = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) pt[k++ * O] = lin.jpu[i] * lin.jpu[j] + lin.jpv[i] * lin.jpv[j];
#pragma unroll
  for (int i = 0; i < 3; ++i) pt[k++ * O] = lin.jpu[i] * lin.ru + lin.jpv[i] * lin.rv;
  write_w<WT, kRefine>(wcT, wgT, t.O, o, &lin);
  if (kRefine) {
    float* grp = grpvalsT + o;
    k = 0;
#pragma unroll
    for (int a = 0; a < 7; ++a)
#pragma unroll
      for (int b = 0; b < 7; ++b) grp[k++ * O] = lin.jgu[a] * lin.jgu[b] + lin.jgv[a] * lin.jgv[b];
#pragma unroll
    for (int a = 0; a < 7; ++a) grp[k++ * O] = lin.jgu[a] * lin.ru + lin.jgv[a] * lin.rv;
  }
}

template <typename WT, bool kRefine>
int launch_unreduced(const Tables& t, float* camvalsT, float* ptvalsT, void* wcT,
                     float* grpvalsT, void* wgT, cudaStream_t stream) {
  lin_unreduced_kernel<WT, kRefine><<<(t.O + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      t, camvalsT, ptvalsT, static_cast<WT*>(wcT), grpvalsT, static_cast<WT*>(wgT));
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs as in the wrapper (ops/obs_table.py linearize_reduce_radial3_t):
// float32 tables, int32 id columns, all contiguous on device `device`;
// rank_start (P + 1) and the camera layout (seg_perm (O), seg_start and
// chunk_start (C + 1), arrivals (C), at most cam_chunks chunks) from
// ObsLayout.  refine_mask (host, 7 floats) selects refine mode; it then
// also takes the group layout (grp_perm (O), grp_start and grp_chunk_start
// (G + 1), grp_arrivals (G), at most grp_chunks chunks), grpred (G, 35) and
// wgT (21, O) of W's type; all null otherwise.  Chunks hold chunk_rows rows;
// part is scratch for (cam_chunks, 28 or 70) and then (grp_chunks, 35)
// floats.  w_bf16 selects W's storage type; wseg, when not null, gets W in
// camera order too (18, O).  Launches every pass on `stream` and returns
// the CUDA error code of the launches (0 = success).
extern "C" int tpusfm_ba_linearize(int device, const float* camtab, const float* grptab,
                                   const float* pts, const int* obs_cam, const int* obs_grp,
                                   const int* ranks, const float* uvT, const float* obs_w,
                                   const int* rank_start, const int* seg_perm,
                                   const int* seg_start, const int* chunk_start, int* arrivals,
                                   const int* grp_perm, const int* grp_start,
                                   const int* grp_chunk_start, int* grp_arrivals,
                                   const float* refine_mask, int C, int G, int P, int O,
                                   int cam_chunks, int grp_chunks, int chunk_rows,
                                   float huber_delta, int w_bf16, float* camred, float* ptred,
                                   void* wcT, void* wseg, float* grpred, void* wgT, float* part,
                                   cudaStream_t stream) {
  if (C <= 0 || G <= 0 || P <= 0 || O <= 0 || cam_chunks < C || chunk_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const bool refine = refine_mask != nullptr;
  if (refine && (!grp_perm || !grp_start || !grp_chunk_start || !grp_arrivals || !grpred ||
                 !wgT || grp_chunks < G))
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  Tables t{camtab, grptab, pts, obs_cam, obs_grp, ranks, uvT, obs_w, C, G, P, O, huber_delta, {}};
  for (int e = 0; e < 7; ++e) t.mask.m[e] = refine ? refine_mask[e] : 0.f;
  const SegArgs cams{seg_perm, seg_start, chunk_start, arrivals, cam_chunks};
  const SegArgs grps{grp_perm, grp_start, grp_chunk_start, grp_arrivals, grp_chunks};
  if (refine)
    return w_bf16 ? launch<__nv_bfloat16, true>(t, rank_start, cams, grps, chunk_rows, camred,
                                                ptred, wcT, wseg, grpred, wgT, part, stream)
                  : launch<float, true>(t, rank_start, cams, grps, chunk_rows, camred, ptred,
                                        wcT, wseg, grpred, wgT, part, stream);
  return w_bf16 ? launch<__nv_bfloat16, false>(t, rank_start, cams, grps, chunk_rows, camred,
                                               ptred, wcT, wseg, grpred, wgT, part, stream)
                : launch<float, false>(t, rank_start, cams, grps, chunk_rows, camred, ptred, wcT,
                                       wseg, grpred, wgT, part, stream);
}

// K2's unreduced mode (ops/obs_table.py linearize_radial3_t): the inputs
// of tpusfm_ba_linearize without the layouts (rows in any order);
// refine_mask (host, 7 floats) selects refine mode, which also writes
// grpvalsT (56, O) and wgT (21, O) (null otherwise).  camvalsT (43 or 85,
// O), ptvalsT (12, O) float32, wcT (18, O) of W's type, on device
// `device`.  Launches on `stream` and returns the CUDA error code of the
// launch (0 = success).
extern "C" int tpusfm_ba_linearize_unreduced(int device, const float* camtab, const float* grptab,
                                             const float* pts, const int* obs_cam,
                                             const int* obs_grp, const int* ranks,
                                             const float* uvT, const float* obs_w,
                                             const float* refine_mask, int C, int G, int P, int O,
                                             float huber_delta, int w_bf16, float* camvalsT,
                                             float* ptvalsT, void* wcT, float* grpvalsT,
                                             void* wgT, cudaStream_t stream) {
  if (C <= 0 || G <= 0 || P <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  const bool refine = refine_mask != nullptr;
  if (refine && (!grpvalsT || !wgT)) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  Tables t{camtab, grptab, pts, obs_cam, obs_grp, ranks, uvT, obs_w, C, G, P, O, huber_delta, {}};
  for (int e = 0; e < 7; ++e) t.mask.m[e] = refine ? refine_mask[e] : 0.f;
  if (refine)
    return w_bf16 ? launch_unreduced<__nv_bfloat16, true>(t, camvalsT, ptvalsT, wcT, grpvalsT,
                                                          wgT, stream)
                  : launch_unreduced<float, true>(t, camvalsT, ptvalsT, wcT, grpvalsT, wgT,
                                                  stream);
  return w_bf16 ? launch_unreduced<__nv_bfloat16, false>(t, camvalsT, ptvalsT, wcT, grpvalsT, wgT,
                                                         stream)
                : launch_unreduced<float, false>(t, camvalsT, ptvalsT, wcT, grpvalsT, wgT, stream);
}
