// Fused BA linearization and reduction (kernel K2 of the port).
//
// Replaces the TPU kernel `_linearize_reduce_t_kernel` of
// tpusfm/ops/obs_table.py (wrapper `linearize_reduce_radial3_t`,
// obs_table.py:1532; per-observation math `_linearize_math_t` :1129), in its
// refine=False mode.  For every observation of a rank-sorted table it
// computes the RADIAL3 reprojection residual, the closed-form pose and
// point Jacobians and the Huber IRLS weight, and returns
//     camred (C, 28) = per camera [Hcc upper 21 | gc 6 | Huber cost],
//     ptred  (P, 9)  = per rank   [Hpp upper 6 | gp 3],
//     wcT    (18, O) = W_o = Jc^T Jp per observation (bf16 or f32).
// The per-observation value tables never reach device memory; only W does
// (the CG loop reads it every matvec).
//
// What bounds it: about 300 FLOPs of per-observation math in each of two
// passes, plus ~170 for the products, against ~100 bytes moved per
// observation (ids, uv, weight, point and the bf16 W row) and more in
// 32-byte sectors, since the camera pass gathers rows through a
// permutation: a few FLOPs per byte, so memory- and latency-bound on this
// card.  None of the TPU machinery (one-hot MXU contractions, 128-lane
// windows, the three-way bf16 split) carries over: rows and tables are
// indexed directly, so ranks need not be dense.
//
// Determinism: no atomics.  Pass 1, one thread per rank, walks the rank's
// rows [rank_start[r], rank_start[r+1]) in order, writes W and sums Hpp/gp
// in registers.  Rows outside every rank range (rank >= P, e.g. invalid
// rows at 2^30) get W from a grid-stride tail and add to no point.  Pass 2,
// one block per camera, walks the camera's rows through a stable
// permutation (thread t takes rows t, t + 256, ...), recomputes the same
// math and sums the 28 camera values with a fixed shuffle tree.  Two calls
// on the same inputs therefore give the same bits.

#include "ba_common.cuh"

namespace {

using namespace tpusfm_ba;

constexpr float kZEps = 1e-8f;   // |z| floor (obs_table.py:1377)
constexpr int kCamDim = 21;      // [t (3) | R row-major (9) | Jr row-major (9)]
constexpr int kTailBlocks = 64;  // grid-stride blocks for rows outside every rank

struct ObsLin {
  float jcu[6], jcv[6];  // weighted d(u, v)/d pose [aa | t]
  float jpu[3], jpv[3];  // weighted d(u, v)/d point
  float ru, rv;          // weighted residual
  float cost;            // Huber cost of the unweighted residual times w_in
};

// _linearize_math_t (obs_table.py:1129-1259), refine=False, for one row.
__device__ __forceinline__ void linearize_obs(const float* __restrict__ cam,
                                              const float* __restrict__ in, float X0, float X1,
                                              float X2, float u, float v, float w_in, float delta,
                                              ObsLin& o) {
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
};

// Linearizes row o with point X; false (and nothing computed) when the
// row's camera or group id is out of range, which makes it add nothing.
__device__ __forceinline__ bool linearize_row(const Tables& t, int o, float X0, float X1,
                                              float X2, ObsLin& lin) {
  const int c = t.obs_cam[o];
  const int g = t.obs_grp[o];
  if (c < 0 || c >= t.C || g < 0 || g >= t.G) return false;
  linearize_obs(t.camtab + (size_t)c * kCamDim, t.grptab + (size_t)g * 7, X0, X1, X2, t.uvT[o],
                t.uvT[(size_t)t.O + o], t.obs_w[o], t.delta, lin);
  return true;
}

template <typename WT>
__device__ __forceinline__ void write_w(WT* wcT, int O, int o, const ObsLin* lin) {
#pragma unroll
  for (int d = 0; d < 6; ++d)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      store_w(wcT, (size_t)(d * 3 + k) * O + o,
              lin ? lin->jcu[d] * lin->jpu[k] + lin->jcv[d] * lin->jpv[k] : 0.f);
}

// Pass 1: blocks [0, ceil(P/256)) take one rank per thread; the last
// kTailBlocks blocks write W for rows that belong to no rank.
template <typename WT>
__global__ void __launch_bounds__(kThreads)
lin_point_kernel(Tables t, const int* __restrict__ rank_start, float* __restrict__ ptred,
                 WT* __restrict__ wcT, int rank_blocks) {
  ObsLin lin;
  if ((int)blockIdx.x < rank_blocks) {
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (r >= t.P) return;
    const float X0 = t.pts[(size_t)r * 3], X1 = t.pts[(size_t)r * 3 + 1],
                X2 = t.pts[(size_t)r * 3 + 2];
    float acc[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int end = rank_start[r + 1];
    for (int o = rank_start[r]; o < end; ++o) {
      if (!linearize_row(t, o, X0, X1, X2, lin)) {
        write_w(wcT, t.O, o, (const ObsLin*)nullptr);
        continue;
      }
      write_w(wcT, t.O, o, &lin);
      int k = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = i; j < 3; ++j) acc[k++] += lin.jpu[i] * lin.jpu[j] + lin.jpv[i] * lin.jpv[j];
#pragma unroll
      for (int i = 0; i < 3; ++i) acc[6 + i] += lin.jpu[i] * lin.ru + lin.jpv[i] * lin.rv;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) ptred[(size_t)r * 9 + k] = acc[k];
    return;
  }
  // Rows before rank 0 or at ranks >= P: zero point, no per-rank sum.
  const int head = rank_start[0];
  const int tail = rank_start[t.P];
  const int stride = kTailBlocks * kThreads;
  for (int i = (blockIdx.x - rank_blocks) * kThreads + threadIdx.x; i < head + (t.O - tail);
       i += stride) {
    const int o = i < head ? i : tail + (i - head);
    const bool ok = linearize_row(t, o, 0.f, 0.f, 0.f, lin);
    write_w(wcT, t.O, o, ok ? &lin : (const ObsLin*)nullptr);
  }
}

// Pass 2: one block per camera sums its rows' 28 camera values.
__global__ void __launch_bounds__(kThreads)
lin_camera_kernel(Tables t, const int* __restrict__ seg_perm, const int* __restrict__ seg_start,
                  float* __restrict__ camred) {
  __shared__ float sums[28];
  const int c = blockIdx.x;
  float acc[28];
#pragma unroll
  for (int k = 0; k < 28; ++k) acc[k] = 0.f;
  ObsLin lin;
  const int end = seg_start[c + 1];
  for (int i = seg_start[c] + threadIdx.x; i < end; i += kThreads) {
    const int o = seg_perm[i];
    const int r = t.ranks[o];
    const bool in_table = r >= 0 && r < t.P;
    const float X0 = in_table ? t.pts[(size_t)r * 3] : 0.f;
    const float X1 = in_table ? t.pts[(size_t)r * 3 + 1] : 0.f;
    const float X2 = in_table ? t.pts[(size_t)r * 3 + 2] : 0.f;
    if (!linearize_row(t, o, X0, X1, X2, lin)) continue;
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) acc[k++] += lin.jcu[a] * lin.jcu[b] + lin.jcv[a] * lin.jcv[b];
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += lin.jcu[a] * lin.ru + lin.jcv[a] * lin.rv;
    acc[27] += lin.cost;
  }
  block_sum<28>(acc, sums);
  if (threadIdx.x < 28) camred[(size_t)c * 28 + threadIdx.x] = sums[threadIdx.x];
}

template <typename WT>
int launch(const Tables& t, const int* rank_start, const int* seg_perm, const int* seg_start,
           float* camred, float* ptred, void* wcT, cudaStream_t stream) {
  const int rank_blocks = (t.P + kThreads - 1) / kThreads;
  lin_point_kernel<WT><<<rank_blocks + kTailBlocks, kThreads, 0, stream>>>(
      t, rank_start, ptred, static_cast<WT*>(wcT), rank_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lin_camera_kernel<<<t.C, kThreads, 0, stream>>>(t, seg_perm, seg_start, camred);
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs as in the wrapper (ops/obs_table.py linearize_reduce_radial3_t):
// float32 tables, int32 id columns, all contiguous on one device;
// rank_start (P + 1), seg_perm (O) and seg_start (C + 1) from ObsLayout.
// w_bf16 selects W's storage type.  Launches both passes on `stream` and
// returns the CUDA error code of the launches (0 = success).
extern "C" int tpusfm_ba_linearize(const float* camtab, const float* grptab, const float* pts,
                                   const int* obs_cam, const int* obs_grp, const int* ranks,
                                   const float* uvT, const float* obs_w, const int* rank_start,
                                   const int* seg_perm, const int* seg_start, int C, int G, int P,
                                   int O, float huber_delta, int w_bf16, float* camred,
                                   float* ptred, void* wcT, cudaStream_t stream) {
  if (C <= 0 || G <= 0 || P <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  const Tables t{camtab, grptab, pts, obs_cam, obs_grp, ranks, uvT, obs_w, C, G, P, O,
                 huber_delta};
  return w_bf16 ? launch<__nv_bfloat16>(t, rank_start, seg_perm, seg_start, camred, ptred, wcT,
                                        stream)
                : launch<float>(t, rank_start, seg_perm, seg_start, camred, ptred, wcT, stream);
}
