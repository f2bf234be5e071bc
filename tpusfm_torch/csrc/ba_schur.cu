// Schur-complement matvec and back-reduction over the BA coupling table
// (kernels K3 and K4 of the port).
//
// K3 replaces the TPU kernel `_schur_mv_t_kernel` of tpusfm/ops/obs_table.py
// (wrapper `schur_mv_t`, obs_table.py:2133): one CG matvec of the reduced
// camera system,
//     y_r = sum_{o in r} W_o^T v[cam_o]   (per rank, (P, 3)),
//     z_r = Hpp_r^-1 y_r,
//     bc_c = sum_{o in c} W_o z[rank_o],  out_c = Hcc_d,c v_c - bc_c
// (or bc itself without Hcc_d), W_o the (6, 3) block stored as column o of
// the (18, O) table in bf16 or f32.  K4 replaces `_schur_bwd_t_kernel`
// (wrapper `schur_bwd_t`, :1948): out_n = sum_{o: id_o = n} W_o z[rank_o]
// for blocks of any height D (6 for poses, 7 for intrinsic groups).
//
// What bounds them: 36 FLOPs per observation and direction against 36 bytes
// of bf16 W plus ids and a 12-byte point row per observation: well under
// one FLOP per byte, so memory-bound; the camera pass reads W through a
// permutation, so each row costs 18 separate 32-byte sectors and not
// 36 bytes.  One CG iteration is two launches (K3's rank pass and camera
// pass) and no host synchronisation.  The TPU kernel's one-hot
// contractions, 128-lane rank windows and bf16 three-way splits do not
// carry over: the point table is indexed directly, so ranks need not be
// dense, and rows with rank >= P contribute nothing and are never read.
//
// Determinism: no atomics.  The rank pass gives each rank one thread that
// walks its rows [rank_start[r], rank_start[r+1]) in order; the camera pass
// gives each camera (segment) one block whose thread t takes the segment's
// rows t, t + 256, ... of a stable permutation, then sums the threads with
// a fixed shuffle tree.  Two calls on the same inputs give the same bits.

#include "ba_common.cuh"

namespace {

using namespace tpusfm_ba;

// K3 pass 1: y = W^T v per rank and z = Hpp^-1 y.
template <typename WT>
__global__ void __launch_bounds__(kThreads)
schur_rank_kernel(const WT* __restrict__ wT, const int* __restrict__ obs_cam,
                  const float* __restrict__ vtab, const float* __restrict__ hinv,
                  const int* __restrict__ rank_start, int C, int P, int O, float* __restrict__ y,
                  float* __restrict__ z) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= P) return;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  const int end = rank_start[r + 1];
  for (int o = rank_start[r]; o < end; ++o) {
    const int c = obs_cam[o];
    if (c < 0 || c >= C) continue;
    const float* v = vtab + (size_t)c * 6;
    float t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const float vd = v[d];
      t0 += load_w(wT, (size_t)(d * 3 + 0) * O + o) * vd;
      t1 += load_w(wT, (size_t)(d * 3 + 1) * O + o) * vd;
      t2 += load_w(wT, (size_t)(d * 3 + 2) * O + o) * vd;
    }
    a0 += t0;
    a1 += t1;
    a2 += t2;
  }
  y[(size_t)r * 3] = a0;
  y[(size_t)r * 3 + 1] = a1;
  y[(size_t)r * 3 + 2] = a2;
  const float* h = hinv + (size_t)r * 9;
#pragma unroll
  for (int i = 0; i < 3; ++i) z[(size_t)r * 3 + i] = h[i * 3] * a0 + h[i * 3 + 1] * a1 + h[i * 3 + 2] * a2;
}

// K4, and K3 pass 2: out_n = sum over segment n of W_o z[rank_o]; with
// kCombine, out_n = Hcc_d,n v_n - that sum (D = 6).
template <typename WT, int D, bool kCombine>
__global__ void __launch_bounds__(kThreads)
schur_segment_kernel(const WT* __restrict__ wT, const int* __restrict__ ranks,
                     const float* __restrict__ ztab, int Pz, const int* __restrict__ seg_perm,
                     const int* __restrict__ seg_start, int O, const float* __restrict__ hcc,
                     const float* __restrict__ vtab, float* __restrict__ out) {
  __shared__ float sums[D];
  const int n = blockIdx.x;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const int end = seg_start[n + 1];
  for (int i = seg_start[n] + threadIdx.x; i < end; i += kThreads) {
    const int o = seg_perm[i];
    const int r = ranks[o];
    if (r < 0 || r >= Pz) continue;
    const float z0 = ztab[(size_t)r * 3], z1 = ztab[(size_t)r * 3 + 1],
                z2 = ztab[(size_t)r * 3 + 2];
#pragma unroll
    for (int d = 0; d < D; ++d)
      acc[d] += load_w(wT, (size_t)(d * 3) * O + o) * z0 +
                load_w(wT, (size_t)(d * 3 + 1) * O + o) * z1 +
                load_w(wT, (size_t)(d * 3 + 2) * O + o) * z2;
  }
  block_sum<D>(acc, sums);
  if (threadIdx.x < D) {
    float s = sums[threadIdx.x];
    if (kCombine) {
      const float* h = hcc + (size_t)n * D * D + threadIdx.x * D;
      const float* v = vtab + (size_t)n * D;
      float hv = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) hv += h[e] * v[e];
      s = hv - s;
    }
    out[(size_t)n * D + threadIdx.x] = s;
  }
}

template <typename WT, int D>
int launch_segment(const void* wT, const int* ranks, const float* ztab, int Pz,
                   const int* seg_perm, const int* seg_start, int n, int O, float* out,
                   cudaStream_t stream) {
  schur_segment_kernel<WT, D, false><<<n, kThreads, 0, stream>>>(
      static_cast<const WT*>(wT), ranks, ztab, Pz, seg_perm, seg_start, O, nullptr, nullptr, out);
  return (int)cudaGetLastError();
}

template <typename WT>
int launch_bwd(int D, const void* wT, const int* ranks, const float* ztab, int Pz,
               const int* seg_perm, const int* seg_start, int n, int O, float* out,
               cudaStream_t stream) {
  switch (D) {
#define TPUSFM_BWD_CASE(DD) \
  case DD:                  \
    return launch_segment<WT, DD>(wT, ranks, ztab, Pz, seg_perm, seg_start, n, O, out, stream);
    TPUSFM_BWD_CASE(1)
    TPUSFM_BWD_CASE(2)
    TPUSFM_BWD_CASE(3)
    TPUSFM_BWD_CASE(4)
    TPUSFM_BWD_CASE(5)
    TPUSFM_BWD_CASE(6)
    TPUSFM_BWD_CASE(7)
    TPUSFM_BWD_CASE(8)
#undef TPUSFM_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename WT>
int launch_mv(const void* wT, const int* obs_cam, const int* ranks, const float* vtab,
              const float* hinv, const float* hcc, const int* rank_start, const int* seg_perm,
              const int* seg_start, int C, int P, int O, float* y, float* z, float* out,
              cudaStream_t stream) {
  const WT* w = static_cast<const WT*>(wT);
  schur_rank_kernel<WT><<<(P + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      w, obs_cam, vtab, hinv, rank_start, C, P, O, y, z);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (hcc)
    schur_segment_kernel<WT, 6, true><<<C, kThreads, 0, stream>>>(w, ranks, z, P, seg_perm,
                                                                  seg_start, O, hcc, vtab, out);
  else
    schur_segment_kernel<WT, 6, false><<<C, kThreads, 0, stream>>>(
        w, ranks, z, P, seg_perm, seg_start, O, nullptr, nullptr, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K3.  wT (18, O) bf16 (w_bf16 = 1) or f32; obs_cam, ranks (O) int32;
// vtab (C, 6), hinv (P, 3, 3), hcc (C, 6, 6) or null, all f32 contiguous;
// rank_start (P + 1), seg_perm (O), seg_start (C + 1) from ObsLayout.
// Writes y (P, 3), the scratch z (P, 3) and out (C, 6).  Returns the CUDA
// error code of the launches (0 = success).
extern "C" int tpusfm_ba_schur_mv(const void* wT, int w_bf16, const int* obs_cam,
                                  const int* ranks, const float* vtab, const float* hinv,
                                  const float* hcc, const int* rank_start, const int* seg_perm,
                                  const int* seg_start, int C, int P, int O, float* y, float* z,
                                  float* out, cudaStream_t stream) {
  if (C <= 0 || P <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  return w_bf16 ? launch_mv<__nv_bfloat16>(wT, obs_cam, ranks, vtab, hinv, hcc, rank_start,
                                           seg_perm, seg_start, C, P, O, y, z, out, stream)
                : launch_mv<float>(wT, obs_cam, ranks, vtab, hinv, hcc, rank_start, seg_perm,
                                   seg_start, C, P, O, y, z, out, stream);
}

// K4.  wT (3D, O) bf16 or f32 with 1 <= D <= 8; ranks (O) int32 into
// ztab (Pz, 3) f32; seg_perm (O), seg_start (n + 1) from ObsLayout.
// Writes out (n, D) and returns the CUDA error code of the launch.
extern "C" int tpusfm_ba_schur_bwd(const void* wT, int w_bf16, int D, const int* ranks,
                                   const float* ztab, int Pz, const int* seg_perm,
                                   const int* seg_start, int n, int O, float* out,
                                   cudaStream_t stream) {
  if (n <= 0 || O <= 0 || Pz < 0) return (int)cudaErrorInvalidValue;
  return w_bf16 ? launch_bwd<__nv_bfloat16>(D, wT, ranks, ztab, Pz, seg_perm, seg_start, n, O,
                                            out, stream)
                : launch_bwd<float>(D, wT, ranks, ztab, Pz, seg_perm, seg_start, n, O, out,
                                    stream);
}
