// Fused descriptor distance + running top-2 (kernel K1 of the port).
//
// Replaces the TPU kernel `_match_kernel` of tpusfm/ops/pallas_match.py
// (wrapper `match_topk2`, pallas_match.py:134).  For every row a of A and
// every pair of a batch it returns
//     d1 = min_b (b2m_b - 2 a.b) + |a|^2,  d2 = second smallest (duplicates
//     count),  i1 = argmin (lowest B index on ties),
// where b2m_b = |b|^2 for an unmasked B row and the 3.4e38 sentinel of
// pallas_match.py:51 for a masked one.  The (Na, Nb) distance matrix never
// reaches device memory.
//
// What bounds it: about 2*Na*Nb*128 FLOPs against (Na + Nb)*512 bytes per
// pair (some 512 FLOPs per byte at 1024 x 1024), so it is compute-bound on
// the CUDA cores.  Design: a grid of (A tiles of 64 rows) x pairs; the A
// tile stays in shared memory (transposed, so each thread reads its four
// rows as one float4), B tiles of 64 rows stream through shared memory; a
// 256-thread block computes the 64 x 64 distance tile as 4 x 4 fp32 FMA
// micro-tiles and folds each thread's 4 columns into a running
// (m1, m2, i1) per row in registers; 16 lanes then merge with the combine
// rule of pallas_match.py:89-95, breaking exact ties by B index.
// On SIFT's u8 grid every partial sum is an integer below 2^24, so the
// result is exact in any summation order and bit-equal to the plain twin.
// A tensor-core version (wgmma, or u8 mma on the integer grid) fed by TMA
// is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;          // descriptor width
constexpr int kTile = 64;        // A rows per block == B rows per streamed tile
constexpr int kLds = kTile + 4;  // padded row stride of the transposed tiles
constexpr int kThreads = 256;
constexpr float kSentinel = 3.4e38f;
constexpr size_t kSmemBytes = (2 * kD * kLds + 2 * kTile) * sizeof(float);

struct Top2 {
  float m1, m2;
  int i1;
};

// Columns reach one thread in increasing index order, so a tie with m1
// keeps the earlier index and lowers m2 (duplicates count for d2).
__device__ __forceinline__ void top2_push(Top2& t, float v, int j) {
  if (v < t.m1) {
    t.m2 = t.m1;
    t.m1 = v;
    t.i1 = j;
  } else if (v < t.m2) {
    t.m2 = v;
  }
}

__device__ __forceinline__ void top2_merge(Top2& x, float ym1, float ym2, int yi) {
  const float m1 = fminf(x.m1, ym1);
  const float m2 = fminf(fmaxf(x.m1, ym1), fminf(x.m2, ym2));
  const bool take_y = (ym1 < x.m1) || (ym1 == x.m1 && yi < x.i1);
  x.m1 = m1;
  x.m2 = m2;
  x.i1 = take_y ? yi : x.i1;
}

// Copy rows [row0, row0 + kTile) of a (n, kD) matrix into sT[k][r],
// zero-filling rows past n.
__device__ __forceinline__ void load_tile_transposed(float* sT, const float* src, int row0, int n) {
  for (int i = threadIdx.x; i < kTile * kD / 4; i += kThreads) {
    const int r = i / (kD / 4);
    const int k = (i % (kD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * kD + k);
    sT[(k + 0) * kLds + r] = v.x;
    sT[(k + 1) * kLds + r] = v.y;
    sT[(k + 2) * kLds + r] = v.z;
    sT[(k + 3) * kLds + r] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads)
topk2_match_kernel(const float* __restrict__ da, const float* __restrict__ db,
                   const uint8_t* __restrict__ mask_b, float* __restrict__ d1,
                   float* __restrict__ d2, int* __restrict__ i1, int na, int nb) {
  extern __shared__ __align__(16) float smem[];
  float* aT = smem;               // [kD][kLds]: A tile, transposed
  float* bT = aT + kD * kLds;     // [kD][kLds]: current B tile, transposed
  float* b2m = bT + kD * kLds;    // [kTile]: |b|^2 or the sentinel
  float* a2 = b2m + kTile;        // [kTile]: |a|^2

  const int pair = blockIdx.y;
  const int row0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15;  // columns tx*4 .. tx*4+3 of each B tile
  const int ty = threadIdx.x >> 4;  // rows ty*4 .. ty*4+3 of the A tile
  const float* A = da + (size_t)pair * na * kD;
  const float* B = db + (size_t)pair * nb * kD;
  const uint8_t* M = mask_b + (size_t)pair * nb;

  load_tile_transposed(aT, A, row0, na);
  __syncthreads();
  if (threadIdx.x < kTile) {
    float s = 0.f;
    for (int k = 0; k < kD; ++k) {
      const float v = aT[k * kLds + threadIdx.x];
      s = fmaf(v, v, s);
    }
    a2[threadIdx.x] = s;
  }

  Top2 best[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) best[i] = {kSentinel, kSentinel, 0};

  for (int col0 = 0; col0 < nb; col0 += kTile) {
    __syncthreads();  // the previous B tile is consumed
    load_tile_transposed(bT, B, col0, nb);
    __syncthreads();
    if (threadIdx.x < kTile) {
      const int c = col0 + threadIdx.x;
      float s = 0.f;
      for (int k = 0; k < kD; ++k) {
        const float v = bT[k * kLds + threadIdx.x];
        s = fmaf(v, v, s);
      }
      b2m[threadIdx.x] = (c < nb && M[c]) ? s : kSentinel;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < kD; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(aT + k * kLds + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(bT + k * kLds + tx * 4);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // b2m is written
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < nb) {
        const float bm = b2m[tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          top2_push(best[i], __fsub_rn(bm, __fmul_rn(2.f, acc[i][j])), c);
      }
    }
  }

  // Merge the 16 column groups of each row (lanes that differ in tx).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ym1 = __shfl_xor_sync(0xffffffffu, best[i].m1, off);
      const float ym2 = __shfl_xor_sync(0xffffffffu, best[i].m2, off);
      const int yi = __shfl_xor_sync(0xffffffffu, best[i].i1, off);
      top2_merge(best[i], ym1, ym2, yi);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r < na) {
        const size_t o = (size_t)pair * na + r;
        const float s = a2[ty * 4 + i];
        d1[o] = __fadd_rn(best[i].m1, s);
        d2[o] = __fadd_rn(best[i].m2, s);
        i1[o] = best[i].i1;
      }
    }
  }
}

}  // namespace

// da (P, Na, 128) f32, db (P, Nb, 128) f32, mask_b (P, Nb) bool (one byte
// each), all contiguous and 16-byte aligned; outputs (P, Na).  Launches on
// `stream` and returns the CUDA error code of the launch (0 = success).
extern "C" int tpusfm_topk2_match(const float* da, const float* db, const uint8_t* mask_b,
                                  float* d1, float* d2, int* i1, int P, int na, int nb,
                                  cudaStream_t stream) {
  if (P <= 0 || na <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(topk2_match_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((na + kTile - 1) / kTile, P);
  topk2_match_kernel<<<grid, kThreads, kSmemBytes, stream>>>(da, db, mask_b, d1, d2, i1, na, nb);
  return (int)cudaGetLastError();
}

extern "C" const char* tpusfm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
