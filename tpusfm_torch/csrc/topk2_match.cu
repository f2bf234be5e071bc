// Fused descriptor distance + running top-2 (kernel K1 of the port).
//
// Replaces the TPU kernel `_match_kernel` of tpusfm/ops/pallas_match.py
// (wrapper `match_topk2`, pallas_match.py:134).  For every row a of A and
// every pair of a batch it returns
//     d1 = min_b (b2m_b - 2 a.b) + |a|^2,  d2 = second smallest (duplicates
//     count),  i1 = argmin (lowest B index on ties),
// where b2m_b = |b|^2 for an unmasked B row and the 3.4e38 sentinel of
// pallas_match.py:51 for a masked one.  The (Na, Nb) distance matrix never
// reaches device memory.  Two variants, as the reference's `quantized`:
//
// quantized (topk2_match_bf16_kernel, the main path's): the product a.b
// of A and B rounded to bf16 (round to nearest even), |a|^2 summed in f32
// from the rounded A, |b|^2 from the unrounded f32 B (pallas_match.py:75,
// :146-150).  SIFT descriptors lie on the u8 grid, which bf16 holds
// exactly, and every partial sum is then an integer below 2^24, so the
// result is exact in any summation order: bit-equal to the plain twin and
// to the f32 variant.  What bounds it: 2*Na*Nb*128 operations at the bf16
// tensor-core rate take less time than reading the f32 inputs once
// (192 x 1024 x 1024: 0.052 ms of operations, 0.061 ms of bytes), so it
// is bound by bytes, provided the products run on the tensor cores and the
// top-2 fold on the CUDA cores keeps pace with them.  Design: a block of
// 512 threads (four warpgroups) takes 256 A rows of one pair, so each B
// row is read Na/256 times.  Its f32 inputs stream through shared memory
// as pieces of 64 rows (a quarter of the A block or a B tile: a piece's
// rows are contiguous), each one bulk copy (one-dimensional TMA)
// completing on an mbarrier, four in flight.  All threads convert a landed
// piece to bf16, eight lanes a row (the row's sum of squares by a
// three-step shuffle tree), into the 128-byte-swizzled K-major layout that
// wgmma reads: the A block once, after which each warp keeps its 16 rows
// of all eight k-steps in registers (ldmatrix), and each B tile into one of
// two buffers.  Step t: every warpgroup issues the eight wgmma m64n64k16 of
// tile t (A from registers, B from shared memory by descriptor, f32
// accumulators in registers); tile t+1 is converted while they run; after
// the wait the fold reads the accumulator fragments in registers: each
// thread keeps a running (m1, m2, i1) for its two rows over its columns in
// increasing order, and the four lanes that share a row merge at the end.
// Columns past Nb get b2m = +inf and zero values, which the fold never
// takes.  No MMA is in flight across a step's end and no accumulator is
// touched between an MMA's issue and its wait: otherwise ptxas serializes
// the wgmmas (C7514).
//
// f32 (topk2_match_kernel, for float descriptors, not on the main path):
// about 2*Na*Nb*128 FLOPs against (Na + Nb)*512 bytes per pair (some 512
// FLOPs per byte at 1024 x 1024), so it is compute-bound on the CUDA
// cores.  Design: a grid of (A tiles of 64 rows) x pairs; the A tile stays
// in shared memory (transposed, so each thread reads its four rows as one
// float4), B tiles of 64 rows stream through shared memory; a 256-thread
// block computes the 64 x 64 distance tile as 4 x 4 fp32 FMA micro-tiles
// and folds each thread's 4 columns into a running (m1, m2, i1) per row in
// registers; 16 lanes then merge with the combine rule of
// pallas_match.py:89-95, breaking exact ties by B index.  On the u8 grid it
// too is exact and bit-equal to its twin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ba_common.cuh"  // DeviceScope

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

// ---------------------------------------------------------------------------
// The quantized variant: bf16 products on the tensor cores (wgmma).

constexpr int kThreadsQ = 512;              // four warpgroups
constexpr int kRowsA = 256;                 // A rows per block: 64 per warpgroup
constexpr int kTileB = 64;                  // B rows per streamed tile: the MMA's N
constexpr int kHalfA = kRowsA * 128;        // bytes of one 64-wide K half of the A block
constexpr int kHalfB = kTileB * 128;        // bytes of one K half of a bf16 B tile
constexpr int kBufB = 2 * kHalfB;           // bytes of one bf16 B buffer
constexpr int kBufsB = 2;                   // bf16 B buffers
constexpr int kB2m = 2;                     // rows of b2m (a tile's |b|^2 or sentinel)
constexpr int kPiece = 64;                  // f32 rows of a piece: a B tile, a quarter of A
constexpr int kRawB = kPiece * kD * 4;      // bytes of one raw slot
constexpr int kRawSlots = 4;                // f32 pieces in flight
constexpr int kPiecesA = kRowsA / kPiece;
constexpr size_t kSmemQ = 1024 /* alignment slack */ + 2 * kHalfA + kBufsB * kBufB +
                          kRawSlots * kRawB + (kB2m * kTileB + kRowsA) * sizeof(float) +
                          kRawSlots * sizeof(uint64_t);
static_assert(kSmemQ <= 232448, "more shared memory than a block may have");
static_assert(kPiece * 8 == kThreadsQ, "a piece is converted by 8 lanes a row");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `r` in a K half of
// 128-byte rows, swizzled as wgmma's 128-byte mode reads it: the chunk index
// XORed with the row's position in its 8-row atom (atoms 1024-aligned).
__device__ __forceinline__ int swizzled(int r, int chunk) {
  return r * 128 + ((chunk ^ (r & 7)) << 4);
}

// Shared-memory matrix descriptor of a K-major bf16 operand in the 128-byte
// swizzled layout: start address >> 4 (bits 0-13), leading byte offset 16
// (unused in this mode, bits 16-29), 1024 bytes between 8-row atoms (bits
// 32-45), layout type 1 = 128-byte swizzle (bits 62-63).  A k-step of 16
// values starts 32 bytes further along the same rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x 64, f32, in registers) += A (64 x 16) B (64 x 16)^T: A bf16 from
// registers (per warp of the warpgroup a 16 x 16 slice in mma.m16n8k16's
// A layout, as ldmatrix.x4 loads it), B bf16 K-major in shared memory by
// descriptor; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_64x64x16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t saddr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMA's issue and wait: applied before the issue and after
// the wait, never in between (ptxas then serializes the MMAs).
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's generic-proxy shared stores before the async proxy's
// (wgmma's, the bulk copies') accesses that follow the next barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A bulk copy (one-dimensional TMA) of `bytes` from global to shared memory
// that completes on the mbarrier at `mbar`; one thread issues it.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t mbar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(mbar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float sumsq4(const float4& x) {
  return fmaf(x.w, x.w, fmaf(x.z, x.z, fmaf(x.y, x.y, x.x * x.x)));
}

// Where float4 f (values k = 4f .. 4f+3) of row r goes in a bf16 block of
// two K halves of `half` bytes each.
__device__ __forceinline__ int f4_slot(int r, int f, int half) {
  return (f >> 4) * half + swizzled(r, (f >> 1) & 7) + (f & 1) * 8;
}

// The fold of one value: the branch-free form of top2_push (same result,
// columns in increasing order).  v = b2m - 2 acc rounded once, as
// __fsub_rn(b2m, __fmul_rn(2, acc)): 2 acc is exact.
__device__ __forceinline__ void fold(Top2& t, float acc, float bm, int j) {
  const float v = fmaf(-2.f, acc, bm);
  t.i1 = v < t.m1 ? j : t.i1;
  t.m2 = fminf(t.m2, fmaxf(t.m1, v));
  t.m1 = fminf(t.m1, v);
}

__global__ void __launch_bounds__(kThreadsQ, 1)
topk2_match_bf16_kernel(const float* __restrict__ da, const float* __restrict__ db,
                        const uint8_t* __restrict__ mask_b, float* __restrict__ d1,
                        float* __restrict__ d2, int* __restrict__ i1, int na, int nb) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sA = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // [2][256][128 B]
  uint8_t* sB = sA + 2 * kHalfA;                             // [2 buffers][2][64 rows][128 B]
  const float* raw = reinterpret_cast<const float*>(sB + kBufsB * kBufB);  // [4][64][128] f32
  float* b2m = reinterpret_cast<float*>(sB + kBufsB * kBufB + kRawSlots * kRawB);  // [2][64]
  float* a2 = b2m + kB2m * kTileB;                           // [256]
  uint64_t* mbar = reinterpret_cast<uint64_t*>(a2 + kRowsA);  // [4], one per raw slot

  const int pair = blockIdx.y;
  const int row0 = blockIdx.x * kRowsA;
  const float* A = da + ((size_t)pair * na + row0) * kD;
  const float* B = db + (size_t)pair * nb * kD;
  const uint8_t* M = mask_b + (size_t)pair * nb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nt = (nb + kTileB - 1) / kTileB;
  const int prow = threadIdx.x >> 3;        // the row of a piece this thread converts
  const int part = threadIdx.x & 7;         // and its float4s part, part + 8, ...

  // One stream of f32 pieces of 64 rows through the four raw slots: pieces
  // g = 0..3 are the A block's quarters, g = 4 + k is B tile k.  Piece g
  // takes slot g % 4 in its (g / 4)-th use (phase parity (g / 4) % 2).  One
  // thread issues each piece as one bulk copy of its rows; a quarter of A
  // past na copies one row it does not read, so that every slot's phases
  // follow the stream.
  auto issue_piece = [&](int g) {
    const bool a = g < kPiecesA;
    const float* src = a ? A + (size_t)g * kPiece * kD : B + (size_t)(g - kPiecesA) * kTileB * kD;
    const int left = a ? na - row0 - g * kPiece : nb - (g - kPiecesA) * kTileB;
    bulk_load(smem_u32(raw) + (g % kRawSlots) * kRawB, left > 0 ? src : A,
              (left > 0 ? min(kPiece, left) : 1) * kD * sizeof(float),
              smem_u32(mbar + g % kRawSlots));
  };
  // Waits for piece g; this thread's row of it (zero past `valid` rows) to
  // bf16 at `dst` (a block of two K halves of `half` bytes, row `dst_row`),
  // and returns the row's sum of squares, of the values rounded to bf16
  // first when `round`: eight lanes a row, a three-step shuffle tree.
  auto convert_row = [&](int g, int valid, bool round, uint8_t* dst, int half, int dst_row) {
    mbar_wait(smem_u32(mbar + g % kRawSlots), (g / kRawSlots) & 1);
    const float* src = raw + (g % kRawSlots) * kPiece * kD + prow * kD;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = 8 * i + part;
      const float4 x = prow < valid ? *reinterpret_cast<const float4*>(src + 4 * f)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      const uint2 p = make_uint2(bf16x2(x.x, x.y), bf16x2(x.z, x.w));
      *reinterpret_cast<uint2*>(dst + f4_slot(dst_row, f, half)) = p;
      float4 y = x;
      if (round) {
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.y));
        y = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      s += sumsq4(y);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    return s;
  };
  // A quarter of the A block to bf16, and |a|^2 of the rounded values.
  auto convert_a = [&](int g) {
    const int r = g * kPiece + prow;
    const float s = convert_row(g, na - row0 - g * kPiece, true, sA, kHalfA, r);
    if (part == 0) a2[r] = s;
  };
  // B tile k to bf16 buffer k % 2 and b2m row k % 2: |b|^2 of the unrounded
  // values, the sentinel where masked, +inf (and zeros) past nb.  `mask` is
  // the mask byte of this thread's row (read by part 0).
  auto convert_b = [&](int k, uint32_t mask) {
    const int left = nb - k * kTileB;
    const float s = convert_row(kPiecesA + k, left, false, sB + (k % kBufsB) * kBufB, kHalfB, prow);
    if (part == 0)
      b2m[(k % kB2m) * kTileB + prow] = prow >= left ? __int_as_float(0x7f800000)
                                        : mask ? s : kSentinel;
  };
  auto load_mask = [&](int k) -> uint32_t {
    const int c = k * kTileB + prow;
    return part == 0 && k < nt && c < nb ? __ldg(M + c) : 0u;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRawSlots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(mbar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int g = 0; g < kPiecesA; ++g) issue_piece(g);
  const uint32_t mask0 = load_mask(0);
  // Each quarter of A frees its slot for the B tile of the same number.
#pragma unroll 1
  for (int g = 0; g < kPiecesA; ++g) {
    convert_a(g);
    __syncthreads();
    if (threadIdx.x == 0 && g < nt) issue_piece(kPiecesA + g);
  }
  convert_b(0, mask0);
  fence_async_smem();
  __syncthreads();  // the A block and B tile 0 are visible to ldmatrix and wgmma
  if (threadIdx.x == 0 && kRawSlots < nt) issue_piece(kPiecesA + kRawSlots);

  const int wg = warp >> 2;                 // warpgroup: A rows wg*64 .. wg*64+63
  const int q = lane & 3;                   // columns 8j + 2q, 8j + 2q + 1 of a tile
  const uint32_t b_base = smem_u32(sB);
  // This warp's 16 A rows as wgmma's register operand, all eight k-steps:
  // lane l gives ldmatrix the address of row l % 16, k-chunk 2s + l / 16.
  uint32_t afrag[kD / 16][4];
#pragma unroll
  for (int s = 0; s < kD / 16; ++s) {
    const int c = 2 * s + (lane >> 4);
    ldmatrix_x4(afrag[s], smem_u32(sA) + (c >> 3) * kHalfA +
                              swizzled(wg * 64 + (warp & 3) * 16 + (lane & 15), c & 7));
  }
  Top2 lo = {kSentinel, kSentinel, 0}, hi = lo;  // rows lane/4 and lane/4 + 8 of the warp's 16
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // Step t: tile t's MMAs go out; tile t+1 is converted while they run;
  // they are awaited and tile t is folded from the accumulator; then the
  // raw slot tile t+1 left is refilled.
  for (int t = 0; t < nt; ++t) {
    const uint32_t mask = load_mask(t + 1);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kD / 16; ++s) {
      const uint32_t offb = (t % kBufsB) * kBufB + (s >> 2) * kHalfB + (s & 3) * 32;
      wgmma_64x64x16_rs(acc, afrag[s], sw128_desc(b_base + offb), s > 0);
    }
    wgmma_commit();
    if (t + 1 < nt) convert_b(t + 1, mask);
    wgmma_wait<0>();
    pin(acc);
    const float* bm = b2m + (t % kB2m) * kTileB + 2 * q;
    const int cq = t * kTileB + 2 * q;
#pragma unroll
    for (int j = 0; j < kTileB / 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(bm + 8 * j);
      fold(lo, acc[4 * j + 0], b.x, cq + 8 * j);
      fold(lo, acc[4 * j + 1], b.y, cq + 8 * j + 1);
      fold(hi, acc[4 * j + 2], b.x, cq + 8 * j);
      fold(hi, acc[4 * j + 3], b.y, cq + 8 * j + 1);
    }
    fence_async_smem();
    __syncthreads();  // tile t+1 is visible; bf16 buffer t % 2 and tile t+1's raw slot are free
    if (threadIdx.x == 0 && t + 1 + kRawSlots < nt) issue_piece(kPiecesA + t + 1 + kRawSlots);
  }

  // Merge the four lanes that share a row, then write the rows.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    top2_merge(lo, __shfl_xor_sync(0xffffffffu, lo.m1, off),
               __shfl_xor_sync(0xffffffffu, lo.m2, off), __shfl_xor_sync(0xffffffffu, lo.i1, off));
    top2_merge(hi, __shfl_xor_sync(0xffffffffu, hi.m1, off),
               __shfl_xor_sync(0xffffffffu, hi.m2, off), __shfl_xor_sync(0xffffffffu, hi.i1, off));
  }
  if (q == 0) {
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Top2& b = h ? hi : lo;
      const int rr = r + 8 * h;
      if (row0 + rr < na) {
        const size_t o = (size_t)pair * na + row0 + rr;
        d1[o] = __fadd_rn(b.m1, a2[rr]);
        d2[o] = __fadd_rn(b.m2, a2[rr]);
        i1[o] = b.i1;
      }
    }
  }
}

}  // namespace

// da (P, Na, 128) f32, db (P, Nb, 128) f32, mask_b (P, Nb) bool (one byte
// each), all contiguous, 16-byte aligned and on device `device`; outputs
// (P, Na).  quantized != 0 takes the bf16 tensor-core kernel, 0 the f32 one;
// batches of more than 65,535 pairs go out in several launches.  Launches on
// `stream` and returns the CUDA error code of the launch (0 = success).
extern "C" int tpusfm_topk2_match(int device, const float* da, const float* db,
                                  const uint8_t* mask_b, float* d1, float* d2, int* i1, int P,
                                  int na, int nb, int quantized, cudaStream_t stream) {
  if (P <= 0 || na <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  tpusfm_ba::DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const void* kernel = quantized ? (const void*)topk2_match_bf16_kernel
                                 : (const void*)topk2_match_kernel;
  const size_t smem = quantized ? kSmemQ : kSmemBytes;
  const int rows = quantized ? kRowsA : kTile;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kMaxPairs = 65535;  // gridDim.y
  for (int p0 = 0; p0 < P; p0 += kMaxPairs) {
    const dim3 grid((na + rows - 1) / rows, P - p0 < kMaxPairs ? P - p0 : kMaxPairs);
    const size_t a = (size_t)p0 * na, b = (size_t)p0 * nb;
    if (quantized)
      topk2_match_bf16_kernel<<<grid, kThreadsQ, smem, stream>>>(da + a * kD, db + b * kD,
                                                                mask_b + b, d1 + a, d2 + a, i1 + a,
                                                                na, nb);
    else
      topk2_match_kernel<<<grid, kThreads, smem, stream>>>(da + a * kD, db + b * kD, mask_b + b,
                                                           d1 + a, d2 + a, i1 + a, na, nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

extern "C" const char* tpusfm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
