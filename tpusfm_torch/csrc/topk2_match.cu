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
// f32 (topk2_match_tf32_kernel, for float descriptors, not on the main
// path): the product a.b of the unrounded f32 values, |a|^2 and |b|^2 of
// them too.  On the CUDA cores 2*Na*Nb*128 FLOPs at 67 TFLOP/s bound it at
// 0.769 ms at 192 x 1024 x 1024; the tensor cores take f32 operands only
// as TF32 (a 10-bit mantissa), so each value is split into two TF32 parts,
// hi = rna(x) and lo = rna(x - hi) (x - hi is exact), and a.b is taken as
// the three products hi.lo + lo.hi + hi.hi, each a wgmma .tf32; the one
// left out, lo.lo, and lo's own rounding are below 2^-22 |x| |y| a term,
// under the f32 sum's own error.  Three TF32 products at 495 TFLOP/s bound
// it at 0.312 ms (bytes: 0.060 ms), so it is bound by operations.  On the
// u8 grid every value is exact in TF32, lo = 0 and every partial sum is an
// integer below 2^24, so it too is bit-equal to its twin.  Design, PR 8's
// machinery: a block of 256 threads (two warpgroups) takes 128 A rows of
// one pair; each warp loads its 16 A rows straight from device memory into
// the TF32 register operand of wgmma, hi and lo of all sixteen k-steps
// (128 registers a thread), with |a|^2 of the f32 values from the same
// loads (four lanes a row, a two-step shuffle tree).  B tiles of 64 rows
// stream through three raw f32 slots by bulk copy, and each warpgroup
// converts its 32 rows of a landed tile into hi and lo parts, each 64 rows
// x 512 bytes in the 128-byte-swizzled K-major layout (four 32-value K
// blocks), in one of two buffers, with b2m from the unrounded values; the
// rounding is two integer operations (add 0x1000, clear the low 13 bits),
// which the card runs faster than cvt.rna.tf32 (tools/k1_probe.py).
// Shared memory bounds the layout: two B buffers of 64 KB (hi and lo) and
// three raw slots of 32 KB take 224 of the 227 KB a block may have, so A
// stays in registers and a block has two warpgroups.  Each warpgroup issues
// the 48 wgmma m64n64k8 of a tile into one f32 accumulator, the small
// products first (hi.lo and lo.hi for all 16 k-steps, then hi.hi), so that
// they are summed while the accumulator is still small; converts its half
// of the next tile while they run; then folds the accumulator as the bf16
// kernel does.  The warpgroups meet only at mbarriers (a buffer is full
// when both halves are converted, empty when both warpgroups' MMAs on it
// are done), so one folds while the other's MMAs run, and the fold costs
// no time (k1_probe's "no fold" build).  Two accumulators in one
// warpgroup instead ran out of registers, spilled, and ptxas serialized
// the wgmmas (C7515).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ba_common.cuh"  // DeviceScope

namespace {

constexpr int kD = 128;          // descriptor width
constexpr float kSentinel = 3.4e38f;

struct Top2 {
  float m1, m2;
  int i1;
};

__device__ __forceinline__ void top2_merge(Top2& x, float ym1, float ym2, int yi) {
  const float m1 = fminf(x.m1, ym1);
  const float m2 = fminf(fmaxf(x.m1, ym1), fminf(x.m2, ym2));
  const bool take_y = (ym1 < x.m1) || (ym1 == x.m1 && yi < x.i1);
  x.m1 = m1;
  x.m2 = m2;
  x.i1 = take_y ? yi : x.i1;
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

// The fold of one value of column j into a running (m1, m2, i1), columns
// in increasing order: a tie with m1 keeps the earlier index and lowers m2
// (duplicates count for d2).  v = b2m - 2 acc rounded once, as
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

// ---------------------------------------------------------------------------
// The f32 variant: three TF32 products on the tensor cores (wgmma .tf32).

constexpr int kThreadsF = 256;              // two warpgroups
constexpr int kRowsAF = 128;                // A rows per block: 64 per warpgroup
constexpr int kKBlockF = kTileB * 128;      // bytes of one 32-value K block of a TF32 B part
constexpr int kPartF = (kD / 32) * kKBlockF;  // bytes of one part (hi or lo) of a B tile
constexpr int kBufF = 2 * kPartF;           // bytes of one B buffer: hi, then lo
constexpr int kBufsF = 2;                   // B buffers
constexpr int kRawSlotsF = 3;               // f32 B tiles in flight
constexpr int kB2mF = 3;                    // rows of b2m: tiles t, t+1 and t+2 are live
constexpr size_t kSmemF = 1024 /* alignment slack */ + kBufsF * kBufF + kRawSlotsF * kRawB +
                          kB2mF * kTileB * sizeof(float) +
                          (kRawSlotsF + 2 * kBufsF) * sizeof(uint64_t);
static_assert(kSmemF <= 232448, "more shared memory than a block may have");
static_assert(kTileB * 8 == 2 * kThreadsF, "a warpgroup converts 32 rows, 8 lanes a row, twice");

// x rounded to TF32, to nearest with ties away from zero, as cvt.rna.tf32
// rounds a finite value: 0x1000 added to the bit pattern and the low 13
// bits cleared.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (a residual below 2^-22 |x|), both parts TF32.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));  // x - hi is exact in f32
}

// D (64 x 64, f32, in registers) += A (64 x 8) B (64 x 8)^T in TF32: A from
// registers (per warp of the warpgroup a 16 x 8 slice, mma.m16n8k8's A
// layout: a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4) for
// g = lane / 4, q = lane % 4), B K-major in shared memory by descriptor;
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_64x64x8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void mbar_arrive(uint32_t mbar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mbar) : "memory");
}

__global__ void __launch_bounds__(kThreadsF, 1)
topk2_match_tf32_kernel(const float* __restrict__ da, const float* __restrict__ db,
                        const uint8_t* __restrict__ mask_b, float* __restrict__ d1,
                        float* __restrict__ d2, int* __restrict__ i1, int na, int nb) {
  extern __shared__ uint8_t smem_raw[];
  // [2 buffers][hi, lo][4 K blocks][64 rows][128 B]
  uint8_t* sB = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const float* raw = reinterpret_cast<const float*>(sB + kBufsF * kBufF);  // [3][64][128] f32
  float* b2m = reinterpret_cast<float*>(sB + kBufsF * kBufF + kRawSlotsF * kRawB);  // [3][64]
  // [3] per raw slot (the bulk copy landed), [2] per buffer full (both
  // halves converted), [2] per buffer empty (both warpgroups' MMAs done)
  uint64_t* mbar = reinterpret_cast<uint64_t*>(b2m + kB2mF * kTileB);
  const uint32_t full0 = smem_u32(mbar + kRawSlotsF), empty0 = full0 + 8 * kBufsF;

  const int pair = blockIdx.y;
  const int row0 = blockIdx.x * kRowsAF;
  const float* B = db + (size_t)pair * nb * kD;
  const uint8_t* M = mask_b + (size_t)pair * nb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;           // warpgroup: A rows wg*64 .. wg*64+63, B rows wg*32 ..
  const int nt = (nb + kTileB - 1) / kTileB;
  const int prow = 32 * wg + ((threadIdx.x & 127) >> 3);  // rows prow, prow + 16 converted here
  const int part = threadIdx.x & 7;   // and their float4s part, part + 8, ...

  // B tile k takes raw slot k % 3 in its (k / 3)-th use (phase parity
  // (k / 3) % 2); one thread issues it as one bulk copy of its rows.
  auto issue_tile = [&](int k) {
    const int left = nb - k * kTileB;
    bulk_load(smem_u32(raw) + (k % kRawSlotsF) * kRawB, B + (size_t)k * kTileB * kD,
              min(kTileB, left) * kD * sizeof(float), smem_u32(mbar + k % kRawSlotsF));
  };
  // Waits for tile k and converts this warpgroup's 32 rows of it into B
  // buffer k % 2 (hi and lo parts, zero rows past nb) and b2m row k % 3:
  // |b|^2 of the f32 values, the sentinel where masked, +inf past nb; then
  // arrives on the buffer's full barrier.
  auto convert_tile = [&](int k) {
    uint32_t mask[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = k * kTileB + prow + 16 * h;
      mask[h] = part == 0 && c < nb ? __ldg(M + c) : 0u;
    }
    mbar_wait(smem_u32(mbar + k % kRawSlotsF), (k / kRawSlotsF) & 1);
    const int left = nb - k * kTileB;
    const float* src = raw + (k % kRawSlotsF) * kTileB * kD;
    uint8_t* dst = sB + (k % kBufsF) * kBufF;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = prow + 16 * h;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kD / 32; ++i) {  // float4 8i + part: K block i, chunk part
        const float4 x = r < left
                             ? *reinterpret_cast<const float4*>(src + r * kD + 4 * (8 * i + part))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        uint4 hi, lo;
        tf32_split(x.x, hi.x, lo.x);
        tf32_split(x.y, hi.y, lo.y);
        tf32_split(x.z, hi.z, lo.z);
        tf32_split(x.w, hi.w, lo.w);
        const int off = i * kKBlockF + swizzled(r, part);
        *reinterpret_cast<uint4*>(dst + off) = hi;
        *reinterpret_cast<uint4*>(dst + kPartF + off) = lo;
        s += sumsq4(x);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (part == 0)
        b2m[(k % kB2mF) * kTileB + r] = r >= left ? __int_as_float(0x7f800000)
                                        : mask[h] ? s : kSentinel;
    }
    fence_async_smem();  // the stores before wgmma's reads
    mbar_arrive(full0 + 8 * (k % kBufsF));
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRawSlotsF; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(mbar + s)) : "memory");
    for (int b = 0; b < 2 * kBufsF; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(full0 + 8 * b),
                   "r"(kThreadsF)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < kRawSlotsF && k < nt; ++k) issue_tile(k);

  // This warp's 16 A rows as wgmma's TF32 register operand, hi and lo of
  // all sixteen k-steps: rows g and g + 8 (g = lane / 4), values
  // k = 8s + q and 8s + q + 4 (q = lane % 4), straight from device memory
  // (zero past na); |a|^2 of the f32 values over the row's four lanes.
  const int g = lane >> 2, q = lane & 3;
  const int ra = row0 + wg * 64 + (warp & 3) * 16 + g;  // this thread's first A row
  uint32_t ahi[kD / 8][4], alo[kD / 8][4];
  float a2lo = 0.f, a2hi = 0.f;             // |a|^2 of rows ra and ra + 8
  {
    const float* A0 = da + ((size_t)pair * na + ra) * kD + q;
    const float* A1 = A0 + 8 * kD;
    const bool v0 = ra < na, v1 = ra + 8 < na;
#pragma unroll
    for (int s = 0; s < kD / 8; ++s) {
      const float x[4] = {v0 ? __ldg(A0 + 8 * s) : 0.f, v1 ? __ldg(A1 + 8 * s) : 0.f,
                          v0 ? __ldg(A0 + 8 * s + 4) : 0.f, v1 ? __ldg(A1 + 8 * s + 4) : 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) tf32_split(x[i], ahi[s][i], alo[s][i]);
      a2lo = fmaf(x[2], x[2], fmaf(x[0], x[0], a2lo));
      a2hi = fmaf(x[3], x[3], fmaf(x[1], x[1], a2hi));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      a2lo += __shfl_xor_sync(0xffffffffu, a2lo, off);
      a2hi += __shfl_xor_sync(0xffffffffu, a2hi, off);
    }
  }
  convert_tile(0);

  const uint32_t b_base = smem_u32(sB);
  Top2 lo = {kSentinel, kSentinel, 0}, hi = lo;  // rows g and g + 8 of the warp's 16
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // Step t of a warpgroup: once both halves of tile t are in their buffer,
  // its 48 MMAs go out (hi.lo, lo.hi, then hi.hi); once both warpgroups'
  // MMAs of tile t-1 are done, this warpgroup's half of tile t+1 is
  // converted into their buffer while its MMAs run; they are awaited, the
  // buffer's empty barrier is arrived on and tile t is folded from the
  // accumulator.  The warpgroups keep no step in common, so one folds while
  // the other's MMAs run.  Thread 0 refills the raw slot of tile t once
  // both halves of it are converted.
  for (int t = 0; t < nt; ++t) {
    const int b = t % kBufsF;
    mbar_wait(full0 + 8 * b, (t / kBufsF) & 1);
    if (threadIdx.x == 0 && t + kRawSlotsF < nt) issue_tile(t + kRawSlotsF);
    const uint32_t buf = b_base + b * kBufF;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kD / 8; ++s)
      wgmma_64x64x8_tf32_rs(acc, ahi[s],
                            sw128_desc(buf + kPartF + (s >> 2) * kKBlockF + (s & 3) * 32), s > 0);
#pragma unroll
    for (int s = 0; s < kD / 8; ++s)
      wgmma_64x64x8_tf32_rs(acc, alo[s], sw128_desc(buf + (s >> 2) * kKBlockF + (s & 3) * 32), 1);
#pragma unroll
    for (int s = 0; s < kD / 8; ++s)
      wgmma_64x64x8_tf32_rs(acc, ahi[s], sw128_desc(buf + (s >> 2) * kKBlockF + (s & 3) * 32), 1);
    wgmma_commit();
    if (t + 1 < nt) {
      if (t > 0) mbar_wait(empty0 + 8 * (1 - b), ((t - 1) / kBufsF) & 1);
      convert_tile(t + 1);
    }
    wgmma_wait<0>();
    pin(acc);
    mbar_arrive(empty0 + 8 * b);
    const float* bm = b2m + (t % kB2mF) * kTileB + 2 * q;
    const int cq = t * kTileB + 2 * q;
#pragma unroll
    for (int j = 0; j < kTileB / 8; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(bm + 8 * j);
      fold(lo, acc[4 * j + 0], bv.x, cq + 8 * j);
      fold(lo, acc[4 * j + 1], bv.y, cq + 8 * j + 1);
      fold(hi, acc[4 * j + 2], bv.x, cq + 8 * j);
      fold(hi, acc[4 * j + 3], bv.y, cq + 8 * j + 1);
    }
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
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      if (r < na) {
        const Top2& bt = h ? hi : lo;
        const size_t o = (size_t)pair * na + r;
        d1[o] = __fadd_rn(bt.m1, h ? a2hi : a2lo);
        d2[o] = __fadd_rn(bt.m2, h ? a2hi : a2lo);
        i1[o] = bt.i1;
      }
    }
  }
}

}  // namespace

// da (P, Na, 128) f32, db (P, Nb, 128) f32, mask_b (P, Nb) bool (one byte
// each), all contiguous, 16-byte aligned and on device `device`; outputs
// (P, Na).  quantized != 0 takes the bf16 kernel, 0 the f32 (three TF32
// products) one; batches of more than 65,535 pairs go out in several
// launches.  Launches on `stream` and returns the CUDA error code of the
// launch (0 = success).
extern "C" int tpusfm_topk2_match(int device, const float* da, const float* db,
                                  const uint8_t* mask_b, float* d1, float* d2, int* i1, int P,
                                  int na, int nb, int quantized, cudaStream_t stream) {
  if (P <= 0 || na <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  tpusfm_ba::DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const void* kernel = quantized ? (const void*)topk2_match_bf16_kernel
                                 : (const void*)topk2_match_tf32_kernel;
  const size_t smem = quantized ? kSmemQ : kSmemF;
  const int rows = quantized ? kRowsA : kRowsAF;
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
      topk2_match_tf32_kernel<<<grid, kThreadsF, smem, stream>>>(da + a * kD, db + b * kD,
                                                                mask_b + b, d1 + a, d2 + a, i1 + a,
                                                                na, nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

extern "C" const char* tpusfm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
