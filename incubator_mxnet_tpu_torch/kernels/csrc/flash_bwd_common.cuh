// Pieces shared by the two FlashAttention-2 backward kernels, K6 flash_bwd_dq
// (query-parallel) and K7 flash_bwd_dkv (key-parallel).
//
// Both recompute a 64 x 64 tile of P = exp(S - lse) and of
// dS = P * (dP - dd) from the forward's logsumexp ``lse`` and
// dd = rowsum(dO * O) (minus the lse cotangent), both (B*H, T) fp32, as
// _bwd_dq_kernel and _bwd_dkv_kernel do.  Masking follows the forward
// (K1): keys past T or past the causal diagonal, and query rows past T,
// weigh exactly 0; the key bias is added as is (-1e30 for a masked key),
// in the order the plain version adds it, so a row whose every key is
// masked (lse == -1e30) gets P = 1 per key as in _flash_bwd_impl.
//
// fp32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel).  A block of 4 warps
// holds the tiles it reads in shared memory (rows padded by 16 bytes, so
// every fragment read below is free of bank conflicts); each warp owns 16
// rows of the tile (query rows in K6, keys in K7) and keeps its score,
// dP, P and dS fragments in registers.  Every product runs as 3xTF32
// mma.sync (tf32_mma.cuh).
//
// bf16, fp16 (flash_bwd_dq16_kernel, flash_bwd_dkv16_kernel).  Every
// product runs on wgmma (hopper_16.cuh) with only exact 16-bit products:
// the score-shaped products (S and dP, or their transposes) take the
// unscaled 16-bit inputs and sum in fp32; P and dS are formed in fp32 in
// the score's registers and go into their products (dS K, P^T dO, dS^T
// Q) in two 16-bit parts, hi = E(x) and lo = E(x - hi), each a wgmma with
// A from registers, summed in fp32.  fp16 has 5 exponent bits: at small
// gradients dS falls into fp16's subnormals and loses its low part, and
// at long rows so does P (T = 1024, dO ~ 1e-5: 51 % of dq off the plain
// rounding in a CPU model).  So the fp16 instances scale P, which is at
// most 1, by 2^14 before its split, and each row of dS by a power of two
// chosen per tile so that the row's largest magnitude so far lands in
// [2^14, 2^15), rescaling the row's fp32 accumulator when that power
// changes; the accumulators are divided by the scales at the end.  All of
// it is exact, as FlashAttention's rescaling of its running sums is.
// bf16 has fp32's exponent range and needs no scaling.
#pragma once

#include "hopper_16.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kTile = 64;                // query rows and keys per tile
constexpr int kWarps = 4;                // 16 rows of the tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = kTile / 8;           // 8-column n-tiles across a tile
static_assert(kTile == kTileRows && kThreads == kTileThreads,
              "load_tile copies one whole tile with the whole block");

// The two score-shaped products of a tile, for the warp's 16 rows:
//   c1[n] = A1 B1^T and c2[n] = A2 B2^T over the D columns,
// where A1, A2 are tiles whose rows r0 and r0 + 8 are this thread's
// fragment rows, and B1, B2 are 64-row tiles (row 8n + g is column g of
// n-tile n).  ``a1``/``a2`` point at row r0, column t of A; ``b1``/``b2``
// at row g, column t of B (row stride row_stride<D>()).  K6: (S, dP) =
// (Q K^T, dO V^T); K7: (S^T, dP^T) = (K Q^T, V dO^T).
template <int D>
__device__ __forceinline__ void tile_products(float (&c1)[kNT][4],
                                              float (&c2)[kNT][4],
                                              const float* a1,
                                              const float* b1,
                                              const float* a2,
                                              const float* b2) {
  constexpr int LD = row_stride<D>();
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[n][e] = c2[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const int c = ks * 8;
    const float x1[4] = {a1[c], a1[8 * LD + c], a1[c + 4],
                         a1[8 * LD + c + 4]};
    const float x2[4] = {a2[c], a2[8 * LD + c], a2[c + 4],
                         a2[8 * LD + c + 4]};
    const FragA f1(x1), f2(x2);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float* r1 = b1 + n * 8 * LD + c;
      const float* r2 = b2 + n * 8 * LD + c;
      const float y1[2] = {r1[0], r1[4]};
      const float y2[2] = {r2[0], r2[4]};
      mma_split(c1[n], f1, y1);
      mma_split(c2[n], f2, y2);
    }
  }
}

// acc[no] += C B over one 8-column step: the C fragment ``c`` of a
// product's n-tile (P, dS, or their transposes) read as the A fragment with
// its 8 columns permuted (tf32_mma.cuh), against the 8 rows of a tile it
// contracts with, read in the same order.  ``rows`` points at row 8n + 2t,
// column g of that tile (row stride row_stride<D>()).  K6: dQ += dS K;
// K7: dV += P^T dO and dK += dS^T Q.  Rows 2t and 2t + 1 of a padded tile
// hit distinct banks across the warp.
template <int D>
__device__ __forceinline__ void acc_product(float (&acc)[D / 8][4],
                                            const float (&c)[4],
                                            const float* rows) {
  constexpr int LD = row_stride<D>();
  const float x[4] = {c[0], c[2], c[1], c[3]};
  const FragA a(x);
#pragma unroll
  for (int no = 0; no < D / 8; ++no) {
    const float y[2] = {rows[no * 8], rows[LD + no * 8]};
    mma_split(acc[no], a, y);
  }
}

// P of one (query, key) pair from its raw score ``s`` (q . k, unscaled),
// the key's bias ``b`` and the query row's logsumexp: exp(s * scale + b -
// lse), summed in the plain version's order, as one ex2.approx.
__device__ __forceinline__ float prob(float s, float scale, float b,
                                      float lse) {
  return exp2_approx((fmaf(s, scale, b) - lse) * kLog2e);
}

// ------------------------------------------------- the 16-bit instances
constexpr int kStages16 = 2;     // depth of the streamed tile ring

// 2^e for e in [-126, 127]; 0 below
__device__ __forceinline__ float pow2i(int e) {
  return e < -126 ? 0.f : __int_as_float((e + 127) << 23);
}

// fp16: multiplies the two rows r of this thread's dS values ``x``
// (element 4n + e of row r = e >> 1, as in the accumulator layout) by
// 2^e[r] before their split.  e[r] starts at 126 and only falls: to the
// exponent that puts this tile's largest |x| of the row (over the quad
// that holds it) in [2^14, 2^15), where that is smaller; the accumulator
// rows, in units of 2^-e[r], are rescaled by the change (skipped where no
// row of the warp changed).
template <int NCB, int NB>
__device__ __forceinline__ void row_scale(float (&x)[32], int (&e)[2],
                                          float (&acc)[NCB][NB / 2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      m = fmaxf(m, fmaxf(fabsf(x[4 * n + 2 * r]),
                         fabsf(x[4 * n + 2 * r + 1])));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    // m = f 2^(em - 127), f in [1, 2): 2^(141 - em) m is in [2^14, 2^15)
    const int em = (__float_as_int(m) >> 23) & 0xff;
    const int en = m > 0.f ? min(e[r], min(126, 141 - em)) : e[r];
    if (__any_sync(0xffffffffu, en != e[r])) {
      const float f = pow2i(en - e[r]);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
        for (int n = 0; n < NB / 8; ++n) {
          acc[cb][4 * n + 2 * r] *= f;
          acc[cb][4 * n + 2 * r + 1] *= f;
        }
    }
    e[r] = en;
    const float c = pow2i(en);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      x[4 * n + 2 * r] *= c;
      x[4 * n + 2 * r + 1] *= c;
    }
  }
}

// acc += (hi + lo) B over the tile's four 16-row k-steps: B the 64-row
// tile at shared address ``b`` read MN-major, in column blocks of NB
template <int D, typename E, int NCB, int NB>
__device__ __forceinline__ void acc_products16(float (&acc)[NCB][NB / 2],
                                               const uint32_t (&hi)[4][4],
                                               const uint32_t (&lo)[4][4],
                                               uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      const uint64_t d = desc_mn_major<D>(b, kk, cb);
      wgmma_rs<E, NB>(acc[cb], hi[kk], d, 1);
      wgmma_rs<E, NB>(acc[cb], lo[kk], d, 1);
    }
  wgmma_commit();
}

// the wgmma registers of one product, held until its wait
template <int NCB, int NB>
__device__ __forceinline__ void fence_acc(float (&acc)[NCB][NB / 2],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(hi[kk]);
    fence_regs(lo[kk]);
  }
}

// c (64 x 64, f32) = A B^T over D / 16 k-steps, A and B the 64-row tiles
// at shared addresses ``a`` and ``b``, both read K-major; one commit group
template <int D, typename E>
__device__ __forceinline__ void score_product16(float (&c)[32], uint32_t a,
                                                uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss_n64<E>(c, desc_k_major<D>(a, ks), desc_k_major<D>(b, ks), ks);
  wgmma_commit();
}

}  // namespace
