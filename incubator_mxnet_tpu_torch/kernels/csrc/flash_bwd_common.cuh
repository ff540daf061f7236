// Pieces shared by the two FlashAttention-2 backward kernels, K6 flash_bwd_dq
// (query-parallel) and K7 flash_bwd_dkv (key-parallel).
//
// Both recompute a 64 x 64 tile of P = exp(S - lse) and of
// dS = P * (dP - dd) from the forward's logsumexp ``lse`` and
// dd = rowsum(dO * O) (minus the lse cotangent), both (B*H, T) fp32, as
// _bwd_dq_kernel and _bwd_dkv_kernel do.  A block of 4 warps holds the
// tiles it reads in shared memory, in the inputs' element type E (rows
// padded by 16 bytes, so every fragment read below is free of bank
// conflicts); each warp owns 16 rows of the tile (query rows in K6, keys
// in K7) and keeps its score, dP, P and dS fragments in registers.  Every
// product runs as 3xTF32 mma.sync (tf32_mma.cuh), but a product of two
// 16-bit tiles, exact in TF32, is one product and a product with one
// such tile two.  Masking follows the forward (K1): keys past T or past
// the causal diagonal, and query rows past T, weigh exactly 0; the key
// bias is added as is (-1e30 for a masked key), in the order the plain
// version adds it, so a row whose every key is masked (lse == -1e30) gets
// P = 1 per key as in _flash_bwd_impl.
#pragma once

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
// at row g, column t of B (row stride row_stride<D, E>()).  K6: (S, dP) =
// (Q K^T, dO V^T); K7: (S^T, dP^T) = (K Q^T, V dO^T).
template <int D, typename E>
__device__ __forceinline__ void tile_products(float (&c1)[kNT][4],
                                              float (&c2)[kNT][4],
                                              const E* a1, const E* b1,
                                              const E* a2, const E* b2) {
  constexpr int LD = row_stride<D, E>();
  constexpr bool kX = kExact<E>;
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[n][e] = c2[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const int c = ks * 8;
    const float x1[4] = {to_f(a1[c]), to_f(a1[8 * LD + c]), to_f(a1[c + 4]),
                         to_f(a1[8 * LD + c + 4])};
    const float x2[4] = {to_f(a2[c]), to_f(a2[8 * LD + c]), to_f(a2[c + 4]),
                         to_f(a2[8 * LD + c + 4])};
    const FragA f1(x1), f2(x2);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const E* r1 = b1 + n * 8 * LD + c;
      const E* r2 = b2 + n * 8 * LD + c;
      const float y1[2] = {to_f(r1[0]), to_f(r1[4])};
      const float y2[2] = {to_f(r2[0]), to_f(r2[4])};
      mma_split<kX, kX>(c1[n], f1, y1);
      mma_split<kX, kX>(c2[n], f2, y2);
    }
  }
}

// acc[no] += C B over one 8-column step: the C fragment ``c`` of a
// product's n-tile (P, dS, or their transposes) read as the A fragment with
// its 8 columns permuted (tf32_mma.cuh), against the 8 rows of a tile it
// contracts with, read in the same order.  ``rows`` points at row 8n + 2t,
// column g of that tile (row stride row_stride<D, E>()).  K6: dQ += dS K;
// K7: dV += P^T dO and dK += dS^T Q.  Rows 2t and 2t + 1 of a padded tile
// hit distinct banks across the warp.
template <int D, typename E>
__device__ __forceinline__ void acc_product(float (&acc)[D / 8][4],
                                            const float (&c)[4],
                                            const E* rows) {
  constexpr int LD = row_stride<D, E>();
  const float x[4] = {c[0], c[2], c[1], c[3]};
  const FragA a(x);
#pragma unroll
  for (int no = 0; no < D / 8; ++no) {
    const float y[2] = {to_f(rows[no * 8]), to_f(rows[LD + no * 8])};
    mma_split<false, kExact<E>>(acc[no], a, y);
  }
}

// P of one (query, key) pair from its raw score ``s`` (q . k, unscaled),
// the key's bias ``b`` and the query row's logsumexp: exp(s * scale + b -
// lse), summed in the plain version's order, as one ex2.approx.
__device__ __forceinline__ float prob(float s, float scale, float b,
                                      float lse) {
  return exp2_approx((fmaf(s, scale, b) - lse) * kLog2e);
}

}  // namespace
