// Pieces shared by the two FlashAttention-2 backward kernels, K6 flash_bwd_dq
// (query-parallel) and K7 flash_bwd_dkv (key-parallel).
//
// Both recompute one 64 x 64 tile of P = exp(S - lse) and of
// dS = P * (dP - dd) from the forward's logsumexp ``lse`` and
// dd = rowsum(dO * O) (minus the lse cotangent), both (B*H, T) fp32, as
// _bwd_dq_kernel and _bwd_dkv_kernel do.  A 16 x 16 grid of 256 threads
// covers a tile, each thread a 4 x 4 patch (rows ty + 16 i, columns
// tx + 16 j); tiles live in shared memory with rows padded by one float.
// Masking follows the forward (K1): keys past T or past the causal diagonal
// weigh exactly 0, the key bias is added as is (-1e30 for a masked key), and
// query rows past T contribute nothing.
#pragma once

#include "common.cuh"

namespace mx_bwd {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid over a 64 x 64 tile

// Copy rows [t0, t0 + kTile) of a (T, D) matrix into a tile with row stride
// D + 1, zero past T.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int t0, int T) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, t = t0 + r;
    dst[r * (D + 1) + c] =
        t < T ? src[static_cast<size_t>(t) * D + c] : 0.f;
  }
}

// s[i][j] = q_row . k_row and dp[i][j] = do_row . v_row for the thread's
// 4 x 4 patch: query rows ty + 16 i of (qs, dos), keys tx + 16 j of
// (ks, vs).
template <int D>
__device__ __forceinline__ void score_patches(
    const float* qs, const float* dos, const float* ks, const float* vs,
    int ty, int tx, float (&s)[4][4], float (&dp)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty + 16 * i) * LD + d];
      ov[i] = dos[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * LD + d];
      vv[j] = vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// P of one (query tq, key tk) pair from its raw score ``s`` (q . k, not yet
// scaled), the key's bias ``b`` and the row's logsumexp; 0 where masked.
__device__ __forceinline__ float prob(float s, float b, float row_lse,
                                      int tq, int tk, int T, float scale,
                                      int causal) {
  if (tq >= T || tk >= T || (causal && tk > tq)) return 0.f;
  return expf(s * scale + b - row_lse);
}

}  // namespace mx_bwd
