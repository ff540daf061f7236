// The Q-row verify attention loop shared by K4 paged_verify and K5 verify.
// It is decode_common.cuh's loop generalised from one query row per (slot,
// head) to a chunk of up to kChunk query rows: row j of slot s sits at
// logical position positions[s] + j and attends to keys 0..positions[s] + j
// (causal inside the block).  The address of key t is again the template
// parameter (mxdec::PagedKV or mxdec::DenseKV), so the paged and the dense
// kernel share one loop, as K2 and K3 do.
//
// Bound on this card: bytes.  Each (slot, head) must read its live keys
// and values once, 2 * (positions[s] + Q) * D * 4 bytes, and does 4 FLOP
// per element and live (row, key) pair: at Q = 5, ~10 FLOP per byte read,
// below the ~20 an fp32 kernel needs to be compute-bound.
//
// Design: one block of 256 threads (8 warps) per (slot, head, chunk of
// kChunk query rows); gridDim.z = ceil(Q / kChunk) covers any Q >= 1.  The
// block reads positions[s] (and, paged, the table row) on the device.  Warp
// w walks keys in runs of kRun (w*kRun, then +8*kRun, ...) up to the head of
// the chunk's last row and loads each run's key and value rows ONCE, then
// uses them for every row of the chunk: that reuse is what a verify saves
// over Q decode calls.  Each row keeps its own running max, sum and
// accumulator, and row j takes only keys <= its own head: a run past that
// head is skipped for the row, and no key past the last row's head is
// read at all.  Rejected draft positions are never un-written, only
// overwritten by the next dispatch, so that mask is what keeps stale K/V
// out.  A row's arithmetic (dot products, warp sums, rescales, the final
// merge of the 8 warps' states) is decode_kernel's in the same order; a
// verify row agrees with a decode call at the same position to rounding
// (the compiler may contract other products into FMAs in the two
// kernels), and K4 and K5 agree bit for bit.
#pragma once

#include "decode_common.cuh"

namespace mxver {

using mxdec::kRun;
using mxdec::kThreads;
using mxdec::kWarps;
using mxdec::load_lane;

constexpr int kChunk = 8;  // query rows per block

template <int D, class KV>
__global__ void __launch_bounds__(kThreads)
verify_kernel(const float* __restrict__ q, KV kv,
              const int* __restrict__ positions, float* __restrict__ o,
              int H, int Q, float scale) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // elements per lane
  __shared__ float sm_m[kWarps][kChunk], sm_l[kWarps][kChunk];
  __shared__ float sm_acc[kWarps][kChunk][D];
  const int h = blockIdx.x, s = blockIdx.y;
  const int r0 = blockIdx.z * kChunk;  // the chunk's first query row
  const int nrows = min(kChunk, Q - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = lane * EPL;
  const bool on = c0 < D;  // D = 16 leaves half the lanes idle
  const int len = kv.length();
  const int base = positions[s] + r0;
  const int walk_end = min(base + nrows - 1, len - 1);  // last row's head
  const size_t qrow0 = (static_cast<size_t>(s) * H + h) * Q + r0;

  int last[kChunk];  // each row's head; -1 for rows past Q
  float qv[kChunk][EPL], m[kChunk], l[kChunk], acc[kChunk][EPL];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    last[j] = j < nrows ? min(base + j, len - 1) : -1;
    m[j] = -CUDART_INF_F;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qv[j][e] = 0.f;
      acc[j][e] = 0.f;
    }
    if (j < nrows && on) load_lane<EPL>(q + (qrow0 + j) * D + c0, qv[j]);
  }

  for (int t0 = warp * kRun; t0 <= walk_end; t0 += kWarps * kRun) {
    float kx[kRun][EPL], vx[kRun][EPL];
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) kx[u][e] = vx[u][e] = 0.f;
      if (t0 + u <= walk_end && on) {
        const size_t row = kv.row(s, h, t0 + u) * D + c0;
        load_lane<EPL>(kv.k + row, kx[u]);
        load_lane<EPL>(kv.v + row, vx[u]);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (t0 > last[j]) continue;  // warp-uniform: no live key for row j
      float sc[kRun], mx = -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qv[j][e], kx[u][e], dot);
        sc[u] = t0 + u <= last[j] ? mx_warp_sum(dot) * scale : -CUDART_INF_F;
        mx = fmaxf(mx, sc[u]);
      }
      const float m_new = fmaxf(m[j], mx);  // finite: key t0 is live
      const float alpha = expf(m[j] - m_new);
      l[j] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[j][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        if (t0 + u <= last[j]) {
          const float p = expf(sc[u] - m_new);
          l[j] += p;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[j][e] = fmaf(p, vx[u][e], acc[j][e]);
        }
      }
      m[j] = m_new;
    }
  }

#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (lane == 0) {
      sm_m[warp][j] = m[j];
      sm_l[warp][j] = l[j];
    }
    if (on) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][j][c0 + e] = acc[j][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * D; i += kThreads) {
    const int j = i / D, c = i % D;
    float big = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sm_m[w][j]);
    float num = 0.f, den = 0.f;
    if (big != -CUDART_INF_F) {  // no live key at all: write 0, not NaN
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(sm_m[w][j] - big);  // an idle warp weighs 0
        num = fmaf(sm_acc[w][j][c], wt, num);
        den = fmaf(sm_l[w][j], wt, den);
      }
    }
    o[(qrow0 + j) * D + c] = den > 0.f ? num / den : 0.f;
  }
}

template <class KV>
int launch(const float* q, KV kv, const int* positions, float* o, int S,
           int H, int Q, int D, float scale, cudaStream_t stream) {
  const dim3 grid(H, S, (Q + kChunk - 1) / kChunk);
  switch (D) {
    case 16: verify_kernel<16, KV><<<grid, kThreads, 0, stream>>>(q, kv, positions, o, H, Q, scale); break;
    case 32: verify_kernel<32, KV><<<grid, kThreads, 0, stream>>>(q, kv, positions, o, H, Q, scale); break;
    case 64: verify_kernel<64, KV><<<grid, kThreads, 0, stream>>>(q, kv, positions, o, H, Q, scale); break;
    case 128: verify_kernel<128, KV><<<grid, kThreads, 0, stream>>>(q, kv, positions, o, H, Q, scale); break;
    default: return MX_ERR_UNSUPPORTED_D;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mxver
