// The cached-query attention shared by K2 paged_decode, K3 decode, K4
// paged_verify and K5 verify: Q query rows per (slot, head), row j at
// logical position positions[s] + j attending to keys 0..h_j, where
// h_j = min(positions[s] + j, L - 1) and L is the cache's length in keys
// (MB * bs paged, T dense).  A decode is the Q = 1 case.  The kernels
// differ only in Q and in where key t of (slot, head) lives, so the loop
// is one template and the address computation is its parameter (PagedKV
// or DenseKV below).
//
// Replaces: _paged_decode_kernel (K2, flash_attention.py:689),
// _decode_kernel (K3, :552), _paged_verify_kernel (K4, :962) and
// _verify_kernel (K5, :841) in incubator_mxnet_tpu/kernels/
// flash_attention.py.
//
// Bound on this card: bytes.  Each (slot, head) reads its live keys and
// values once, 2 * (h_{Q-1} + 1) * D * 4 bytes, and does 4 FLOP per
// element and live (row, key) pair: at Q <= 9 at most ~10 FLOP per byte
// read, far below the ~20 FLOP/byte an fp32 kernel needs to be
// compute-bound.  The time is therefore the live K/V bytes over
// 3.35 TB/s: the tensor cores and wgmma do not help, and what does is
// many blocks and many loads in flight on every SM.
//
// Design: split over the key range, then merge (two launches).
// * Split: the grid is (H, S, n_split), n_split = ceil(L / kChunkKeys),
//   fixed by the shapes alone.  Block (h, s, c) owns keys [c * 64,
//   min(c * 64 + 63, h_{Q-1})] and exits at once, before any barrier,
//   when c * 64 > h_{Q-1}.  positions (and, paged, the table) are read
//   on the device, never from host integers, so a later CUDA graph stays
//   valid across steps.  A paged block first stages the chunk's (at most
//   64 / bs + 1) table entries in shared memory.  Each of its 4 warps
//   takes 16 keys: a key row is D / 4 lanes wide, one float4 a lane, so
//   a warp load covers 32 / (D / 4) keys, and every K and V row of the
//   warp's 16 keys is requested before the first dot product needs one.
//   The block then uses those registers for every query row whose head
//   reaches the chunk (that reuse is all a verify saves over Q decode
//   calls): for row j each warp keeps an online-softmax state (max, sum,
//   accumulator) over its keys <= h_j, the block merges its 4 warps'
//   states in shared memory, kRows rows at a time, and writes one
//   partial (acc[D], m, l) per (row, chunk) to the (S, H, Q, n_split,
//   D + 2) fp32 scratch the wrapper allocates.  Keys past h_j weigh
//   exactly 0 for row j (and their values are never multiplied in):
//   rejected draft positions are only overwritten by the next dispatch,
//   so that mask is what keeps stale K/V out.
// * Merge: one block of D threads per (slot, head, row) walks chunks
//   0..h_j / 64 in chunk order, weighs each partial by exp(m_c - max m)
//   and writes sum(acc) / sum(l), or 0 where no key is live.
// * Bit for bit: chunk boundaries are fixed multiples of 64 in absolute
//   key positions, independent of L and of the data, and the merge is in
//   chunk order, so a paged and a dense cache holding the same live K/V
//   give the same bits (K2 == K3, K4 == K5).  Row j's arithmetic depends
//   only on h_j, so row j of a verify equals a decode at positions[s] + j
//   bit for bit.
// * Why no TMA or cp.async: a 64-key chunk is 32 KB of K and V at D = 64,
//   read once and kept in registers; staging it in shared memory would add
//   a round trip and no reuse.
// * Element types: q and o are fp32, bf16 or fp16 (E), as the Pallas
//   kernels take q in any float dtype and write o in q's; K/V and the
//   scratch are fp32 whatever E, as the JAX engine keeps its caches.  The
//   split converts q's values exactly to fp32 and otherwise runs the fp32
//   code; merge16_kernel rounds num / den once more into o.  The fp32
//   instances compile to the SASS they had before E existed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace mxdec {

constexpr int kChunkKeys = 64;                    // keys per split block
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kWarpKeys = kChunkKeys / kSplitWarps;  // keys per warp
constexpr int kRows = 8;  // query rows a split block merges at once

struct DenseKV {  // k, v: (S, H, T, D)
  const float* k;
  const float* v;
  int H, T;
  __device__ int length() const { return T; }
  __device__ size_t row(int s, int h, int t) const {
    return (static_cast<size_t>(s) * H + h) * T + t;
  }
  // nothing to stage: the address is arithmetic
  __device__ void stage(int, int, int, int*) const {}
  __device__ size_t staged_row(int s, int h, int t, const int*, int) const {
    return row(s, h, t);
  }
};

struct PagedKV {  // pages: (NB, H, bs, D); tables: (S, MB) int32
  const float* k;
  const float* v;
  const int* tables;
  int H, NB, bs, MB;
  __device__ int length() const { return MB * bs; }
  __device__ int block(int s, int i) const {
    const int blk = tables[static_cast<size_t>(s) * MB + i];
    return min(max(blk, 0), NB - 1);  // clamp like the JAX gather
  }
  // the table entries of keys t0..t1 into tab[0..], by the whole block
  __device__ void stage(int s, int t0, int t1, int* tab) const {
    const int b0 = t0 / bs, n = t1 / bs - b0 + 1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) tab[i] = block(s, b0 + i);
  }
  __device__ size_t staged_row(int s, int h, int t, const int* tab,
                               int t0) const {
    const int blk = tab[t / bs - t0 / bs];
    return (static_cast<size_t>(blk) * H + h) * bs + t % bs;
  }
};

// A lane's 4 consecutive floats as one vector load (the wrapper checks
// that every tensor is 16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

// A lane's 4 consecutive query values as fp32: one float4, or 8 bytes of
// 16-bit values converted exactly.
__device__ __forceinline__ void load_q(const float* p, float (&x)[4]) {
  load4(p, x);
}
__device__ __forceinline__ void load_q(const __nv_bfloat16* p,
                                       float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void load_q(const __half* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// An fp32 output value as a 16-bit one, rounded to nearest even.
__device__ __forceinline__ void store_o(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_o(__half* p, float x) {
  *p = __float2half_rn(x);
}

// q: (S, H, Q, D) of E; part: (S, H, Q, gridDim.z, D + 2) fp32, one
// (acc[D], m, l) per (row, chunk) whose keys reach the row's head
template <int D, class KV, class E>
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const E* __restrict__ q, KV kv,
             const int* __restrict__ positions, float* __restrict__ part,
             int H, int Q, float scale) {
  constexpr int LPK = D / 4;          // lanes per key row, one float4 each
  constexpr int KPL = 32 / LPK;       // keys per warp load
  constexpr int NL = kWarpKeys / KPL; // warp loads per warp
  __shared__ int tab[kChunkKeys + 1];
  __shared__ float sm_m[kSplitWarps][kRows], sm_l[kSplitWarps][kRows];
  __shared__ float sm_acc[kSplitWarps][kRows][D];
  const int h = blockIdx.x, s = blockIdx.y, c = blockIdx.z;
  const int t0 = c * kChunkKeys;
  const int base = positions[s];
  const int last = min(base + Q - 1, kv.length() - 1);  // the last row's head
  if (t0 > last) return;  // the whole block, before any barrier
  const int t1 = min(t0 + kChunkKeys - 1, last);
  kv.stage(s, t0, t1, tab);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPK, col = (lane % LPK) * 4;
  const int tw = t0 + warp * kWarpKeys + sub;  // this lane's first key
  // rows before j0 end before this chunk; the rest reach it (t0 <= L - 1)
  const int j0 = max(0, t0 - base);
  const size_t row0 = (static_cast<size_t>(s) * H + h) * Q;

  // every K and V row of the warp's keys in flight before the first use
  float kx[NL][4], vx[NL][4];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int t = tw + i * KPL;
    if (t <= t1) {
      const size_t r = kv.staged_row(s, h, t, tab, t0) * D + col;
      load4(kv.k + r, kx[i]);
      load4(kv.v + r, vx[i]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) kx[i][e] = vx[i][e] = 0.f;
    }
  }

  for (int r0 = j0; r0 < Q; r0 += kRows) {
    const int nr = min(kRows, Q - r0);
    for (int jj = 0; jj < nr; ++jj) {
      const int j = r0 + jj;
      const int tj = min(t1, base + j);  // the row's last key here
      float qv[4];
      load_q(q + (row0 + j) * D + col, qv);
      float sc[NL], mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) dot = fmaf(qv[e], kx[i][e], dot);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)  // within the key's lanes
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[i] = tw + i * KPL <= tj ? dot * scale : -CUDART_INF_F;
        mx = fmaxf(mx, sc[i]);
      }
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)  // across the warp's keys
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));

      // mx is -inf only for a warp with no live key; then every p is 0
      float l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        if (tw + i * KPL <= tj) {
          const float p = expf(sc[i] - mx);
          l += p;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] = fmaf(p, vx[i][e], acc[e]);
        }
      }
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      }
      if (lane == 0) {
        sm_m[warp][jj] = mx;
        sm_l[warp][jj] = l;
      }
      if (lane < LPK) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sm_acc[warp][jj][col + e] = acc[e];
      }
    }
    __syncthreads();

    // warp 0 holds key t0 <= the row's head, so big is finite; an idle
    // warp weighs 0
    for (int i = threadIdx.x; i < nr * D; i += kSplitThreads) {
      const int jj = i / D, d = i % D;
      float big = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) big = fmaxf(big, sm_m[w][jj]);
      float num = 0.f;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w)
        num = fmaf(sm_acc[w][jj][d], expf(sm_m[w][jj] - big), num);
      part[((row0 + r0 + jj) * gridDim.z + c) * (D + 2) + d] = num;
    }
    if (threadIdx.x < nr) {
      const int jj = threadIdx.x;
      float big = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) big = fmaxf(big, sm_m[w][jj]);
      float den = 0.f;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w)
        den = fmaf(sm_l[w][jj], expf(sm_m[w][jj] - big), den);
      float* out = part + ((row0 + r0 + jj) * gridDim.z + c) * (D + 2);
      out[D] = big;
      out[D + 1] = den;
    }
    if (r0 + kRows < Q) __syncthreads();  // before the next rows' states
  }
}

// One block of D threads per (slot, head, row j): o = the partials of
// chunks 0..h_j / 64 merged in chunk order, or 0 where no key is live.
template <int D>
__global__ void __launch_bounds__(D)
merge_kernel(const float* __restrict__ part,
             const int* __restrict__ positions, float* __restrict__ o,
             int H, int L, int Q, int n_split) {
  const int h = blockIdx.x, s = blockIdx.y, j = blockIdx.z, d = threadIdx.x;
  const int head = min(positions[s] + j, L - 1);
  const int n_live = head < 0 ? 0 : head / kChunkKeys + 1;
  const size_t row = (static_cast<size_t>(s) * H + h) * Q + j;
  const float* p = part + row * n_split * (D + 2);
  float big = -CUDART_INF_F;
  for (int c = 0; c < n_live; ++c) big = fmaxf(big, p[c * (D + 2) + D]);
  float num = 0.f, den = 0.f;
  for (int c = 0; c < n_live; ++c) {
    const float* pc = p + c * (D + 2);
    const float wt = expf(pc[D] - big);
    num = fmaf(pc[d], wt, num);
    den = fmaf(pc[D + 1], wt, den);
  }
  o[row * D + d] = den > 0.f ? num / den : 0.f;
}

// merge_kernel with o of the 16-bit type E, the fp32 value rounded once.
// A copy, not one template over E: the template's fp32 instance compiled
// to other SASS than merge_kernel (the same operations, other registers
// and order), and the fp32 instance keeps its code.
template <int D, class E>
__global__ void __launch_bounds__(D)
merge16_kernel(const float* __restrict__ part,
               const int* __restrict__ positions, E* __restrict__ o,
               int H, int L, int Q, int n_split) {
  const int h = blockIdx.x, s = blockIdx.y, j = blockIdx.z, d = threadIdx.x;
  const int head = min(positions[s] + j, L - 1);
  const int n_live = head < 0 ? 0 : head / kChunkKeys + 1;
  const size_t row = (static_cast<size_t>(s) * H + h) * Q + j;
  const float* p = part + row * n_split * (D + 2);
  float big = -CUDART_INF_F;
  for (int c = 0; c < n_live; ++c) big = fmaxf(big, p[c * (D + 2) + D]);
  float num = 0.f, den = 0.f;
  for (int c = 0; c < n_live; ++c) {
    const float* pc = p + c * (D + 2);
    const float wt = expf(pc[D] - big);
    num = fmaf(pc[d], wt, num);
    den = fmaf(pc[D + 1], wt, den);
  }
  store_o(&o[row * D + d], den > 0.f ? num / den : 0.f);
}

template <int D, class KV, class E>
int launch_d(const E* q, KV kv, const int* positions, float* part, E* o,
             int S, int H, int L, int Q, float scale, cudaStream_t stream,
             int* launches) {
  const int n_split = (L + kChunkKeys - 1) / kChunkKeys;
  split_kernel<D, KV, E><<<dim3(H, S, n_split), kSplitThreads, 0, stream>>>(
      q, kv, positions, part, H, Q, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  if constexpr (std::is_same<E, float>::value)
    merge_kernel<D><<<dim3(H, S, Q), D, 0, stream>>>(part, positions, o, H,
                                                     L, Q, n_split);
  else
    merge16_kernel<D, E><<<dim3(H, S, Q), D, 0, stream>>>(
        part, positions, o, H, L, Q, n_split);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return static_cast<int>(err);
}

template <class KV, class E>
int launch_e(const E* q, KV kv, const int* positions, float* part, E* o,
             int S, int H, int L, int Q, int D, float scale,
             cudaStream_t stream, int* launches) {
  switch (D) {
    case 16: return launch_d<16>(q, kv, positions, part, o, S, H, L, Q, scale, stream, launches);
    case 32: return launch_d<32>(q, kv, positions, part, o, S, H, L, Q, scale, stream, launches);
    case 64: return launch_d<64>(q, kv, positions, part, o, S, H, L, Q, scale, stream, launches);
    case 128: return launch_d<128>(q, kv, positions, part, o, S, H, L, Q, scale, stream, launches);
    default: return MX_ERR_UNSUPPORTED_D;
  }
}

// Q query rows per slot (K4, K5; K2, K3 with Q = 1).  q (S, H, Q, D) and o
// of the element type `dtype` (0 fp32, 1 bf16, 2 fp16); part: the (S, H,
// Q, ceil(L / kChunkKeys), D + 2) fp32 scratch, L the cache's length in
// keys (MB * bs paged, T dense).  The launches made (the split, then the
// merge) are added to *launches.
template <class KV>
int launch(const void* q, KV kv, const int* positions, float* part, void* o,
           int S, int H, int L, int Q, int D, float scale, int dtype,
           cudaStream_t stream, int* launches) {
  switch (dtype) {
    case 0:
      return launch_e(static_cast<const float*>(q), kv, positions, part,
                      static_cast<float*>(o), S, H, L, Q, D, scale, stream,
                      launches);
    case 1:
      return launch_e(static_cast<const __nv_bfloat16*>(q), kv, positions,
                      part, static_cast<__nv_bfloat16*>(o), S, H, L, Q, D,
                      scale, stream, launches);
    case 2:
      return launch_e(static_cast<const __half*>(q), kv, positions, part,
                      static_cast<__half*>(o), S, H, L, Q, D, scale, stream,
                      launches);
    default: return MX_ERR_UNSUPPORTED_DTYPE;
  }
}

}  // namespace mxdec
