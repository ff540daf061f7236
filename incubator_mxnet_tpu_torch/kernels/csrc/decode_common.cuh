// The single-query decode attention shared by K2 paged_decode and K3
// decode.  The two kernels differ only in where key t of (slot, head)
// lives, so the loop is one template and the address computation is its
// parameter (PagedKV or DenseKV below).
//
// Replaces: _paged_decode_kernel (K2, flash_attention.py:689) and
// _decode_kernel (K3, flash_attention.py:552) in
// incubator_mxnet_tpu/kernels/flash_attention.py.
//
// Bound on this card: bytes.  Each (slot, head) reads its live keys and
// values once, 2 * (pos + 1) * D * 4 bytes, and does 4 FLOP per element,
// far below the ~20 FLOP/byte an fp32 kernel needs to be compute-bound.
// The time is therefore the live K/V bytes over 3.35 TB/s, and the design
// is about keeping many independent loads in flight on every SM.
//
// Design: split over the key range, then merge (two launches).
// * Split: the grid is (H, S, n_split), n_split = ceil(L / kChunkKeys)
//   with L = kv.length() (MB * bs paged, T dense).  Block (h, s, c) owns
//   keys [c * 64, min(c * 64 + 63, positions[s])] and exits at once when
//   c * 64 > positions[s].  positions (and, paged, the table) are read on
//   the device, never from host integers, and the grid depends only on
//   shapes, so a later CUDA graph stays valid across steps.  The chunk
//   boundaries are fixed multiples of 64 in absolute key positions,
//   independent of L and of the data, so a paged and a dense cache holding
//   the same live K/V sum in the same order and give bit-identical results.
//   A paged block first stages the chunk's (at most 64 / bs + 1) table
//   entries in shared memory.  Each of its 4 warps takes 16 keys: a key row
//   is D / 4 lanes wide, one float4 a lane, so a warp load covers 32 / (D /
//   4) keys and every K and V row of the warp's 16 keys is requested before
//   the first dot product needs one.  Each warp keeps an online-softmax
//   state (max, sum, accumulator), the block merges its 4 in shared memory
//   and writes one partial (acc[D], m, l) to the (S, H, n_split, D + 2)
//   fp32 scratch the wrapper allocates.
// * Merge: one block of D threads per (slot, head) reads positions[s],
//   weighs the live chunks' partials by exp(m_c - max m) in chunk order,
//   and writes sum(acc) / sum(l), or 0 where no key is live.
#pragma once

#include "common.cuh"

namespace mxdec {

// The shared-memory loop of K4/K5 (verify_common.cuh) uses these four.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 4;  // consecutive keys a warp reduces together

// The split decode kernel's geometry.
constexpr int kChunkKeys = 64;                    // keys per split block
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kWarpKeys = kChunkKeys / kSplitWarps;  // keys per warp

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
  __device__ size_t row(int s, int h, int t) const {
    return (static_cast<size_t>(block(s, t / bs)) * H + h) * bs + t % bs;
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

// A lane's N consecutive floats as one vector load (the wrapper checks
// that every tensor is 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_lane(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = p[e];
  }
}

__device__ __forceinline__ int last_key(const int* positions, int s, int L) {
  return min(positions[s], L - 1);
}

// part: (S, H, gridDim.z, D + 2) fp32, one (acc[D], m, l) per live chunk
template <int D, class KV>
__global__ void __launch_bounds__(kSplitThreads)
decode_split_kernel(const float* __restrict__ q, KV kv,
                    const int* __restrict__ positions,
                    float* __restrict__ part, int H, float scale) {
  constexpr int LPK = D / 4;          // lanes per key row, one float4 each
  constexpr int KPL = 32 / LPK;       // keys per warp load
  constexpr int NL = kWarpKeys / KPL; // warp loads per warp
  __shared__ int tab[kChunkKeys + 1];
  __shared__ float sm_m[kSplitWarps], sm_l[kSplitWarps];
  __shared__ float sm_acc[kSplitWarps][D];
  const int h = blockIdx.x, s = blockIdx.y, c = blockIdx.z;
  const int t0 = c * kChunkKeys;
  const int last = last_key(positions, s, kv.length());
  if (t0 > last) return;  // the whole block, before any barrier
  const int t1 = min(t0 + kChunkKeys - 1, last);
  kv.stage(s, t0, t1, tab);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPK, col = (lane % LPK) * 4;
  float qv[4];
  load_lane<4>(q + (static_cast<size_t>(s) * H + h) * D + col, qv);

  // every K and V row of the warp's keys in flight before the first use
  float kx[NL][4], vx[NL][4];
  bool live[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int t = t0 + warp * kWarpKeys + i * KPL + sub;
    live[i] = t <= t1;
    if (live[i]) {
      const size_t r = kv.staged_row(s, h, t, tab, t0) * D + col;
      load_lane<4>(kv.k + r, kx[i]);
      load_lane<4>(kv.v + r, vx[i]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) kx[i][e] = vx[i][e] = 0.f;
    }
  }

  float sc[NL], mx = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) dot = fmaf(qv[e], kx[i][e], dot);
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1)  // within the key's lanes
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    sc[i] = live[i] ? dot * scale : -CUDART_INF_F;
    mx = fmaxf(mx, sc[i]);
  }
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)  // across the warp's keys
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));

  // mx is -inf only for a warp with no live key; then every p is 0
  float l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const float p = live[i] ? expf(sc[i] - mx) : 0.f;
    l += p;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = fmaf(p, vx[i][e], acc[e]);
  }
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (lane == 0) {
    sm_m[warp] = mx;
    sm_l[warp] = l;
  }
  if (lane < LPK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sm_acc[warp][col + e] = acc[e];
  }
  __syncthreads();

  // warp 0 holds key t0 <= last, so big is finite; an idle warp weighs 0
  float big = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < kSplitWarps; ++w) big = fmaxf(big, sm_m[w]);
  float* out = part + ((static_cast<size_t>(s) * H + h) * gridDim.z + c) *
                          (D + 2);
  for (int d = threadIdx.x; d < D; d += kSplitThreads) {
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      num = fmaf(sm_acc[w][d], expf(sm_m[w] - big), num);
    out[d] = num;
  }
  if (threadIdx.x == 0) {
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      den = fmaf(sm_l[w], expf(sm_m[w] - big), den);
    out[D] = big;
    out[D + 1] = den;
  }
}

// One block of D threads per (slot, head): o = the live chunks' partials
// merged in chunk order, or 0 where no key is live.
template <int D>
__global__ void __launch_bounds__(D)
decode_merge_kernel(const float* __restrict__ part,
                    const int* __restrict__ positions, float* __restrict__ o,
                    int H, int L, int n_split) {
  const int h = blockIdx.x, s = blockIdx.y, d = threadIdx.x;
  const int last = last_key(positions, s, L);
  const int n_live = last < 0 ? 0 : last / kChunkKeys + 1;
  const float* p = part + (static_cast<size_t>(s) * H + h) * n_split * (D + 2);
  float big = -CUDART_INF_F;
  for (int c = 0; c < n_live; ++c) big = fmaxf(big, p[c * (D + 2) + D]);
  float num = 0.f, den = 0.f;
  for (int c = 0; c < n_live; ++c) {
    const float* pc = p + c * (D + 2);
    const float wt = expf(pc[D] - big);
    num = fmaf(pc[d], wt, num);
    den = fmaf(pc[D + 1], wt, den);
  }
  o[(static_cast<size_t>(s) * H + h) * D + d] = den > 0.f ? num / den : 0.f;
}

template <int D, class KV>
int launch_d(const float* q, KV kv, const int* positions, float* part,
             float* o, int S, int H, int L, float scale, cudaStream_t stream) {
  const int n_split = (L + kChunkKeys - 1) / kChunkKeys;
  decode_split_kernel<D, KV><<<dim3(H, S, n_split), kSplitThreads, 0,
                               stream>>>(q, kv, positions, part, H, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<D><<<dim3(H, S), D, 0, stream>>>(part, positions, o, H,
                                                      L, n_split);
  return static_cast<int>(cudaGetLastError());
}

// part: the (S, H, ceil(L / kChunkKeys), D + 2) fp32 scratch, L the
// cache's length in keys (MB * bs paged, T dense)
template <class KV>
int launch(const float* q, KV kv, const int* positions, float* part,
           float* o, int S, int H, int L, int D, float scale,
           cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<16>(q, kv, positions, part, o, S, H, L, scale, stream);
    case 32: return launch_d<32>(q, kv, positions, part, o, S, H, L, scale, stream);
    case 64: return launch_d<64>(q, kv, positions, part, o, S, H, L, scale, stream);
    case 128: return launch_d<128>(q, kv, positions, part, o, S, H, L, scale, stream);
    default: return MX_ERR_UNSUPPORTED_D;
  }
}

}  // namespace mxdec
