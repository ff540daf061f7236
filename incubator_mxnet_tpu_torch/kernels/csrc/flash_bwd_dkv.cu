// K7 flash_bwd_dkv: the key-parallel half of the FlashAttention-2 backward,
// fp32 accuracy on the tensor cores, for the encoder self-attention of the
// BERT training step.
//
// Replaces: _bwd_dkv_kernel in incubator_mxnet_tpu/kernels/flash_attention.py
// (launched by _flash_bwd_impl).  Same function: from q, k, v, dO (B*H, T, D)
// of one element type E (fp32, bf16 or fp16; dK, dV written in E, fp32
// inside), lse and dd (B*H, T) fp32 and an optional (B, 1, T) key bias,
//   dV = P^T dO,  dK = (P * (dP - dd))^T Q * scale,
//   dbs = the column sums of P * (dP - dd), (B*H, T) fp32,
// always written, as the Pallas kernel writes them; the wrapper sums dbs
// over the heads into the key bias's cotangent when the bias needs one.
//
// Bound on this card: four T x T x D products (S, dP, P^T dO and dS^T Q),
// 8 * D FLOP per live (query, key) pair, run as 3xTF32 on the tensor cores
// (tf32_mma.cuh), so the larger of 3 * 8 * D * pairs FLOP over the
// 495 TFLOP/s TF32 peak and the bytes of reading q, k, v, dO, lse, dd once
// and writing dK, dV and dbs once over 3.35 TB/s; at BERT-large's shape
// (T = 128, D = 64) the bytes bound it.
//
// Design: K6's tile in transposed form, so that nothing goes through shared
// memory but the inputs.  One block of 4 warps owns 64 keys of one (batch,
// head); warp w owns keys 16w..16w+15 as its fragment rows.  The block's K
// and V tiles stay in shared memory (K and V A fragments are read and split
// per k-step: held in registers for the whole block they would not fit
// beside the dK and dV accumulators), and 64-row q/dO tiles with their lse
// and dd are double-buffered with cp.async, one barrier per tile.  Per tile
// a warp forms S^T = K q^T and dP^T = V dO^T (keys as rows, queries as
// columns; flash_bwd_common.cuh), turns them into P^T (lse read per
// column; exactly 0 past T and before the diagonal) and dS^T = P^T *
// (dP^T - dd[column]) in place, adds dS^T's row sums to the thread's dbs
// partials, and accumulates dV += P^T dO and dK += dS^T q from registers,
// each fragment read as the A fragment with its 8 queries permuted and the
// dO / q rows read in the same order.  The partial dbs sums meet by quad
// shuffle at the end.  The grid is (B*H, key tiles); a causal block starts
// at the first query tile that sees its keys, as the Pallas loop starts at
// kj * block_k // block_q, so key tile 0, the heaviest, goes first.  D is a
// template parameter in {16, 32, 64, 128}, and so is E (16-bit tiles halve
// the shared memory and the bytes; S^T and dP^T are then one tensor-core
// product each, dV and dK two: flash_bwd_common.cuh).
#include "flash_bwd_common.cuh"

namespace {

// K and V tiles, two stages of (q tile, dO tile) with rows padded by 16
// bytes, and two stages of fp32 (lse row, dd row)
template <int D, typename E>
constexpr int smem_bytes() {
  return 6 * kTile * row_stride<D, E>() * static_cast<int>(sizeof(E)) +
         4 * kTile * static_cast<int>(sizeof(float));
}

// 4-byte copy, zero-filled where ``valid`` is false (lse and dd rows have
// no 16-byte alignment at a ragged T)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(n));
}

// query tile i's q, dO (row stride row_stride<D, E>()) and its lse, dd
// values
template <int D, typename E>
__device__ __forceinline__ void load_query_tile(E* qs, float* rows,
                                                const E* q, const E* dout,
                                                const float* lse,
                                                const float* dd, int q0,
                                                int T) {
  load_tile<D>(qs, q + static_cast<size_t>(q0) * D, T - q0);
  load_tile<D>(qs + kTile * row_stride<D, E>(),
               dout + static_cast<size_t>(q0) * D, T - q0);
  const int i = threadIdx.x & (kTile - 1);
  const bool ok = q0 + i < T;
  const float* src = threadIdx.x < kTile ? lse : dd;
  cp_async4(rows + threadIdx.x, ok ? src + q0 + i : src, ok);
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v,
                     const float* __restrict__ bias,
                     const E* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, E* __restrict__ dk,
                     E* __restrict__ dv, float* __restrict__ dbs, int T,
                     int H, float scale, int causal) {
  constexpr int LD = row_stride<D, E>();
  constexpr int TILE = kTile * LD;
  constexpr int NO = D / 8;          // n-tiles of dK and dV
  // [K | V | q0 | dO0 | q1 | dO1 | lse0 dd0 | lse1 dd1]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  const E* ks_ = smem;
  const E* vs_ = smem + TILE;
  float* rows_s = reinterpret_cast<float*>(smem + 6 * TILE);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int k0 = kt * kTile;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const size_t row_base = static_cast<size_t>(bh) * T;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int first = causal ? kt : 0;

  load_tile<D>(smem, k + base + static_cast<size_t>(k0) * D, T - k0);
  load_tile<D>(smem + TILE, v + base + static_cast<size_t>(k0) * D, T - k0);
  load_query_tile<D, E>(smem + 2 * TILE, rows_s, q + base, dout + base,
                        lse + row_base, dd + row_base, first * kTile, T);
  cp_async_commit();

  // this thread's keys r0 and r0 + 8 of the block, and their bias
  const int r0 = warp * 16 + g;
  const int key[2] = {k0 + r0, k0 + r0 + 8};
  float b[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    b[r] = bias != nullptr && key[r] < T
               ? bias[static_cast<size_t>(bh / H) * T + key[r]]
               : 0.f;

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  float dsum[2] = {0.f, 0.f};

  for (int i = first; i < n_tiles; ++i) {
    // tile i has landed, and every warp is done with tile i - 1, so its
    // stage may be refilled
    cp_async_wait_all();
    __syncthreads();
    const int stage = (i - first) & 1;
    if (i + 1 < n_tiles) {
      load_query_tile<D, E>(smem + (2 + 2 * (stage ^ 1)) * TILE,
                         rows_s + (stage ^ 1) * 2 * kTile, q + base,
                         dout + base, lse + row_base, dd + row_base,
                         (i + 1) * kTile, T);
      cp_async_commit();
    }
    const E* qs = smem + (2 + 2 * stage) * TILE;
    const E* dos = qs + TILE;
    const float* lse_s = rows_s + stage * 2 * kTile;
    const float* dd_s = lse_s + kTile;
    const int q0 = i * kTile;

    // st = K q^T, dpt = V dO^T; element e of n-tile n is key key[e >> 1],
    // query q0 + 8n + 2t + (e & 1)
    float st[kNT][4], dpt[kNT][4];
    tile_products<D, E>(st, dpt, ks_ + r0 * LD + t, qs + g * LD + t,
                        vs_ + r0 * LD + t, dos + g * LD + t);

    const bool edge = q0 + kTile > T || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = n * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dd_s + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int query = q0 + col + (e & 1), r = e >> 1;
        float p = prob(st[n][e], scale, b[r], (e & 1) ? l2.y : l2.x);
        if (edge && (query >= T || (causal && key[r] > query))) p = 0.f;
        const float ds = p * (dpt[n][e] - ((e & 1) ? d2.y : d2.x));
        st[n][e] = p;
        dpt[n][e] = ds;
        dsum[r] += ds;
      }
    }

    // dV += P^T dO and dK += dS^T q over the tile's 8 query steps, queries
    // permuted
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int row = (n * 8 + 2 * t) * LD + g;
      acc_product<D, E>(acc_v, st[n], dos + row);
      acc_product<D, E>(acc_k, dpt[n], qs + row);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = dsum[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (key[r] >= T) continue;
    const size_t off = base + static_cast<size_t>(key[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      store2(dk + off + n * 8, acc_k[n][2 * r] * scale,
             acc_k[n][2 * r + 1] * scale);
      store2(dv + off + n * 8, acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
    if (t == 0) dbs[row_base + key[r]] = sum;
  }
}

template <int D, typename E>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const void* dout, const float* lse, const float* dd, void* dk,
           void* dv, float* dbs, int BH, int H, int T, float scale,
           int causal, cudaStream_t stream) {
  const int bytes = smem_bytes<D, E>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<D, E><<<grid, kThreads, bytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), bias, static_cast<const E*>(dout), lse, dd,
      static_cast<E*>(dk), static_cast<E*>(dv), dbs, T, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_d(const void* q, const void* k, const void* v, const float* bias,
             const void* dout, const float* lse, const float* dd, void* dk,
             void* dv, float* dbs, int BH, int H, int T, int D, float scale,
             int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<16, E>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH, H,
                           T, scale, causal, s);
    case 32:
      return launch<32, E>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH, H,
                           T, scale, causal, s);
    case 64:
      return launch<64, E>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH, H,
                           T, scale, causal, s);
    case 128:
      return launch<128, E>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH, H,
                            T, scale, causal, s);
    default: return MX_ERR_UNSUPPORTED_D;
  }
}

}  // namespace

// q, k, v, dout, dk, dv: (BH, T, D) contiguous, 16-byte aligned, of the
// element type `dtype` (0 fp32, 1 bf16, 2 fp16); lse, dd, dbs: (BH, T)
// fp32; bias: (BH / H, 1, T) fp32 or null.
extern "C" int mx_flash_bwd_dkv(const void* q, const void* k,
                                const void* v, const float* bias,
                                const void* dout, const float* lse,
                                const float* dd, void* dk, void* dv,
                                float* dbs, int BH, int H, int T, int D,
                                float scale, int causal, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH,
                             H, T, D, scale, causal, s);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, bias, dout, lse, dd, dk, dv,
                                     dbs, BH, H, T, D, scale, causal, s);
    case 2:
      return launch_d<__half>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH,
                              H, T, D, scale, causal, s);
    default: return MX_ERR_UNSUPPORTED_DTYPE;
  }
}
