// K6 flash_bwd_dq: the query-parallel half of the FlashAttention-2
// backward, fp32 accuracy on the tensor cores, for the encoder
// self-attention of the BERT training step.
//
// Replaces: _bwd_dq_kernel in incubator_mxnet_tpu/kernels/flash_attention.py
// (launched by _flash_bwd_impl).  Same function: from q, k, v, dO (B*H, T, D)
// of one element type E (fp32, bf16 or fp16; dQ written in E, fp32
// inside),
// the forward's logsumexp lse and dd = rowsum(dO * O) - g_lse (B*H, T), and
// an optional (B, 1, T) key bias shared by the batch's H heads,
//   dQ = sum_j P * (dP - dd) K * scale,  P = exp(S - lse),  dP = dO V^T,
// where S = q k^T * scale + bias, masked as in the forward (K1).
//
// Bound on this card: three T x T x D products (S, dP and dS K), 6 * D FLOP
// per live (query, key) pair, run as 3xTF32 on the tensor cores
// (tf32_mma.cuh), so the larger of 3 * 6 * D * pairs FLOP over the
// 495 TFLOP/s TF32 peak and the bytes of reading q, k, v, dO, lse, dd once
// and writing dQ once over 3.35 TB/s; at BERT-large's shape (T = 128,
// D = 64) the bytes bound it.
//
// Design: K1's layout (flash_fwd.cu) with a second score product and no
// online softmax.  One block of 4 warps owns a 64-row query tile of one
// (batch, head); warp w owns rows 16w..16w+15.  The tile's q and dO stay
// in shared memory, and 64-key K/V tiles are double-buffered with 16-byte
// cp.async (one barrier per tile: the next tile's copy is issued right
// after it and overlaps this tile's products), all rows padded to D + 4.
// Per tile a warp forms S and dP in accumulator fragments
// (flash_bwd_common.cuh), turns them into P (one ex2.approx; exactly 0
// past T and past the diagonal) and dS = P * (dP - dd[row]) in place, and
// accumulates dQ += dS K from registers: dS's fragment is the A fragment
// with each 8-key step's keys permuted, K's rows read in the same order,
// as K1's P V.  Neither P nor dS touches shared memory, and the block
// writes dQ * scale once.  The grid is (B*H, query tiles); under causal
// the query tiles run in reverse, so the heaviest tiles go first, and a
// block stops at the tile holding its diagonal, as _n_diag_blocks does.
// D is a template parameter in {16, 32, 64, 128}, and so is E (16-bit
// tiles halve the shared memory and the bytes; S and dP are then one
// tensor-core product each, dS K two: flash_bwd_common.cuh).
#include "flash_bwd_common.cuh"

namespace {

// q and dO tiles, then two stages of (K tile, V tile); rows padded by 16
// bytes
template <int D, typename E>
constexpr int smem_bytes() {
  return 6 * kTile * row_stride<D, E>() * static_cast<int>(sizeof(E));
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v,
                    const float* __restrict__ bias,
                    const E* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, E* __restrict__ dq,
                    int T, int H, float scale, int causal) {
  constexpr int LD = row_stride<D, E>();
  constexpr int TILE = kTile * LD;
  constexpr int NO = D / 8;          // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);   // [Q | dO | K0 | V0 | K1 | V1]
  E* qs = smem;
  E* dos = smem + TILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kTile;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const size_t row_base = static_cast<size_t>(bh) * T;
  const float* brow =
      bias != nullptr ? bias + static_cast<size_t>(bh / H) * T : nullptr;
  int n_tiles = (T + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, qt + 1);

  load_tile<D>(qs, q + base + static_cast<size_t>(q0) * D, T - q0);
  load_tile<D>(dos, dout + base + static_cast<size_t>(q0) * D, T - q0);
  load_tile<D>(smem + 2 * TILE, k + base, T);
  load_tile<D>(smem + 3 * TILE, v + base, T);
  cp_async_commit();

  // this thread's rows r0 and r0 + 8 of the tile
  const int r0 = warp * 16 + g;
  const int row_q[2] = {q0 + r0, q0 + r0 + 8};
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row_q[r] < T;
    lse_r[r] = ok ? lse[row_base + row_q[r]] : 0.f;
    dd_r[r] = ok ? dd[row_base + row_q[r]] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // tile j has landed, and every warp is done with tile j - 1, so its
    // stage may be refilled
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_tiles) {
      const int k1 = (j + 1) * kTile;
      E* dst = smem + (2 + 2 * ((j + 1) & 1)) * TILE;
      load_tile<D>(dst, k + base + static_cast<size_t>(k1) * D, T - k1);
      load_tile<D>(dst + TILE, v + base + static_cast<size_t>(k1) * D,
                   T - k1);
      cp_async_commit();
    }
    const E* ks_ = smem + (2 + 2 * (j & 1)) * TILE;
    const E* vs_ = ks_ + TILE;
    const int k0 = j * kTile;

    // s = Q K^T, dp = dO V^T; element e of n-tile n is row row_q[e >> 1],
    // key k0 + 8n + 2t + (e & 1)
    float s[kNT][4], dp[kNT][4];
    tile_products<D, E>(s, dp, qs + r0 * LD + t, ks_ + g * LD + t,
                        dos + r0 * LD + t, vs_ + g * LD + t);

    const bool edge = k0 + kTile > T || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1), r = e >> 1;
        const float b = brow != nullptr && key < T ? __ldg(brow + key) : 0.f;
        float p = prob(s[n][e], scale, b, lse_r[r]);
        if (edge && (key >= T || (causal && key > row_q[r]))) p = 0.f;
        s[n][e] = p * (dp[n][e] - dd_r[r]);    // dS
      }
    }

    // dQ += dS K over the tile's 8 key steps, keys permuted
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      acc_product<D, E>(acc, s[n], ks_ + (n * 8 + 2 * t) * LD + g);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_q[r] >= T) continue;
    E* out = dq + base + static_cast<size_t>(row_q[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(out + n * 8, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <int D, typename E>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const void* dout, const float* lse, const float* dd, void* dq,
           int BH, int H, int T, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = smem_bytes<D, E>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T + kTile - 1) / kTile);
  flash_bwd_dq_kernel<D, E><<<grid, kThreads, bytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), bias, static_cast<const E*>(dout), lse, dd,
      static_cast<E*>(dq), T, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_d(const void* q, const void* k, const void* v, const float* bias,
             const void* dout, const float* lse, const float* dd, void* dq,
             int BH, int H, int T, int D, float scale, int causal,
             cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<16, E>(q, k, v, bias, dout, lse, dd, dq, BH, H, T, scale,
                           causal, s);
    case 32:
      return launch<32, E>(q, k, v, bias, dout, lse, dd, dq, BH, H, T, scale,
                           causal, s);
    case 64:
      return launch<64, E>(q, k, v, bias, dout, lse, dd, dq, BH, H, T, scale,
                           causal, s);
    case 128:
      return launch<128, E>(q, k, v, bias, dout, lse, dd, dq, BH, H, T,
                            scale, causal, s);
    default: return MX_ERR_UNSUPPORTED_D;
  }
}

}  // namespace

// q, k, v, dout, dq: (BH, T, D) contiguous, 16-byte aligned, of the element
// type `dtype` (0 fp32, 1 bf16, 2 fp16); lse, dd: (BH, T) fp32; bias:
// (BH / H, 1, T) fp32 or null.
extern "C" int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const float* bias, const void* dout,
                               const float* lse, const float* dd, void* dq,
                               int BH, int H, int T, int D, float scale,
                               int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, bias, dout, lse, dd, dq, BH, H, T, D,
                             scale, causal, s);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, bias, dout, lse, dd, dq, BH, H,
                                     T, D, scale, causal, s);
    case 2:
      return launch_d<__half>(q, k, v, bias, dout, lse, dd, dq, BH, H, T, D,
                              scale, causal, s);
    default: return MX_ERR_UNSUPPORTED_DTYPE;
  }
}
