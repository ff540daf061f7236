// K6 flash_bwd_dq: the query-parallel half of the FlashAttention-2
// backward, fp32 accuracy on the tensor cores, for the encoder
// self-attention of the BERT training step.
//
// Replaces: _bwd_dq_kernel in incubator_mxnet_tpu/kernels/flash_attention.py
// (launched by _flash_bwd_impl).  Same function: from q, k, v, dO (B*H, T, D),
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
// D is a template parameter in {16, 32, 64, 128}.
#include "flash_bwd_common.cuh"

namespace {

// q and dO tiles, then two stages of (K tile, V tile); rows of D + 4 floats
template <int D>
constexpr int smem_floats() {
  return 6 * kTile * (D + 4);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ bias,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd, float* __restrict__ dq,
                    int T, int H, float scale, int causal) {
  constexpr int LD = D + 4;
  constexpr int TILE = kTile * LD;
  constexpr int NO = D / 8;          // n-tiles of dQ
  extern __shared__ float smem[];    // [Q | dO | K0 | V0 | K1 | V1]
  float* qs = smem;
  float* dos = smem + TILE;

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
      float* dst = smem + (2 + 2 * ((j + 1) & 1)) * TILE;
      load_tile<D>(dst, k + base + static_cast<size_t>(k1) * D, T - k1);
      load_tile<D>(dst + TILE, v + base + static_cast<size_t>(k1) * D,
                   T - k1);
      cp_async_commit();
    }
    const float* ks_ = smem + (2 + 2 * (j & 1)) * TILE;
    const float* vs_ = ks_ + TILE;
    const int k0 = j * kTile;

    // s = Q K^T, dp = dO V^T; element e of n-tile n is row row_q[e >> 1],
    // key k0 + 8n + 2t + (e & 1)
    float s[kNT][4], dp[kNT][4];
    tile_products<D>(s, dp, qs + r0 * LD + t, ks_ + g * LD + t,
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
      acc_product<D>(acc, s[n], ks_ + (n * 8 + 2 * t) * LD + g);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_q[r] >= T) continue;
    float* out = dq + base + static_cast<size_t>(row_q[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias,
           const float* dout, const float* lse, const float* dd, float* dq,
           int BH, int H, int T, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T + kTile - 1) / kTile);
  flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, bias, dout, lse, dd, dq, T, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq: (BH, T, D) contiguous fp32, 16-byte aligned; lse, dd:
// (BH, T) fp32; bias: (BH / H, 1, T) fp32 or null.
extern "C" int mx_flash_bwd_dq(const float* q, const float* k, const float* v,
                               const float* bias, const float* dout,
                               const float* lse, const float* dd, float* dq,
                               int BH, int H, int T, int D, float scale,
                               int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, bias, dout, lse, dd, dq, BH, H, T, scale,
                        causal, s);
    case 32:
      return launch<32>(q, k, v, bias, dout, lse, dd, dq, BH, H, T, scale,
                        causal, s);
    case 64:
      return launch<64>(q, k, v, bias, dout, lse, dd, dq, BH, H, T, scale,
                        causal, s);
    case 128:
      return launch<128>(q, k, v, bias, dout, lse, dd, dq, BH, H, T, scale,
                         causal, s);
    default: return MX_ERR_UNSUPPORTED_D;
  }
}
