// K6 flash_bwd_dq: the query-parallel half of the FlashAttention-2
// backward, fp32, for the encoder self-attention of the BERT training step.
//
// Replaces: _bwd_dq_kernel in incubator_mxnet_tpu/kernels/flash_attention.py
// (launched by _flash_bwd_impl).  Same function: from q, k, v, dO (B*H, T, D),
// the forward's logsumexp lse and dd = rowsum(dO * O) - g_lse (B*H, T), and
// an optional (B, 1, T) key bias shared by the batch's H heads,
//   dQ = sum_j P * (dP - dd) K * scale,  P = exp(S - lse),  dP = dO V^T,
// where S = q k^T * scale + bias, masked as in the forward (K1).
//
// Bound on this card: about 6*B*H*T^2*D FLOP dense (three T x T x D
// products: S, dP and dS K), half of that causal, against the bytes of
// reading q, k, v, dO once and writing dQ once.  fp32 FMAs on the CUDA
// cores (67 TFLOP/s peak), as K1; wgmma/TMA pipelining is later work.
//
// Design: one block of 256 threads owns a 64-row query tile of one
// (batch, head); it keeps that tile's q and dO in shared memory and streams
// 64-key K/V tiles, recomputing the S and dP patches (flash_bwd_common.cuh),
// writing the dS tile to shared memory and accumulating dQ in registers
// (4 rows x D/16 columns per thread).  Causal blocks stop at the tile
// holding the diagonal, as _n_diag_blocks does.  The (T, T) matrices never
// exist in device memory.  D is a template parameter in {16, 32, 64, 128}.
#include "flash_bwd_common.cuh"

namespace {

using mx_bwd::kThreads;
using mx_bwd::kTile;

template <int D>
constexpr int smem_floats() {
  // qs, dos, ks, vs (rows padded to D + 1), the dS tile, lse and dd rows
  return 4 * kTile * (D + 1) + kTile * (kTile + 1) + 2 * kTile;
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
  constexpr int LD = D + 1;
  constexpr int LP = kTile + 1;
  constexpr int CPT = D / 16;  // dQ columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dst = vs + kTile * LD;
  float* lse_s = dst + kTile * LP;
  float* dd_s = lse_s + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const size_t row_base = static_cast<size_t>(bh) * T;
  const float* brow =
      bias != nullptr ? bias + static_cast<size_t>(bh / H) * T : nullptr;

  mx_bwd::load_rows<D>(qs, q + base, q0, T);
  mx_bwd::load_rows<D>(dos, dout + base, q0, T);
  if (tid < kTile) {
    const int t = q0 + tid;
    lse_s[tid] = t < T ? lse[row_base + t] : 0.f;
    dd_s[tid] = t < T ? dd[row_base + t] : 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  int n_tiles = (T + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (q0 + kTile - 1) / kTile + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's ks and dS are consumed
    mx_bwd::load_rows<D>(ks, k + base, k0, T);
    mx_bwd::load_rows<D>(vs, v + base, k0, T);
    __syncthreads();

    float s[4][4], dp[4][4];
    mx_bwd::score_patches<D>(qs, dos, ks, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj, tk = k0 + c;
        const float b = brow != nullptr && tk < T ? brow[tk] : 0.f;
        const float p = mx_bwd::prob(s[i][jj], b, lse_s[r], q0 + r, tk, T,
                                     scale, causal);
        dst[r * LP + c] = p * (dp[i][jj] - dd_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dst[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t < T) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        dq[base + static_cast<size_t>(t) * D + tx + 16 * c] = acc[i][c] * scale;
    }
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
  const dim3 grid((T + kTile - 1) / kTile, BH);
  flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, bias, dout, lse, dd, dq, T, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq: (BH, T, D) contiguous fp32; lse, dd: (BH, T) fp32;
// bias: (BH / H, 1, T) fp32 or null.
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
