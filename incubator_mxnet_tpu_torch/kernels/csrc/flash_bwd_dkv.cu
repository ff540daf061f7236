// K7 flash_bwd_dkv: the key-parallel half of the FlashAttention-2 backward,
// fp32, for the encoder self-attention of the BERT training step.
//
// Replaces: _bwd_dkv_kernel in incubator_mxnet_tpu/kernels/flash_attention.py
// (launched by _flash_bwd_impl).  Same function: from q, k, v, dO (B*H, T, D),
// lse and dd (B*H, T) and an optional (B, 1, T) key bias,
//   dV = P^T dO,  dK = (P * (dP - dd))^T Q * scale,
//   dbs = the column sums of P * (dP - dd), (B*H, T) fp32,
// always written, as the Pallas kernel writes them; the wrapper sums dbs
// over the heads into the key bias's cotangent when the bias needs one.
//
// Bound on this card: about 8*B*H*T^2*D FLOP dense (four T x T x D
// products: S, dP, P^T dO and dS^T Q), half of that causal, against the
// bytes of reading q, k, v, dO once and writing dK, dV once.  fp32 FMAs on
// the CUDA cores, as K1 and K6.
//
// Design: one block of 256 threads owns a 64-key tile of one (batch, head);
// it keeps that tile's k, v and bias in shared memory and streams 64-row
// q/dO/lse/dd tiles, recomputing the S and dP patches
// (flash_bwd_common.cuh), writing the P and dS tiles to shared memory and
// accumulating dK and dV in registers (4 keys x D/16 columns each per
// thread).  A causal block starts at the first query tile that can see its
// keys, as the Pallas loop starts at kj * block_k // block_q.  D is a
// template parameter in {16, 32, 64, 128}.
#include "flash_bwd_common.cuh"

namespace {

using mx_bwd::kThreads;
using mx_bwd::kTile;

template <int D>
constexpr int smem_floats() {
  // ks, vs, qs, dos (rows padded to D + 1), the P and dS tiles, lse and dd
  // rows, the key bias
  return 4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 3 * kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dbs, int T,
                     int H, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LP = kTile + 1;
  constexpr int CPT = D / 16;  // dK / dV columns per thread
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* pt = dos + kTile * LD;
  float* dst = pt + kTile * LP;
  float* lse_s = dst + kTile * LP;
  float* dd_s = lse_s + kTile;
  float* bias_s = dd_s + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const size_t row_base = static_cast<size_t>(bh) * T;

  mx_bwd::load_rows<D>(ks, k + base, k0, T);
  mx_bwd::load_rows<D>(vs, v + base, k0, T);
  if (tid < kTile) {
    const int t = k0 + tid;
    bias_s[tid] = bias != nullptr && t < T
                      ? bias[static_cast<size_t>(bh / H) * T + t]
                      : 0.f;
  }

  float acc_k[4][CPT], acc_v[4][CPT], acc_b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc_b[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  }

  const int n_tiles = (T + kTile - 1) / kTile;
  for (int i0 = causal ? k0 / kTile : 0; i0 < n_tiles; ++i0) {
    const int q0 = i0 * kTile;
    __syncthreads();  // the previous tile's qs, dos, P and dS are consumed
    mx_bwd::load_rows<D>(qs, q + base, q0, T);
    mx_bwd::load_rows<D>(dos, dout + base, q0, T);
    if (tid < kTile) {
      const int t = q0 + tid;
      lse_s[tid] = t < T ? lse[row_base + t] : 0.f;
      dd_s[tid] = t < T ? dd[row_base + t] : 0.f;
    }
    __syncthreads();

    // patch: query rows ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
    mx_bwd::score_patches<D>(qs, dos, ks, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const float p = mx_bwd::prob(s[i][jj], bias_s[c], lse_s[r], q0 + r,
                                     k0 + c, T, scale, causal);
        pt[r * LP + c] = p;
        dst[r * LP + c] = p * (dp[i][jj] - dd_s[r]);
      }
    }
    __syncthreads();

    // accumulate: keys ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pv[4], dsv[4], ov[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt[r * LP + ty + 16 * i];
        dsv[i] = dst[r * LP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        ov[c] = dos[r * LD + tx + 16 * c];
        qv[c] = qs[r * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc_b[i] += dsv[i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc_v[i][c] = fmaf(pv[i], ov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(dsv[i], qv[c], acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t < T) {
      const size_t off = base + static_cast<size_t>(t) * D + tx;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        dk[off + 16 * c] = acc_k[i][c] * scale;
        dv[off + 16 * c] = acc_v[i][c];
      }
      if (tx == 0) dbs[row_base + t] = acc_b[i];
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias,
           const float* dout, const float* lse, const float* dd, float* dk,
           float* dv, float* dbs, int BH, int H, int T, float scale,
           int causal, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTile - 1) / kTile, BH);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, bias, dout, lse, dd, dk, dv, dbs, T, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dk, dv: (BH, T, D) contiguous fp32; lse, dd, dbs: (BH, T)
// fp32; bias: (BH / H, 1, T) fp32 or null.
extern "C" int mx_flash_bwd_dkv(const float* q, const float* k,
                                const float* v, const float* bias,
                                const float* dout, const float* lse,
                                const float* dd, float* dk, float* dv,
                                float* dbs, int BH, int H, int T, int D,
                                float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH, H, T,
                        scale, causal, s);
    case 32:
      return launch<32>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH, H, T,
                        scale, causal, s);
    case 64:
      return launch<64>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH, H, T,
                        scale, causal, s);
    case 128:
      return launch<128>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH, H, T,
                         scale, causal, s);
    default: return MX_ERR_UNSUPPORTED_D;
  }
}
