// K1 flash_fwd: online-softmax (FlashAttention-2 style) attention forward,
// fp32, for the prefill self-attention of the GPT path and the encoder
// self-attention of the BERT training step.
//
// Replaces: _fwd_kernel in incubator_mxnet_tpu/kernels/flash_attention.py
// (launched by _flash_fwd_impl).  Same function: q, k, v (B*H, T, D) fp32,
// dense or causal, an optional (B, 1, T) additive key bias shared by the
// batch's H heads (indexed bh / H), keys past the diagonal or past T weigh
// exactly 0, and a fully masked row stays finite (the safe_m guard).
// With a non-null ``lse`` it also writes each row's logsumexp of the scaled,
// biased, masked scores, (B*H, T) fp32: the residual the backward (K6, K7)
// recomputes P from, as _fwd_kernel does under with_lse.  That output is a
// template parameter, so the serving path's instance (no lse) compiles to
// the same code as a kernel without the output.
//
// Bound on this card: for a long prompt the kernel is bound by operations,
// about 2*B*H*T^2*D FLOP causal (half of dense), against the bytes of
// reading q, k, v once and writing o once.  The data is fp32 and the
// result must agree with the fp32 plain version to 1e-4, so the products
// run as fp32 FMAs on the CUDA cores (67 TFLOP/s peak), not as TF32 on the
// tensor cores.
//
// Design: one block of 256 threads owns a 64-row query tile of one
// (batch, head) and streams 64-key K/V tiles through shared memory, keeping
// a running max, sum and fp32 accumulator per row, so the (T, T) score
// matrix never exists in device memory.  Each thread computes a 4 x 4
// patch of the score tile from shared memory (rows padded by one float to
// dodge bank conflicts); one warp per 8 rows does the softmax update; each
// thread keeps 4 rows x D/16 columns of the output in registers.  Causal
// blocks stop at the tile holding the diagonal.  D is a template
// parameter in {16, 32, 64, 128}.  wgmma/TMA pipelining is later work.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid over a 64 x 64 tile

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1) + 3 * kBQ;
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int T,
                 int H, float scale, int causal) {
  constexpr int LD = D + 1;    // padded row stride of the q and k tiles
  constexpr int LP = kBK + 1;  // padded row stride of the score tile
  constexpr int CPT = D / 16;  // output columns per thread
  constexpr int RPW = kBQ / (kThreads / 32);  // softmax rows per warp
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * D;
  float* row_m = ps + kBQ * LP;
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* brow =
      bias != nullptr ? bias + static_cast<size_t>(bh / H) * T : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    qs[r * LD + c] = t < T ? q[base + static_cast<size_t>(t) * D + c] : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = -CUDART_INF_F;
    row_l[tid] = 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  int n_tiles = (T + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's ps / vs are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, t = k0 + r;
      const size_t off = base + static_cast<size_t>(t) * D + c;
      ks[r * LD + c] = t < T ? k[off] : 0.f;
      vs[r * D + c] = t < T ? v[off] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = ks[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int r = ty + 16 * i, c = tx + 16 * jj;
        const int tq = q0 + r, tk = k0 + c;
        float val = s[i][jj] * scale;
        if (brow != nullptr && tk < T) val += brow[tk];
        if (tk >= T || (causal && tk > tq)) val = -CUDART_INF_F;
        ps[r * LP + c] = val;
      }
    }
    __syncthreads();

    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      float a = ps[r * LP + lane], b = ps[r * LP + lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx_warp_max(fmaxf(a, b)));
      // a row with every key so far masked keeps m = -inf: pin its
      // exponent base to 0 so exp(-inf - -inf) never makes a NaN
      const float safe = m_new == -CUDART_INF_F ? 0.f : m_new;
      a = a == -CUDART_INF_F ? 0.f : expf(a - safe);
      b = b == -CUDART_INF_F ? 0.f : expf(b - safe);
      const float sum = mx_warp_sum(a + b);
      ps[r * LP + lane] = a;
      ps[r * LP + lane + 32] = b;
      if (lane == 0) {
        const float alpha = m_old == -CUDART_INF_F ? 0.f : expf(m_old - safe);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_a[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t < T) {
      const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        o[base + static_cast<size_t>(t) * D + tx + 16 * c] = acc[i][c] * inv;
    }
  }
  // row_m / row_l were last written before the loop's final barrier
  if (kLse && tid < kBQ && q0 + tid < T) {
    const float m = row_m[tid];
    const float safe = m == -CUDART_INF_F ? 0.f : m;
    lse[static_cast<size_t>(bh) * T + q0 + tid] =
        safe + logf(fmaxf(row_l[tid], 1e-30f));
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* o, float* lse, int BH, int H, int T, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = lse != nullptr ? flash_fwd_kernel<D, true>
                               : flash_fwd_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, bias, o, lse, T, H, scale,
                                            causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (BH, T, D) contiguous fp32; bias: (BH / H, 1, T) fp32 or null;
// lse: (BH, T) fp32 or null (then no logsumexp is written).
extern "C" int mx_flash_fwd(const float* q, const float* k, const float* v,
                            const float* bias, float* o, float* lse, int BH,
                            int H, int T, int D, float scale, int causal,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, bias, o, lse, BH, H, T, scale, causal, s);
    case 32: return launch<32>(q, k, v, bias, o, lse, BH, H, T, scale, causal, s);
    case 64: return launch<64>(q, k, v, bias, o, lse, BH, H, T, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, bias, o, lse, BH, H, T, scale, causal, s);
    default: return MX_ERR_UNSUPPORTED_D;
  }
}
