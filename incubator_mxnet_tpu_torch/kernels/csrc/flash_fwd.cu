// K1 flash_fwd: online-softmax (FlashAttention-2) attention forward, fp32
// accuracy on the tensor cores, for the prefill self-attention of the GPT
// path and the encoder self-attention of the BERT training step.
//
// Replaces: _fwd_kernel in incubator_mxnet_tpu/kernels/flash_attention.py
// (launched by _flash_fwd_impl).  Same function: q, k, v (B*H, T, D) of one
// element type E (fp32, bf16 or fp16; fp32 inside, o written in E, as the
// Pallas kernel casts its blocks to fp32 and writes o in q's dtype),
// dense or causal, an optional (B, 1, T) additive key bias shared by the
// batch's H heads (indexed bh / H), keys past the diagonal or past T weigh
// exactly 0, and a fully masked row stays finite (the safe_m guard).
// With a non-null ``lse`` it also writes each row's logsumexp of the scaled,
// biased, masked scores, (B*H, T) fp32: the residual the backward (K6, K7)
// recomputes P from, as _fwd_kernel does under with_lse.  That output is a
// template parameter, so the serving path's instance has no lse code.
//
// Bound on this card: for a long prompt, operations.  Both products
// (S = Q K^T and O += P V, 4 * D FLOP per live (query, key) pair) run as
// 3xTF32 on the tensor cores: each fp32 operand x splits into
// hi = tf32(x) and lo = x - hi, and a_hi b_hi + a_hi b_lo + a_lo b_hi
// accumulates in fp32, which keeps the error near fp32's (~1e-6 relative)
// at three tensor-core products per product.  The bound is therefore the
// larger of the bytes (q, k, v read once, o written once) over 3.35 TB/s
// and 3 * 4 * D * pairs FLOP over the 495 TFLOP/s TF32 peak.
//
// Design: one block of 4 warps owns a 64-row query tile of one (batch,
// head); warp w owns rows 16w..16w+15 and keeps their S fragment, running
// max, partial sum and O accumulator in registers (mma.sync m16n8k8 tf32
// fragments).  Q is pre-scaled by scale * log2(e), so the scores come out
// in base-2 units and each softmax exponent is one ex2.approx (2 ulp); the
// lse converts back to base e.  The row max is a quad shuffle; the row sum
// stays per thread until the end.  P never leaves registers: the PV product reads P's
// accumulator fragment as its A fragment with the keys of each 8-key step
// permuted (A column t is key 2t, column t + 4 is key 2t + 1), and reads V
// in the same permuted order, so no shuffle or shared-memory re-layout is
// needed.  K/V tiles of 64 keys are double-buffered in shared memory with
// cp.async (16 bytes a thread; rows past T zero-filled), one barrier per
// tile: the next tile's copy is issued right after the barrier and
// overlaps this tile's products.  Rows are padded to D + 4 floats, which
// makes every fragment read of K (row = key) and of V (row = key, in the
// permuted order) free of bank conflicts.  The query tile is staged once
// through the second stage's buffer.  The grid is (B*H, query tiles);
// under causal the query tiles run in reverse, so the heaviest tiles of
// every head are scheduled first, and a causal block stops at the tile
// holding its diagonal.  D is a template parameter in {16, 32, 64, 128},
// and so is E: 16-bit tiles (rows of D + 8) halve the shared memory and the
// bytes, and K and V, exact in TF32, need 2 products a product, not 3
// (tf32_mma.cuh mma_split).
#include "tf32_mma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kWarps = 4;      // 16 query rows each
constexpr int kThreads = 32 * kWarps;

// two stages of (K tile, V tile), rows padded by 16 bytes
template <int D, typename E>
constexpr int smem_bytes() {
  return 4 * kBK * row_stride<D, E>() * static_cast<int>(sizeof(E));
}

template <int D, bool kLse, typename E>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, const float* __restrict__ bias,
                 E* __restrict__ o, float* __restrict__ lse, int T,
                 int H, float scale, int causal) {
  constexpr int LD = row_stride<D, E>();  // padded row stride
  constexpr int TILE = kBK * LD;     // elements of one K or V tile
  constexpr int KS = D / 8;          // k-steps of S = Q K^T
  constexpr int NO = D / 8;          // n-tiles of O
  constexpr int NS = kBK / 8;        // n-tiles of S = k-steps of P V
  constexpr bool kX = kExact<E>;     // K and V exact in TF32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);   // [K0 | V0 | K1 | V1]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBQ;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* brow =
      bias != nullptr ? bias + static_cast<size_t>(bh / H) * T : nullptr;
  int n_tiles = (T + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  // the query tile goes through stage 1's K buffer, tile 0 to stage 0
  E* qs = smem + 2 * TILE;
  load_tile<D>(qs, q + base + static_cast<size_t>(q0) * D, T - q0);
  load_tile<D>(smem, k + base, T);
  load_tile<D>(smem + TILE, v + base, T);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this thread's rows r0 and r0 + 8, pre-scaled by scale * log2(e): the
  // scores come out in base-2 units, and the softmax exponent is one
  // subtraction and one ex2
  const int r0 = warp * 16 + g;
  const float qscale = scale * kLog2e;
  float qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qf[ks][0] = to_f(qs[r0 * LD + ks * 8 + t]) * qscale;
    qf[ks][1] = to_f(qs[(r0 + 8) * LD + ks * 8 + t]) * qscale;
    qf[ks][2] = to_f(qs[r0 * LD + ks * 8 + t + 4]) * qscale;
    qf[ks][3] = to_f(qs[(r0 + 8) * LD + ks * 8 + t + 4]) * qscale;
  }
  const int row_q[2] = {q0 + r0, q0 + r0 + 8};

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    // tile j has landed, and every warp is done with tile j - 1 (and, at
    // j = 0, with the query tile), so its stage may be refilled
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_tiles) {
      const int k1 = (j + 1) * kBK;
      E* dst = smem + ((j + 1) & 1) * 2 * TILE;
      load_tile<D>(dst, k + base + static_cast<size_t>(k1) * D, T - k1);
      load_tile<D>(dst + TILE, v + base + static_cast<size_t>(k1) * D,
                   T - k1);
      cp_async_commit();
    }
    const E* ks_ = smem + (j & 1) * 2 * TILE;
    const E* vs_ = ks_ + TILE;
    const int k0 = j * kBK;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const FragA a(qf[ks]);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const E* kr = ks_ + (n * 8 + g) * LD + ks * 8 + t;
        const float b[2] = {to_f(kr[0]), to_f(kr[4])};
        mma_split<false, kX>(s[n], a, b);
      }
    }

    // key bias (in base-2 units), and -inf past T and past the diagonal;
    // element e of n-tile n is row row_q[e >> 1], key k0 + 8n + 2t + (e & 1)
    const bool edge = k0 + kBK > T || (causal && k0 + kBK - 1 > q0);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        float val = s[n][e];
        if (brow != nullptr && key < T)
          val = fmaf(__ldg(brow + key), kLog2e, val);
        if (edge && (key >= T || (causal && key > row_q[e >> 1])))
          val = -CUDART_INF_F;
        s[n][e] = val;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // a row with every key so far masked keeps m = -inf: pin its
      // exponent base to 0 so exp(-inf - -inf) never makes a NaN; with a
      // finite base, exp(-inf - safe) is exactly 0, so a masked score (and
      // a first tile's alpha) needs no branch
      const float safe = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = exp2_approx(m[r] - safe);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = exp2_approx(s[n][e] - safe);
          s[n][e] = p;
          l[r] += p;
        }
      }
    }

    // O += P V over the 8 key steps of the tile, keys permuted as above
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
      const FragA a(p);
      const E* vr = vs_ + (n * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int no = 0; no < NO; ++no) {
        const float b[2] = {to_f(vr[no * 8]), to_f(vr[LD + no * 8])};
        mma_split<false, kX>(acc[no], a, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row_q[r];
    if (row >= T) continue;
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    E* orow = o + base + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(orow + n * 8, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (kLse && t == 0) {
      const float safe = m[r] == -CUDART_INF_F ? 0.f : m[r];
      lse[static_cast<size_t>(bh) * T + row] =
          safe * kLn2 + logf(fmaxf(sum, 1e-30f));
    }
  }
}

template <int D, typename E>
int launch(const void* q_, const void* k_, const void* v_,
           const float* bias, void* o_, float* lse, int BH, int H, int T,
           float scale, int causal, cudaStream_t stream) {
  const E* q = static_cast<const E*>(q_);
  const E* k = static_cast<const E*>(k_);
  const E* v = static_cast<const E*>(v_);
  E* o = static_cast<E*>(o_);
  const int bytes = smem_bytes<D, E>();
  auto kernel = lse != nullptr ? flash_fwd_kernel<D, true, E>
                               : flash_fwd_kernel<D, false, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, bias, o, lse, T, H, scale,
                                            causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_d(const void* q, const void* k, const void* v, const float* bias,
             void* o, float* lse, int BH, int H, int T, int D, float scale,
             int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<16, E>(q, k, v, bias, o, lse, BH, H, T, scale, causal, s);
    case 32:
      return launch<32, E>(q, k, v, bias, o, lse, BH, H, T, scale, causal, s);
    case 64:
      return launch<64, E>(q, k, v, bias, o, lse, BH, H, T, scale, causal, s);
    case 128:
      return launch<128, E>(q, k, v, bias, o, lse, BH, H, T, scale, causal,
                            s);
    default: return MX_ERR_UNSUPPORTED_D;
  }
}

}  // namespace

// q, k, v, o: (BH, T, D) contiguous, 16-byte aligned, of the element type
// `dtype` (0 fp32, 1 bf16, 2 fp16); bias: (BH / H, 1, T) fp32 or null;
// lse: (BH, T) fp32 or null (then no logsumexp is written).
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            const float* bias, void* o, float* lse, int BH,
                            int H, int T, int D, float scale, int causal,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, bias, o, lse, BH, H, T, D, scale,
                             causal, s);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, bias, o, lse, BH, H, T, D,
                                     scale, causal, s);
    case 2:
      return launch_d<__half>(q, k, v, bias, o, lse, BH, H, T, D, scale,
                              causal, s);
    default: return MX_ERR_UNSUPPORTED_DTYPE;
  }
}
