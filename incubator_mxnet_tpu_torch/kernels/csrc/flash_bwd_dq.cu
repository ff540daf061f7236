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
// D is a template parameter in {16, 32, 64, 128}.  That is the fp32 body
// (flash_bwd_dq_kernel).
//
// bf16, fp16 (flash_bwd_dq16_kernel).  Bound: the same three products at the
// card's 16-bit tensor-core rate (989 TFLOP/s), or at short T the bytes.
// S = Q K^T and dP = dO V^T are wgmma m64n64k16 products of the unscaled
// 16-bit tiles (exact products, fp32 sums); the scale, the key bias and lse
// come after, in prob()'s order; dS = P * (dP - dd) is fp32 in S's registers
// and goes into dQ += dS K in two 16-bit parts (row-scaled in fp16:
// flash_bwd_common.cuh), two wgmma with A from registers (the accumulator
// layout is the A-fragment layout, so dS never moves) and K read MN-major
// through the transpose bit.  So the kernel does 4 products where the
// function needs 3: it is bound at 4/3x the function's bound by operations.
// Layout: K1's 16-bit one (flash_fwd.cu).  A block is one warpgroup that owns
// 64 query rows of one (batch, head) and keeps S, dP (32 floats a thread
// each), dS's two parts and dQ in registers; three blocks share a
// multiprocessor (two at D = 128): at four, ptxas capped a thread at 128
// registers, spilled 44-72 bytes, and the kernel ran 3-18 % slower at the
// 16-bit paths' shapes (PERF.md §6).  Thread 0 brings the block's Q and dO
// tiles in once by TMA (4 3-D (D, T, B*H) maps, passed as __grid_constant__
// so a captured graph replays them; rows past T arrive as zeros), then K and
// V tiles of 64 keys into a ring of kStages16 stages, a full barrier for K
// and one for V per stage (S starts when K lands); a stage is refilled after
// the block's dS K products of it.  Per tile S and dP are issued before the
// first wait, and P is formed while dP is still running.  Under causal the
// query tiles run in reverse and a block stops at its diagonal tile; only
// edge tiles mask.  No atomics: two launches with K7, deterministic bit for
// bit.
#include "flash_bwd_common.cuh"

namespace {

// q and dO tiles, then two stages of (K tile, V tile); rows padded by 16
// bytes
template <int D>
constexpr int smem_bytes() {
  return 6 * kTile * row_stride<D>() * static_cast<int>(sizeof(float));
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
  constexpr int LD = row_stride<D>();
  constexpr int TILE = kTile * LD;
  constexpr int NO = D / 8;          // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [Q | dO | K0 | V0 | K1 | V1]
  float* smem = reinterpret_cast<float*>(smem_raw);
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
      store2(out + n * 8, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------
// the 16-bit instances: wgmma products, tiles through TMA

// blocks a multiprocessor keeps resident (registers: 65536 / (128 x this)
// a thread; shared memory: SmemDq16<D>::kBytes a block)
template <int D>
constexpr int dq16_blocks_per_sm() {
  return D == 128 ? 2 : 3;
}

// dynamic shared memory: the Q and dO tiles, the K ring, the V ring, the
// barriers, and the slack that aligns the base to 1024 bytes
template <int D>
struct SmemDq16 {
  static constexpr int kTileBytes = tile_bytes<D>();  // one 64-row tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kTileBytes;
  static constexpr int kK = kDO + kTileBytes;
  static constexpr int kV = kK + kStages16 * kTileBytes;
  static constexpr int kBar = kV + kStages16 * kTileBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages16) + 1024;
};

template <int D, typename E>
__global__ void __launch_bounds__(128, dq16_blocks_per_sm<D>())
flash_bwd_dq16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ bias,
                      const float* __restrict__ lse,
                      const float* __restrict__ dd, E* __restrict__ dq,
                      int T, int H, float scale, int causal) {
  using L = SmemDq16<D>;
  constexpr int NCB = D > 64 ? D / 64 : 1;  // column blocks of a tile
  constexpr int NB = D > 64 ? 64 : D;       // their columns: N of dS K
  constexpr bool kScaled = std::is_same<E, __half>::value;
  extern __shared__ __align__(16) unsigned char smem16_raw[];
  unsigned char* smem =
      smem16_raw + ((1024 - (smem_u32(smem16_raw) & 1023)) & 1023);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + kStages16;

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kTile;
  const int nk = (T + kTile - 1) / kTile;
  // the key tiles the block streams: under causal, up to its diagonal
  const int n_tiles = causal ? min(nk, qt + 1) : nk;

  // thread 0 issues every copy: K and V tile j into stage j % kStages16
  auto load_kv = [&](int j) {
    const int st = j % kStages16;
    unsigned char* kd = smem + L::kK + st * L::kTileBytes;
    unsigned char* vd = smem + L::kV + st * L::kTileBytes;
    mbar_expect_tx(kfull + st, L::kTileBytes);
    for (int cb = 0; cb < NCB; ++cb)
      tma_load_3d(kd + cb * tile_block_bytes<D>(), &tk, kfull + st, cb * 64,
                  j * kTile, bh);
    mbar_expect_tx(vfull + st, L::kTileBytes);
    for (int cb = 0; cb < NCB; ++cb)
      tma_load_3d(vd + cb * tile_block_bytes<D>(), &tv, vfull + st, cb * 64,
                  j * kTile, bh);
  };
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
#pragma unroll
    for (int s = 0; s < kStages16; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
    }
    mbar_fence_init();
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    tma_prefetch(&tdo);
    mbar_expect_tx(qfull, 2 * L::kTileBytes);
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load_3d(smem + L::kQ + cb * tile_block_bytes<D>(), &tq, qfull,
                  cb * 64, q0, bh);
      tma_load_3d(smem + L::kDO + cb * tile_block_bytes<D>(), &tdo, qfull,
                  cb * 64, q0, bh);
    }
    for (int j = 0; j < kStages16 && j < n_tiles; ++j) load_kv(j);
  }
  __syncthreads();

  // this thread's rows r0 and r0 + 8 (the accumulator layout of
  // hopper_16.cuh), their lse and dd
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = q0 + 16 * warp + (lane >> 2);
  const size_t row_base = static_cast<size_t>(bh) * T;
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = r0 + 8 * r < T;
    lse_r[r] = ok ? lse[row_base + r0 + 8 * r] : 0.f;
    dd_r[r] = ok ? dd[row_base + r0 + 8 * r] : 0.f;
  }
  const float* brow =
      bias != nullptr ? bias + static_cast<size_t>(bh / H) * T : nullptr;
  const uint32_t qa = smem_u32(smem + L::kQ);
  const uint32_t doa = smem_u32(smem + L::kDO);
  const uint32_t ka = smem_u32(smem + L::kK);
  const uint32_t va = smem_u32(smem + L::kV);

  float acc[NCB][NB / 2];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[cb][i] = 0.f;
  int ex[2] = {126, 126};          // fp16: dS rows scaled by 2^ex

  mbar_wait(qfull, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages16;
    const uint32_t par = (j / kStages16) & 1;
    const uint32_t kst = ka + st * L::kTileBytes;
    const int k0 = j * kTile;

    // S = Q K^T and dP = dO V^T: unscaled, exact 16-bit products summed
    // in fp32, both issued before the first wait
    float s[32], dp[32];
    mbar_wait(kfull + st, par);
    wgmma_fence();
    score_product16<D, E>(s, qa, kst);
    mbar_wait(vfull + st, par);
    wgmma_fence();
    score_product16<D, E>(dp, doa, va + st * L::kTileBytes);
    wgmma_wait<1>();
    fence_regs(s);

    // P (element i: row r0 + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + 2t
    // + (i & 1)), exactly 0 past T and past the diagonal
    const bool edge = k0 + kTile > T || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int r = (i >> 1) & 1;
      const float b = brow != nullptr && key < T ? __ldg(brow + key) : 0.f;
      float p = prob(s[i], scale, b, lse_r[r]);
      if (edge && (key >= T || (causal && key > r0 + 8 * r))) p = 0.f;
      s[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - dd_r[(i >> 1) & 1];  // dS
    if constexpr (kScaled) row_scale<NCB, NB>(s, ex, acc);

    // dQ += dS_hi K + dS_lo K, K read MN-major
    uint32_t hi[4][4], lo[4][4];
    split_a<E>(s, hi, lo);
    acc_products16<D, E, NCB, NB>(acc, hi, lo, kst);
    wgmma_wait<0>();
    fence_acc<NCB, NB>(acc, hi, lo);
    // every warp is done with stage st: refill it with tile j + kStages16
    if (j + kStages16 < n_tiles) {
      __syncthreads();
      if (threadIdx.x == 0) load_kv(j + kStages16);
    }
  }

  const size_t base = row_base * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= T) continue;
    const float f = kScaled ? pow2i(-ex[r]) : 1.f;
    E* out = dq + base + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int n = 0; n < NB / 8; ++n)
        store2(out + 64 * cb + 8 * n, acc[cb][4 * n + 2 * r] * f * scale,
               acc[cb][4 * n + 2 * r + 1] * f * scale);
  }
}

template <int D, typename E>
int launch16(const void* q, const void* k, const void* v, const float* bias,
             const void* dout, const float* lse, const float* dd, void* dq,
             int BH, int H, int T, float scale, int causal,
             cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_tile_map<E>(&tq, q, BH, T, D);
  if (rc == 0) rc = make_tile_map<E>(&tk, k, BH, T, D);
  if (rc == 0) rc = make_tile_map<E>(&tv, v, BH, T, D);
  if (rc == 0) rc = make_tile_map<E>(&tdo, dout, BH, T, D);
  if (rc != 0) return rc;
  constexpr int bytes = SmemDq16<D>::kBytes;
  // the blocks a multiprocessor keeps fit its 228 KB of shared memory
  // (1 KB of it reserved per block)
  static_assert((bytes + 1024) * dq16_blocks_per_sm<D>() <= 228 * 1024,
                "shared memory of the resident blocks");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq16_kernel<D, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T + kTile - 1) / kTile);
  flash_bwd_dq16_kernel<D, E><<<grid, 128, bytes, stream>>>(
      tq, tk, tv, tdo, bias, lse, dd, static_cast<E*>(dq), T, H, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const void* dout, const float* lse, const float* dd, void* dq,
           int BH, int H, int T, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T + kTile - 1) / kTile);
  flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<const float*>(dout),
      lse, dd, static_cast<float*>(dq), T, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the fp32 body's instance for E = float, the 16-bit body's otherwise
template <int D, typename E>
int launch_e(const void* q, const void* k, const void* v, const float* bias,
             const void* dout, const float* lse, const float* dd, void* dq,
             int BH, int H, int T, float scale, int causal, cudaStream_t s) {
  if constexpr (std::is_same<E, float>::value)
    return launch<D>(q, k, v, bias, dout, lse, dd, dq, BH, H, T, scale,
                     causal, s);
  else
    return launch16<D, E>(q, k, v, bias, dout, lse, dd, dq, BH, H, T, scale,
                          causal, s);
}

template <typename E>
int launch_d(const void* q, const void* k, const void* v, const float* bias,
             const void* dout, const float* lse, const float* dd, void* dq,
             int BH, int H, int T, int D, float scale, int causal,
             cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_e<16, E>(q, k, v, bias, dout, lse, dd, dq, BH, H, T,
                             scale, causal, s);
    case 32:
      return launch_e<32, E>(q, k, v, bias, dout, lse, dd, dq, BH, H, T,
                             scale, causal, s);
    case 64:
      return launch_e<64, E>(q, k, v, bias, dout, lse, dd, dq, BH, H, T,
                             scale, causal, s);
    case 128:
      return launch_e<128, E>(q, k, v, bias, dout, lse, dd, dq, BH, H, T,
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
