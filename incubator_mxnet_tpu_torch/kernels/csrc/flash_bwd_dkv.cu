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
// template parameter in {16, 32, 64, 128}.  That is the fp32 body
// (flash_bwd_dkv_kernel).
//
// bf16, fp16 (flash_bwd_dkv16_kernel).  Bound: the same four products at the
// card's 16-bit tensor-core rate (989 TFLOP/s), or at short T the bytes.
// S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 products of the unscaled
// 16-bit tiles, both read K-major (exact products, fp32 sums); P^T (lse per
// column, in prob()'s order) and dS^T = P^T * (dP^T - dd[column]) are fp32 in
// the scores' registers, and each goes into its product in two 16-bit parts
// (scaled in fp16: flash_bwd_common.cuh), A from registers: dV += P^T_hi
// dO + P^T_lo dO, then dK += dS^T_hi Q + dS^T_lo Q, dO and Q read MN-major
// through the transpose bit.  dS^T's fp32 row sums go into the dbs partials
// before its split.  So the kernel does 6 products where the function needs
// 4: it is bound at 6/4x the function's bound by operations.  Layout: K1's
// 16-bit one (flash_fwd.cu) with keys as the M side.  A block is one
// warpgroup that owns 64 keys of one (batch, head) and keeps dK, dV, S^T,
// dP^T (32 floats a thread each at D = 64) and one hi/lo pair, used for P^T
// and then for dS^T, in registers; three blocks share a multiprocessor (two
// at D = 128, where the two accumulators take 128 floats and ptxas uses
// 253-255 registers): at two, 198-206 registers, the kernel ran 1-8 % slower
// at three of the 16-bit paths' four shapes (PERF.md §6).  Thread 0 brings
// the block's K and V tiles in once by TMA (4 3-D (D, T, B*H) maps as
// __grid_constant__; rows past T arrive as zeros), then the Q and dO tiles of
// 64 queries into a ring of kStages16 stages, a full barrier for Q and one
// for dO per stage; each query tile's lse and dd rows (fp32, 4-byte aligned
// only, which a TMA map's 16-byte strides do not allow at a ragged T) come in
// beside it by 4-byte cp.async from every thread.  Per tile S^T and dP^T are
// issued before the first wait, and dS^T's row scaling runs under the dV
// products.  Under causal a block starts at the first query tile that sees
// its keys, so key tile 0 goes first.  The dbs partials meet by quad shuffle
// at the end and are always written.
#include "flash_bwd_common.cuh"

namespace {

// K and V tiles, two stages of (q tile, dO tile) with rows padded by 16
// bytes, and two stages of fp32 (lse row, dd row)
template <int D>
constexpr int smem_bytes() {
  return 6 * kTile * row_stride<D>() * static_cast<int>(sizeof(float)) +
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

// query tile i's q, dO (row stride row_stride<D>()) and its lse, dd
// values
template <int D>
__device__ __forceinline__ void load_query_tile(float* qs, float* rows,
                                                const float* q,
                                                const float* dout,
                                                const float* lse,
                                                const float* dd, int q0,
                                                int T) {
  load_tile<D>(qs, q + static_cast<size_t>(q0) * D, T - q0);
  load_tile<D>(qs + kTile * row_stride<D>(),
               dout + static_cast<size_t>(q0) * D, T - q0);
  const int i = threadIdx.x & (kTile - 1);
  const bool ok = q0 + i < T;
  const float* src = threadIdx.x < kTile ? lse : dd;
  cp_async4(rows + threadIdx.x, ok ? src + q0 + i : src, ok);
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
  constexpr int LD = row_stride<D>();
  constexpr int TILE = kTile * LD;
  constexpr int NO = D / 8;          // n-tiles of dK and dV
  // [K | V | q0 | dO0 | q1 | dO1 | lse0 dd0 | lse1 dd1]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const float* ks_ = smem;
  const float* vs_ = smem + TILE;
  float* rows_s = smem + 6 * TILE;

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
  load_query_tile<D>(smem + 2 * TILE, rows_s, q + base, dout + base,
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
      load_query_tile<D>(smem + (2 + 2 * (stage ^ 1)) * TILE,
                         rows_s + (stage ^ 1) * 2 * kTile, q + base,
                         dout + base, lse + row_base, dd + row_base,
                         (i + 1) * kTile, T);
      cp_async_commit();
    }
    const float* qs = smem + (2 + 2 * stage) * TILE;
    const float* dos = qs + TILE;
    const float* lse_s = rows_s + stage * 2 * kTile;
    const float* dd_s = lse_s + kTile;
    const int q0 = i * kTile;

    // st = K q^T, dpt = V dO^T; element e of n-tile n is key key[e >> 1],
    // query q0 + 8n + 2t + (e & 1)
    float st[kNT][4], dpt[kNT][4];
    tile_products<D>(st, dpt, ks_ + r0 * LD + t, qs + g * LD + t,
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
      acc_product<D>(acc_v, st[n], dos + row);
      acc_product<D>(acc_k, dpt[n], qs + row);
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

// ---------------------------------------------------------------------
// the 16-bit instances: wgmma products, tiles through TMA

// blocks a multiprocessor keeps resident (registers: 65536 / (128 x this)
// a thread; shared memory: SmemDkv16<D>::kBytes a block)
template <int D>
constexpr int dkv16_blocks_per_sm() {
  return D == 128 ? 2 : 3;
}

// dynamic shared memory: the K and V tiles, the Q ring, the dO ring, the
// (lse, dd) rows of each stage, the barriers, and the slack that aligns
// the base to 1024 bytes
template <int D>
struct SmemDkv16 {
  static constexpr int kTileBytes = tile_bytes<D>();  // one 64-row tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTileBytes;
  static constexpr int kQ = kV + kTileBytes;
  static constexpr int kDO = kQ + kStages16 * kTileBytes;
  static constexpr int kRows = kDO + kStages16 * kTileBytes;
  static constexpr int kBar = kRows + kStages16 * 2 * kTile * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages16) + 1024;
};

template <int D, typename E>
__global__ void __launch_bounds__(128, dkv16_blocks_per_sm<D>())
flash_bwd_dkv16_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ bias,
                       const float* __restrict__ lse,
                       const float* __restrict__ dd, E* __restrict__ dk,
                       E* __restrict__ dv, float* __restrict__ dbs, int T,
                       int H, float scale, int causal) {
  using L = SmemDkv16<D>;
  constexpr int NCB = D > 64 ? D / 64 : 1;  // column blocks of a tile
  constexpr int NB = D > 64 ? 64 : D;       // their columns: N of dK, dV
  constexpr bool kScaled = std::is_same<E, __half>::value;
  extern __shared__ __align__(16) unsigned char smem16_raw[];
  unsigned char* smem =
      smem16_raw + ((1024 - (smem_u32(smem16_raw) & 1023)) & 1023);
  float* rows_s = reinterpret_cast<float*>(smem + L::kRows);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* qfull = kvfull + 1;
  uint64_t* dofull = qfull + kStages16;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const size_t row_base = static_cast<size_t>(bh) * T;
  // the query tiles the block streams: under causal, from its diagonal
  const int first = causal ? blockIdx.y : 0;
  const int n_tiles = (T + kTile - 1) / kTile - first;

  // thread 0 issues the tiles' copies: Q and dO tile first + i into stage
  // i % kStages16; every thread one value of the tile's lse and dd rows
  auto load_q = [&](int i) {
    const int st = i % kStages16, q0 = (first + i) * kTile;
    unsigned char* qd = smem + L::kQ + st * L::kTileBytes;
    unsigned char* dod = smem + L::kDO + st * L::kTileBytes;
    mbar_expect_tx(qfull + st, L::kTileBytes);
    for (int cb = 0; cb < NCB; ++cb)
      tma_load_3d(qd + cb * tile_block_bytes<D>(), &tq, qfull + st, cb * 64,
                  q0, bh);
    mbar_expect_tx(dofull + st, L::kTileBytes);
    for (int cb = 0; cb < NCB; ++cb)
      tma_load_3d(dod + cb * tile_block_bytes<D>(), &tdo, dofull + st,
                  cb * 64, q0, bh);
  };
  auto load_rows = [&](int i) {
    const int q = (first + i) * kTile + (threadIdx.x & (kTile - 1));
    const float* src = (threadIdx.x < kTile ? lse : dd) + row_base;
    cp_async4(rows_s + (i % kStages16) * 2 * kTile + threadIdx.x,
              q < T ? src + q : src, q < T);
  };
  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
#pragma unroll
    for (int s = 0; s < kStages16; ++s) {
      mbar_init(qfull + s, 1);
      mbar_init(dofull + s, 1);
    }
    mbar_fence_init();
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    tma_prefetch(&tdo);
    mbar_expect_tx(kvfull, 2 * L::kTileBytes);
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load_3d(smem + L::kK + cb * tile_block_bytes<D>(), &tk, kvfull,
                  cb * 64, k0, bh);
      tma_load_3d(smem + L::kV + cb * tile_block_bytes<D>(), &tv, kvfull,
                  cb * 64, k0, bh);
    }
    for (int i = 0; i < kStages16 && i < n_tiles; ++i) load_q(i);
  }
  for (int i = 0; i < kStages16 && i < n_tiles; ++i) load_rows(i);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this thread's keys r0 and r0 + 8 (the accumulator layout of
  // hopper_16.cuh), and their bias
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = k0 + 16 * warp + (lane >> 2);
  float b[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    b[r] = bias != nullptr && r0 + 8 * r < T
               ? bias[static_cast<size_t>(bh / H) * T + r0 + 8 * r]
               : 0.f;
  const uint32_t ka = smem_u32(smem + L::kK);
  const uint32_t va = smem_u32(smem + L::kV);
  const uint32_t qa = smem_u32(smem + L::kQ);
  const uint32_t doa = smem_u32(smem + L::kDO);

  float acc_k[NCB][NB / 2], acc_v[NCB][NB / 2];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc_k[cb][i] = acc_v[cb][i] = 0.f;
  float dsum[2] = {0.f, 0.f};
  int ex[2] = {126, 126};            // fp16: dS^T rows scaled by 2^ex
  constexpr float kP = kScaled ? 16384.f : 1.f;  // fp16: P^T scaled by 2^14

  mbar_wait(kvfull, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages16;
    const uint32_t par = (i / kStages16) & 1;
    const uint32_t qst = qa + st * L::kTileBytes;
    const uint32_t dost = doa + st * L::kTileBytes;
    const float* lse_s = rows_s + st * 2 * kTile;
    const float* dd_s = lse_s + kTile;
    const int q0 = (first + i) * kTile;

    // S^T = K Q^T and dP^T = V dO^T: unscaled, exact 16-bit products
    // summed in fp32, both issued before the first wait
    float s[32], dp[32];
    mbar_wait(qfull + st, par);
    wgmma_fence();
    score_product16<D, E>(s, ka, qst);
    mbar_wait(dofull + st, par);
    wgmma_fence();
    score_product16<D, E>(dp, va, dost);
    wgmma_wait<1>();
    fence_regs(s);

    // P^T (element 4n + e: key r0 + 8 (e >> 1), query q0 + 8n + 2t +
    // (e & 1)), exactly 0 past T and before the diagonal
    const bool edge = q0 + kTile > T || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int query = q0 + col + (e & 1), r = e >> 1;
        float p = prob(s[4 * n + e], scale, b[r], (e & 1) ? l2.y : l2.x);
        if (edge && (query >= T || (causal && r0 + 8 * r > query))) p = 0.f;
        s[4 * n + e] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS^T in dP^T's registers, its row sums into the dbs partials
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(dd_s + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ds =
            s[4 * n + e] * (dp[4 * n + e] - ((e & 1) ? d2.y : d2.x));
        dp[4 * n + e] = ds;
        dsum[e >> 1] += ds;
      }
    }

    // dV += P^T_hi dO + P^T_lo dO, dO read MN-major; dS^T's row scaling
    // runs under it
    if constexpr (kScaled)
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] *= kP;
    uint32_t hi[4][4], lo[4][4];
    split_a<E>(s, hi, lo);
    acc_products16<D, E, NCB, NB>(acc_v, hi, lo, dost);
    if constexpr (kScaled) row_scale<NCB, NB>(dp, ex, acc_k);
    wgmma_wait<0>();
    fence_acc<NCB, NB>(acc_v, hi, lo);

    // dK += dS^T_hi Q + dS^T_lo Q, Q read MN-major
    split_a<E>(dp, hi, lo);
    acc_products16<D, E, NCB, NB>(acc_k, hi, lo, qst);
    wgmma_wait<0>();
    fence_acc<NCB, NB>(acc_k, hi, lo);

    // every warp is done with stage st, and the next tile's rows have
    // landed: refill the stage with tile i + kStages16
    if (i + 1 < n_tiles) {
      cp_async_wait_all();
      __syncthreads();
      if (i + kStages16 < n_tiles) {
        if (threadIdx.x == 0) load_q(i + kStages16);
        load_rows(i + kStages16);
        cp_async_commit();
      }
    }
  }

  const size_t base = row_base * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = dsum[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int key = r0 + 8 * r;
    if (key >= T) continue;
    const float fk = kScaled ? pow2i(-ex[r]) : 1.f;
    const float fv = 1.f / kP;
    const size_t off = base + static_cast<size_t>(key) * D + 2 * t;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int n = 0; n < NB / 8; ++n) {
        const int i = 4 * n + 2 * r;
        store2(dk + off + 64 * cb + 8 * n, acc_k[cb][i] * fk * scale,
               acc_k[cb][i + 1] * fk * scale);
        store2(dv + off + 64 * cb + 8 * n, acc_v[cb][i] * fv,
               acc_v[cb][i + 1] * fv);
      }
    if (t == 0) dbs[row_base + key] = sum;
  }
}

template <int D, typename E>
int launch16(const void* q, const void* k, const void* v, const float* bias,
             const void* dout, const float* lse, const float* dd, void* dk,
             void* dv, float* dbs, int BH, int H, int T, float scale,
             int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_tile_map<E>(&tq, q, BH, T, D);
  if (rc == 0) rc = make_tile_map<E>(&tk, k, BH, T, D);
  if (rc == 0) rc = make_tile_map<E>(&tv, v, BH, T, D);
  if (rc == 0) rc = make_tile_map<E>(&tdo, dout, BH, T, D);
  if (rc != 0) return rc;
  constexpr int bytes = SmemDkv16<D>::kBytes;
  // the blocks a multiprocessor keeps fit its 228 KB of shared memory
  // (1 KB of it reserved per block)
  static_assert((bytes + 1024) * dkv16_blocks_per_sm<D>() <= 228 * 1024,
                "shared memory of the resident blocks");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv16_kernel<D, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T + kTile - 1) / kTile);
  flash_bwd_dkv16_kernel<D, E><<<grid, 128, bytes, stream>>>(
      tq, tk, tv, tdo, bias, lse, dd, static_cast<E*>(dk),
      static_cast<E*>(dv), dbs, T, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const void* dout, const float* lse, const float* dd, void* dk,
           void* dv, float* dbs, int BH, int H, int T, float scale,
           int causal, cudaStream_t stream) {
  const int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<const float*>(dout),
      lse, dd, static_cast<float*>(dk), static_cast<float*>(dv), dbs, T, H,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the fp32 body's instance for E = float, the 16-bit body's otherwise
template <int D, typename E>
int launch_e(const void* q, const void* k, const void* v, const float* bias,
             const void* dout, const float* lse, const float* dd, void* dk,
             void* dv, float* dbs, int BH, int H, int T, float scale,
             int causal, cudaStream_t s) {
  if constexpr (std::is_same<E, float>::value)
    return launch<D>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH, H, T,
                     scale, causal, s);
  else
    return launch16<D, E>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH, H,
                          T, scale, causal, s);
}

template <typename E>
int launch_d(const void* q, const void* k, const void* v, const float* bias,
             const void* dout, const float* lse, const float* dd, void* dk,
             void* dv, float* dbs, int BH, int H, int T, int D, float scale,
             int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_e<16, E>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH,
                             H, T, scale, causal, s);
    case 32:
      return launch_e<32, E>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH,
                             H, T, scale, causal, s);
    case 64:
      return launch_e<64, E>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH,
                             H, T, scale, causal, s);
    case 128:
      return launch_e<128, E>(q, k, v, bias, dout, lse, dd, dk, dv, dbs, BH,
                              H, T, scale, causal, s);
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
