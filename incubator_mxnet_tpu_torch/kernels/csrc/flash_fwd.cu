// K1 flash_fwd: online-softmax (FlashAttention-2) attention forward, fp32
// inside, on the tensor cores, for the prefill self-attention of the GPT
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
// Two bodies share the function and the softmax: the fp32 one on TF32
// mma.sync, the 16-bit one on wgmma.
//
// fp32 (flash_fwd_kernel).  Bound on this card: for a long prompt,
// operations.  Both products (S = Q K^T and O += P V, 4 * D FLOP per live
// (query, key) pair) run as 3xTF32 on the tensor cores: each fp32 operand
// x splits into hi = tf32(x) and lo = x - hi, and a_hi b_hi + a_hi b_lo +
// a_lo b_hi accumulates in fp32, which keeps the error near fp32's (~1e-6
// relative) at three tensor-core products per product.  The bound is
// therefore the larger of the bytes (q, k, v read once, o written once)
// over 3.35 TB/s and 3 * 4 * D * pairs FLOP over the 495 TFLOP/s TF32 peak.
// One block of 4 warps owns a 64-row query tile of one (batch, head); warp
// w owns rows 16w..16w+15 and keeps their S fragment, running max, partial
// sum and O accumulator in registers (mma.sync m16n8k8 tf32 fragments).  Q
// is pre-scaled by scale * log2(e), so the scores come out in base-2 units
// and each softmax exponent is one ex2.approx (2 ulp); the lse converts
// back to base e.  The row max is a quad shuffle; the row sum stays per
// thread until the end.  P never leaves registers: the PV product reads
// P's accumulator fragment as its A fragment with the keys of each 8-key
// step permuted (A column t is key 2t, column t + 4 is key 2t + 1), and
// reads V in the same permuted order, so no shuffle or shared-memory
// re-layout is needed.  K/V tiles of 64 keys are double-buffered in shared
// memory with cp.async (16 bytes a thread; rows past T zero-filled), one
// barrier per tile: the next tile's copy is issued right after the barrier
// and overlaps this tile's products.  Rows are padded to D + 4 floats,
// which makes every fragment read of K (row = key) and of V (row = key, in
// the permuted order) free of bank conflicts.  The query tile is staged
// once through the second stage's buffer.  The grid is (B*H, query tiles);
// under causal the query tiles run in reverse, so the heaviest tiles of
// every head are scheduled first, and a causal block stops at the tile
// holding its diagonal.  D is a template parameter in {16, 32, 64, 128}.
//
// bf16, fp16 (flash_fwd16_kernel).  Bound: the same two products at the
// card's 16-bit tensor-core rate (989 TFLOP/s), or for short sequences the
// bytes.  The function computes in fp32, so only the products whose inputs
// are exact in 16 bits may run in 16 bits.  S = Q K^T does: Q is not
// pre-scaled, each 16-bit product is exact in fp32, and wgmma m64n64k16
// sums them in fp32; scale * log2(e) and the key bias (in base 2) are one
// FFMA per score after it (with no bias and a positive scale, folded into
// the exponent's FFMA).  P is fp32: rounded once to 16 bits it moves
// ~40 % of the outputs off the plain version's rounding (the 16-bit
// control of chip_smoke.py), so P goes in two 16-bit parts, hi = E(P) and
// lo = E(P - hi) (hopper_16.cuh split_a: ~16 significant bits in bf16, ~22
// in fp16), and O += hi V + lo V runs as two wgmma m64nNk16 per 16 keys,
// A from registers (S's accumulator layout is the A-fragment layout, so P
// never moves), V read from shared memory through the transpose bit.  So
// the kernel does 3 products where the function needs 2: it is bound at
// 1.5x the function's bound by operations.  (fp16's subnormals round lo
// to a multiple of 2^-24: at most 2^-25 a key, against a row sum of at
// least 1.  The fp16 instance meets the same contract as bf16 in the
// tests and chip_smoke.py, so no separately scaled lo accumulator is
// kept.)
// Layout: a block is one warpgroup (128 threads) that owns a 64-row query
// tile of one (batch, head) and keeps S (32 floats a thread), P's two
// parts and O in registers, and its row max and sum as the fp32 body
// does; at 80-142 registers a thread and 11-81 KB of shared memory, four
// blocks share a multiprocessor (two at D = 128).  Thread 0 issues every
// copy through TMA (hopper_16.cuh make_tile_map: a 3-D (D, T, B*H) map,
// rows past T zero-filled by the hardware, the maps passed as
// __grid_constant__ parameters, so a captured CUDA graph replays them):
// the query tile, then the K and V tiles of 64 keys into a ring of
// kStages stages, each with a full barrier for K and one for V (S starts
// as soon as K lands); after a tile's P V products the block syncs and
// thread 0 refills that stage with the tile kStages ahead.  Tiles are
// stored under the 128-byte swizzle (64- and 32-byte at D = 32, 16) that
// wgmma reads without bank conflicts.  The grid is (B*H, query tiles),
// under causal in reverse (heaviest first), and a causal block stops at
// its diagonal tile.  Departure from a warp-specialised design (two
// consumer warpgroups sharing each K/V tile, a producer warpgroup that
// gives up its registers with setmaxnreg, empty barriers): with this
// arithmetic it was 1.4x slower at gluon16's shape (B=8 H=12 T=1024 D=64
// causal) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).  At one block a
// multiprocessor its S -> softmax -> P V chain stayed exposed; issuing
// the next tile's S behind P V, or alternating the two warpgroups' turns
// with named barriers, made it slower still.  Four independent blocks hide
// each other's chains, and L2 serves the K/V tiles that neighbouring query
// tiles read again.
#include "hopper_16.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kWarps = 4;      // 16 query rows each
constexpr int kThreads = 32 * kWarps;

// two stages of (K tile, V tile), rows padded by 16 bytes
template <int D>
constexpr int smem_bytes() {
  return 4 * kBK * row_stride<D>() * static_cast<int>(sizeof(float));
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int T,
                 int H, float scale, int causal) {
  constexpr int LD = row_stride<D>();  // padded row stride
  constexpr int TILE = kBK * LD;     // elements of one K or V tile
  constexpr int KS = D / 8;          // k-steps of S = Q K^T
  constexpr int NO = D / 8;          // n-tiles of O
  constexpr int NS = kBK / 8;        // n-tiles of S = k-steps of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);  // [K0 | V0 | K1 | V1]

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
  float* qs = smem + 2 * TILE;
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
    qf[ks][0] = qs[r0 * LD + ks * 8 + t] * qscale;
    qf[ks][1] = qs[(r0 + 8) * LD + ks * 8 + t] * qscale;
    qf[ks][2] = qs[r0 * LD + ks * 8 + t + 4] * qscale;
    qf[ks][3] = qs[(r0 + 8) * LD + ks * 8 + t + 4] * qscale;
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
      float* dst = smem + ((j + 1) & 1) * 2 * TILE;
      load_tile<D>(dst, k + base + static_cast<size_t>(k1) * D, T - k1);
      load_tile<D>(dst + TILE, v + base + static_cast<size_t>(k1) * D,
                   T - k1);
      cp_async_commit();
    }
    const float* ks_ = smem + (j & 1) * 2 * TILE;
    const float* vs_ = ks_ + TILE;
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
        const float* kr = ks_ + (n * 8 + g) * LD + ks * 8 + t;
        const float b[2] = {kr[0], kr[4]};
        mma_split(s[n], a, b);
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
      const float* vr = vs_ + (n * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int no = 0; no < NO; ++no) {
        const float b[2] = {vr[no * 8], vr[LD + no * 8]};
        mma_split(acc[no], a, b);
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
    float* orow = o + base + static_cast<size_t>(row) * D + 2 * t;
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

// ---------------------------------------------------------------------
// the 16-bit instances: wgmma products, K/V through TMA
constexpr int kStages = 2;       // K/V ring depth
constexpr int kThreads16 = 128;  // one warpgroup: 64 query rows a block

// blocks a multiprocessor keeps resident (registers: 65536 / (128 x this)
// a thread; shared memory: Smem16<D>::kBytes a block)
template <int D>
constexpr int blocks_per_sm16() {
  return D == 128 ? 2 : 4;
}

// dynamic shared memory: the query tile, the K ring, the V ring, the
// barriers, and the slack that aligns the base to 1024 bytes
template <int D>
struct Smem16 {
  static constexpr int kTile = tile_bytes<D>();
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// One 64-key tile's scores S (this thread's rows r0, r0 + 8; element 4n +
// e is row r0 + 8 (e >> 1), key k0 + 8n + 2t + (e & 1)) turned into P in
// place, with the running max m, the row sums l and O's rescale.  Keys
// past T and past the diagonal weigh -inf.  The scale and a key bias (in
// base-2 units) are one FFMA a score; with no bias and a positive scale
// the scale goes into the exponent's FFMA instead (the row max of the raw
// scores times a positive scale is the max of the scaled ones).
template <int NCB, int NB>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], float (&acc)[NCB][NB / 2], float (&m)[2], float (&l)[2],
    const float* __restrict__ brow, int k0, int T, bool causal, int w0,
    int r0, int t, float qscale) {
  const bool fold = brow == nullptr && qscale > 0.f;
  if (!fold) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * n + 2 * t + c;
        const float b2 = brow != nullptr && key < T
                             ? __ldg(brow + key) * kLog2e : 0.f;
        s[4 * n + c] = fmaf(s[4 * n + c], qscale, b2);
        s[4 * n + 2 + c] = fmaf(s[4 * n + 2 + c], qscale, b2);
      }
  }
  if (k0 + 64 > T || (causal && k0 + 63 > w0)) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (key >= T || (causal && key > r0 + 8 * ((i >> 1) & 1)))
        s[i] = -CUDART_INF_F;
    }
  }
  const float sc = fold ? qscale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * sc);
    // the safe_m guard, as in the fp32 body
    const float safe = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = exp2_approx(m[r] - safe);
    m[r] = m_new;
    l[r] *= alpha;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int n = 0; n < NB / 8; ++n) {
        acc[cb][4 * n + 2 * r] *= alpha;
        acc[cb][4 * n + 2 * r + 1] *= alpha;
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float p = exp2_approx(fmaf(s[4 * n + e], sc, -safe));
        s[4 * n + e] = p;
        l[r] += p;
      }
  }
}

template <int D, bool kLse, typename E>
__global__ void __launch_bounds__(kThreads16, blocks_per_sm16<D>())
flash_fwd16_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ bias, E* __restrict__ o,
                   float* __restrict__ lse, int T, int H, float scale,
                   int causal) {
  using L = Smem16<D>;
  constexpr int NCB = D > 64 ? D / 64 : 1;  // column blocks of a tile
  constexpr int NB = D > 64 ? 64 : D;       // their columns: N of P V
  constexpr int KS = D / 16;                // k-steps of S = Q K^T
  constexpr uint32_t kTileBytes = L::kTile;
  extern __shared__ __align__(16) unsigned char smem16_raw[];
  unsigned char* smem =
      smem16_raw + ((1024 - (smem_u32(smem16_raw) & 1023)) & 1023);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + kStages;

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * 64;
  const int nk = (T + 63) / 64;
  // the tiles the block streams: under causal, up to its diagonal
  const int n_tiles = causal ? min(nk, q0 / 64 + 1) : nk;

  // thread 0 issues every copy: K and V tile j into stage j % kStages
  auto load_kv = [&](int j) {
    const int st = j % kStages;
    unsigned char* kd = smem + L::kK + st * L::kTile;
    unsigned char* vd = smem + L::kV + st * L::kTile;
    mbar_expect_tx(kfull + st, kTileBytes);
    for (int cb = 0; cb < NCB; ++cb)
      tma_load_3d(kd + cb * tile_block_bytes<D>(), &tk, kfull + st, cb * 64,
                  j * 64, bh);
    mbar_expect_tx(vfull + st, kTileBytes);
    for (int cb = 0; cb < NCB; ++cb)
      tma_load_3d(vd + cb * tile_block_bytes<D>(), &tv, vfull + st, cb * 64,
                  j * 64, bh);
  };
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
    }
    mbar_fence_init();
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    mbar_expect_tx(qfull, kTileBytes);
    for (int cb = 0; cb < NCB; ++cb)
      tma_load_3d(smem + L::kQ + cb * tile_block_bytes<D>(), &tq, qfull,
                  cb * 64, q0, bh);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncthreads();

  // this thread's rows r0 and r0 + 8 (the accumulator layout of
  // hopper_16.cuh)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * warp + g;
  const float* brow =
      bias != nullptr ? bias + static_cast<size_t>(bh / H) * T : nullptr;
  const float qscale = scale * kLog2e;
  const uint32_t qa = smem_u32(smem + L::kQ);
  const uint32_t ka = smem_u32(smem + L::kK);
  const uint32_t va = smem_u32(smem + L::kV);

  float acc[NCB][NB / 2];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[cb][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  mbar_wait(qfull, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t par = (j / kStages) & 1;

    // S = Q K^T: unscaled, exact 16-bit products summed in fp32
    float s[32];
    mbar_wait(kfull + st, par);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss_n64<E>(s, desc_k_major<D>(qa, ks),
                      desc_k_major<D>(ka + st * L::kTile, ks), ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    softmax_tile<NCB, NB>(s, acc, m, l, brow, j * 64, T, causal, q0, r0, t,
                          qscale);

    // O += P_hi V + P_lo V, P from registers, 16 keys a k-step
    uint32_t phi[4][4], plo[4][4];
    split_a<E>(s, phi, plo);
    mbar_wait(vfull + st, par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        const uint64_t dv = desc_mn_major<D>(va + st * L::kTile, kk, cb);
        wgmma_rs<E, NB>(acc[cb], phi[kk], dv, 1);
        wgmma_rs<E, NB>(acc[cb], plo[kk], dv, 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(phi[kk]);
      fence_regs(plo[kk]);
    }
    // every warp is done with stage st: refill it with tile j + kStages
    if (j + kStages < n_tiles) {
      __syncthreads();
      if (threadIdx.x == 0) load_kv(j + kStages);
    }
  }

  const size_t base = static_cast<size_t>(bh) * T * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = r0 + 8 * r;
    if (row >= T) continue;
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    E* orow = o + base + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int n = 0; n < NB / 8; ++n)
        store2(orow + 64 * cb + 8 * n, acc[cb][4 * n + 2 * r] * inv,
               acc[cb][4 * n + 2 * r + 1] * inv);
    if (kLse && t == 0) {
      const float safe = m[r] == -CUDART_INF_F ? 0.f : m[r];
      lse[static_cast<size_t>(bh) * T + row] =
          safe * kLn2 + logf(fmaxf(sum, 1e-30f));
    }
  }
}


template <int D>
int launch(const void* q_, const void* k_, const void* v_,
           const float* bias, void* o_, float* lse, int BH, int H, int T,
           float scale, int causal, cudaStream_t stream) {
  const float* q = static_cast<const float*>(q_);
  const float* k = static_cast<const float*>(k_);
  const float* v = static_cast<const float*>(v_);
  float* o = static_cast<float*>(o_);
  const int bytes = smem_bytes<D>();
  auto kernel = lse != nullptr ? flash_fwd_kernel<D, true>
                               : flash_fwd_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, bias, o, lse, T, H, scale,
                                            causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename E>
int launch16(const void* q, const void* k, const void* v, const float* bias,
             void* o, float* lse, int BH, int H, int T, float scale,
             int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = make_tile_map<E>(&tq, q, BH, T, D);
  if (rc == 0) rc = make_tile_map<E>(&tk, k, BH, T, D);
  if (rc == 0) rc = make_tile_map<E>(&tv, v, BH, T, D);
  if (rc != 0) return rc;
  constexpr int bytes = Smem16<D>::kBytes;
  auto kernel = lse != nullptr ? flash_fwd16_kernel<D, true, E>
                               : flash_fwd16_kernel<D, false, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T + 63) / 64);
  kernel<<<grid, kThreads16, bytes, stream>>>(
      tq, tk, tv, bias, static_cast<E*>(o), lse, T, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the fp32 body's instance for E = float, the 16-bit body's otherwise
template <int D, typename E>
int launch_e(const void* q, const void* k, const void* v, const float* bias,
             void* o, float* lse, int BH, int H, int T, float scale,
             int causal, cudaStream_t s) {
  if constexpr (std::is_same<E, float>::value)
    return launch<D>(q, k, v, bias, o, lse, BH, H, T, scale, causal, s);
  else
    return launch16<D, E>(q, k, v, bias, o, lse, BH, H, T, scale, causal, s);
}

template <typename E>
int launch_d(const void* q, const void* k, const void* v, const float* bias,
             void* o, float* lse, int BH, int H, int T, int D, float scale,
             int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_e<16, E>(q, k, v, bias, o, lse, BH, H, T, scale, causal,
                             s);
    case 32:
      return launch_e<32, E>(q, k, v, bias, o, lse, BH, H, T, scale, causal,
                             s);
    case 64:
      return launch_e<64, E>(q, k, v, bias, o, lse, BH, H, T, scale, causal,
                             s);
    case 128:
      return launch_e<128, E>(q, k, v, bias, o, lse, BH, H, T, scale, causal,
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
