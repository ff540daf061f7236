// Hopper building blocks for the 16-bit (bf16, fp16) instances of the
// attention kernels: wgmma shared-memory descriptors and the wgmma
// products, the accumulator-to-A-fragment conversion with the hi/lo split,
// mbarriers, TMA tile loads and their tensor maps.  Used by K1 flash_fwd
// (its bf16 and fp16 instances); written for K6 and K7 too.
//
// Shared-memory tiles.  A 64-row tile of a (BH, T, D) tensor lives in
// shared memory as min(D, 64)-column blocks of 16-bit values, each block
// 64 x min(D, 64) with rows of 32, 64 or 128 bytes (D = 16, 32, >= 64)
// under the TMA swizzle of the same width, which is the wgmma canonical
// layout of that swizzle: 8-row groups of 8 x row bytes (the descriptor's
// SBO), a 16-wide k-step 32 bytes further along a row (K-major: Q and K
// in S = Q K^T), a 16-row k-step 16 x row bytes further down (MN-major,
// read through the transpose bit: V in O += P V).  Every tile starts on a
// 1024-byte boundary, so the swizzle's phase is the tile's own.
//
// wgmma m64nNk16 accumulator (f32, per thread of the warpgroup; warp w of
// the warpgroup, g = lane / 4, t = lane % 4): element 4j + e of the
// thread's N / 2 floats is row 16w + g + 8 (e >> 1), column 8j + 2t +
// (e & 1).  The 16-bit A fragment of a k-step (registers) is the
// mma.m16n8k16 one: a0 = row g, columns 2t, 2t + 1; a1 = row g + 8,
// the same columns; a2, a3 = the same rows, columns 2t + 8, 2t + 9.  So the
// n8 chunks 2kk and 2kk + 1 of an accumulator, packed in pairs, are the A
// fragment of k-step kk of the next product: P feeds O += P V from
// registers with no shuffle.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

// --------------------------------------------------------------- shared
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects ``bytes`` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity ``parity`` has completed.  A wait that
// never ends (a copy that delivers fewer bytes than its barrier expects)
// traps after ~2^28 polls, seconds on the card, so it fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (polls == (1u << 28)) __trap();
  }
}

// ------------------------------------------------------------------ TMA
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// the box of ``map`` at (c0, c1, c2) (innermost first) into ``dst``;
// elements past the tensor's edge arrive as zeros, and ``bar`` counts the
// whole box's bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The (BH, T, D) tensor at ``ptr`` as a TMA map of 64-row boxes of
// min(D, 64) columns under the swizzle that matches the tile layout
// above.  cuTensorMapEncodeTiled is a driver function: it is reached
// through the runtime's cudaGetDriverEntryPoint, so the library links no
// libcuda.  Returns 0 or MX_ERR_TENSOR_MAP.
template <typename E>
int make_tile_map(CUtensorMap* map, const void* ptr, int BH, int T, int D) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = []() -> Encode {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<Encode>(fn)
                                            : nullptr;
  }();
  if (encode == nullptr) return MX_ERR_TENSOR_MAP;
  constexpr cuuint64_t es = sizeof(E);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {D * es, static_cast<cuuint64_t>(T) * D * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D < 64 ? D : 64), 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = D >= 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType dt = std::is_same<E, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, dt, 3, const_cast<void*>(ptr), dims, strides,
                            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MX_ERR_TENSOR_MAP;
}

// ---------------------------------------------------------- descriptors
// the row bytes and the swizzle (descriptor layout type: 1 = 128-byte,
// 2 = 64-byte, 3 = 32-byte) of a tile of head dimension D
template <int D>
__host__ __device__ constexpr int tile_row_bytes() {
  return D < 64 ? 2 * D : 128;
}
template <int D>
__host__ __device__ constexpr int tile_swizzle() {
  return D >= 64 ? 1 : D == 32 ? 2 : 3;
}
// bytes of one column block of a 64-row tile, and of the whole tile
template <int D>
__host__ __device__ constexpr int tile_block_bytes() {
  return 64 * tile_row_bytes<D>();
}
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return 64 * D * 2;
}

// a wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint32_t sbo = 8 * tile_row_bytes<D>();
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32 |
         static_cast<uint64_t>(tile_swizzle<D>()) << 62;
}

// K-major operand (the 64-row tile at ``tile``, rows of D): its k-step
// ks (columns 16 ks .. 16 ks + 15)
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int ks) {
  return smem_desc<D>(tile + (ks >> 2) * tile_block_bytes<D>() +
                          (ks & 3) * 32,
                      16);
}

// MN-major operand (a tile of 64 keys x D, read as K = keys, N = its
// columns): k-step kk (keys 16 kk .. 16 kk + 15) of column block cb
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk,
                                                  int cb) {
  return smem_desc<D>(tile + cb * tile_block_bytes<D>() +
                          kk * 16 * tile_row_bytes<D>(),
                      tile_block_bytes<D>());
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence (its accumulator until the
// wait, its A registers until the wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define MX_WGMMA_SS_N64(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %34, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "l"(a), "l"(b), "r"(scale_d))

// d (64 x 64, f32) = (scale_d ? d : 0) + A B^T, A and B both K-major in
// shared memory (descriptors a, b): S = Q K^T
template <typename E>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  if constexpr (std::is_same<E, __half>::value)
    MX_WGMMA_SS_N64("f16");
  else
    MX_WGMMA_SS_N64("bf16");
}

#define MX_WGMMA_RS_N16(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %13, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "           \
      "p, 1, 1, 1;\n}\n"                                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

#define MX_WGMMA_RS_N32(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %21, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15])                                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

#define MX_WGMMA_RS_N64(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %37, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

// d (64 x N, f32) = (scale_d ? d : 0) + A B, A a 64 x 16 fragment in
// registers, B (16 x N) MN-major in shared memory (descriptor b, read
// through the transpose bit): O += P V, N = min(D, 64)
template <typename E, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  constexpr bool h = std::is_same<E, __half>::value;
  if constexpr (N == 16) {
    if constexpr (h) MX_WGMMA_RS_N16("f16"); else MX_WGMMA_RS_N16("bf16");
  } else if constexpr (N == 32) {
    if constexpr (h) MX_WGMMA_RS_N32("f16"); else MX_WGMMA_RS_N32("bf16");
  } else {
    static_assert(N == 64, "m64n16, m64n32 or m64n64");
    if constexpr (h) MX_WGMMA_RS_N64("f16"); else MX_WGMMA_RS_N64("bf16");
  }
}

#undef MX_WGMMA_SS_N64
#undef MX_WGMMA_RS_N16
#undef MX_WGMMA_RS_N32
#undef MX_WGMMA_RS_N64

// ------------------------------------------------- P as two 16-bit parts
// two fp32 values as one register of two E (low half the first), rounded
// to nearest even, and the fp32 values of that pair back
__device__ __forceinline__ uint32_t pack2(float a, float b, float& ra,
                                          float& rb, __nv_bfloat16) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(v);
  ra = f.x;
  rb = f.y;
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, float& ra,
                                          float& rb, __half) {
  const __half2 v = __floats2half2_rn(a, b);
  const float2 f = __half22float2(v);
  ra = f.x;
  rb = f.y;
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An accumulator of 64 columns (32 floats) as the A fragments of the four
// 16-wide k-steps of the next product, in two parts: hi = E(x) and lo =
// E(x - hi), so hi + lo keeps ~16 significant bits of x in bf16 and ~22
// in fp16 (fp16's subnormals cost lo its last bits below 2^-14; at x <= 1
// that is under 2^-24 absolute).  hi B + lo B accumulates in fp32.
template <typename E>
__device__ __forceinline__ void split_a(const float (&s)[32],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r;
      float h0, h1, d0, d1;
      hi[kk][r] = pack2(s[i], s[i + 1], h0, h1, E());
      lo[kk][r] = pack2(s[i] - h0, s[i + 1] - h1, d0, d1, E());
    }
  }
}

}  // namespace
