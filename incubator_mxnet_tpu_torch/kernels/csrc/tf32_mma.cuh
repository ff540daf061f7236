// fp32-accurate products on the tensor cores (3xTF32 mma.sync.m16n8k8) and
// cp.async tile loads, shared by the attention kernels K1 flash_fwd, K6
// flash_bwd_dq and K7 flash_bwd_dkv.
//
// The products, FragA and load_tile serve the fp32 instances only; the
// bf16 and fp16 instances run on wgmma with TMA tiles (hopper_16.cuh) and
// share the rest: exp2_approx, the cp.async group calls, and store2,
// which rounds an fp32 result to the output's type.
//
// Fragment layout of mma.sync.m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, column):     b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// A C fragment read as {c0, c2, c1, c3} is an A fragment whose column t is
// C's column 2t and column t + 4 is C's column 2t + 1: a product's result
// feeds the next product from registers when the B rows are read in the
// same permuted order (row 2t at k = t, row 2t + 1 at k = t + 4).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTileRows = 64;      // rows of a tile that load_tile copies
constexpr int kTileThreads = 128;  // the block (4 warps) that copies it

// x = hi + lo: the tensor core reads a TF32 operand's sign, exponent and
// top 10 mantissa bits and ignores the low 13, so x's own bits serve as hi
// (x truncated), lo = x - trunc(x) is exact in fp32, and lo truncated in
// turn leaves an error below 2^-20 |x|.  Two instructions a value, where
// cvt.rna.tf32 compiles to a compare-and-select sequence on sm_90.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// 2^x (ex2.approx: 2 ulp, exactly 0 at -inf)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// an A fragment's four elements, split once and reused across n-tiles
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit FragA(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
  }
};

// d += a b in 3xTF32: the two small cross terms first, then hi * hi
__device__ __forceinline__ void mma_split(float (&d)[4], const FragA& a,
                                          const float (&b)[2]) {
  uint32_t bh[2], bl[2];
  split(b[0], bh[0], bl[0]);
  split(b[1], bh[1], bl[1]);
  mma_tf32(d, a.lo, bh);
  mma_tf32(d, a.hi, bl);
  mma_tf32(d, a.hi, bh);
}

// two adjacent outputs rounded to the output's type (to nearest even):
// 8 bytes of fp32, 4 of a 16-bit type
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// a shared-memory tile row of D floats is padded by 16 bytes, to D + 4;
// every fragment read below stays free of bank conflicts
template <int D>
__host__ __device__ constexpr int row_stride() {
  return D + 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// rows [0, 64) of a (rows, D) tile starting at src into dst (row stride
// row_stride<D>()); rows at or past ``rows`` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int rows) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  constexpr int LD = row_stride<D>();
  static_assert(kTileRows * kChunks % kTileThreads == 0,
                "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < kTileRows * kChunks / kTileThreads; ++it) {
    const int i = threadIdx.x + it * kTileThreads;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = r < rows;
    cp_async16(dst + r * LD + c,
               ok ? src + static_cast<size_t>(r) * D + c : src, ok);
  }
}

}  // namespace
