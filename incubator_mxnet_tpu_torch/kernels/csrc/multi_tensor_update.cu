// K9 multi_tensor_update: the train step's whole-tree update for the
// elementwise rules sgd, sgd with momentum, nag, adamw, rmsprop and
// adagrad, every parameter leaf in one launch, the rule a template
// parameter.
//
// Replaces: no Pallas kernel.  In the JAX package XLA fuses the tree map
// of incubator_mxnet_tpu/parallel/optim.py's sgd, nag, adamw, rmsprop and
// adagrad into the step program (and optimizer/fused.py's _build into the
// Gluon Trainer's one update program); this is the port's counterpart of
// those fused updates.  Same function as the per-leaf plain version
// (optimizer/fused.py, itself optimizer/cores.py prep_grad + the rule),
// element by element and in the same order, one fp32 rounding per torch
// op.  The rules, the stages and the guard are the kernel body of
// multi_tensor_common.cuh (rule_kernel), which K8's Adam shares.
//
// Bound on this card: bytes.  Per parameter sgd reads w, g and writes w
// (12 bytes); sgd_mom, nag, rmsprop and adagrad add one state read and
// written (20 bytes); adamw two (28 bytes); half of each in the 16-bit
// instances (the element types are K8's instances, multi_tensor_common.cuh
// PrecId).
//
// Design: K8's chunked map, one block per chunk of 16384 elements, float4
// on aligned chunks; the 16-bit instances 16-byte accesses of 8 elements
// and packed two-element arithmetic (multi_tensor_common.cuh V2).
//
// mx_half_pair_check is a test of those packed operations, not a kernel
// of any path: it holds each one, over every pair of 16-bit operands, to
// the scalar path's rounding of the fp32 result.
#include "multi_tensor_common.cuh"

using namespace mxmt;

namespace {

enum PairOp : int {
  kPairAdd = 0, kPairSub = 1, kPairMul = 2, kPairPack = 3, kPairDiv = 4
};

// a 16-bit value as the scalar path reads it (Elem<E>::load)
template <typename E>
__device__ __forceinline__ float value16(unsigned short h) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value)
    return __bfloat162float(__ushort_as_bfloat16(h));
  else
    return __half2float(__ushort_as_half(h));
}

// the scalar path's result bits: the fp32 value rounded to E
template <typename E>
__device__ __forceinline__ unsigned short scalar_bits(float x) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value)
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  else
    return __half_as_ushort(__float2half_rn(x));
}

template <typename E>
__device__ __forceinline__ bool is_nan16(unsigned short h) {
  return std::is_same<E, __nv_bfloat16>::value ? (h & 0x7fffu) > 0x7f80u
                                               : (h & 0x7fffu) > 0x7c00u;
}

// equal bits, or both NaN; else count the case and keep the first found
template <typename E>
__device__ __forceinline__ void agree(unsigned short got, unsigned short want,
                                      unsigned long long k,
                                      unsigned long long* out) {
  if (got == want || (is_nan16<E>(got) && is_nan16<E>(want))) return;
  atomicAdd(&out[0], 1ull);
  atomicMin(&out[1], k);
}

// k runs over every 32-bit pattern.  + - * /: operands a = k >> 16, b =
// k & 0xffff as 16-bit values, (a, b) in the low lane and (b, a) in the
// high one, against the scalar path: Elem<E>::load, the fp32 _rn
// operation, the rounding to E (/: quot16 and its packed rounding
// against __fdiv_rn's).  pack: k as a float in the low lane, its negation
// in the high one, against the scalar rounding of each.
template <typename E>
__global__ void __launch_bounds__(kThreads)
pair_check_kernel(int op, unsigned long long* out) {
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * kThreads;
  for (unsigned long long k =
           static_cast<unsigned long long>(blockIdx.x) * kThreads +
           threadIdx.x;
       k < (1ull << 32); k += stride) {
    const unsigned u = static_cast<unsigned>(k);
    unsigned got;
    float lo, hi;
    if (op == kPairPack) {
      lo = __uint_as_float(u);
      hi = -lo;
      got = Pair<E>::pack(lo, hi);
    } else {
      const unsigned short a = u >> 16, b = u & 0xffffu;
      const unsigned x = a | (static_cast<unsigned>(b) << 16);
      const unsigned y = b | (static_cast<unsigned>(a) << 16);
      const float fa = value16<E>(a), fb = value16<E>(b);
      if (op == kPairAdd) {
        got = Pair<E>::add(x, y);
        lo = __fadd_rn(fa, fb);
        hi = __fadd_rn(fb, fa);
      } else if (op == kPairSub) {
        got = Pair<E>::sub(x, y);
        lo = __fsub_rn(fa, fb);
        hi = __fsub_rn(fb, fa);
      } else if (op == kPairDiv) {
        got = Pair<E>::pack(quot16(fa, fb), quot16(fb, fa));
        lo = __fdiv_rn(fa, fb);
        hi = __fdiv_rn(fb, fa);
      } else {
        got = Pair<E>::mul(x, y);
        lo = __fmul_rn(fa, fb);
        hi = __fmul_rn(fb, fa);
      }
    }
    agree<E>(got & 0xffffu, scalar_bits<E>(lo), k, out);
    agree<E>(got >> 16, scalar_bits<E>(hi), k, out);
  }
}

}  // namespace

// dtype: 1 bf16, 2 fp16 (PrecId).  op: 0 +, 1 -, 2 *, 3 the packed
// rounding, 4 / (PairOp).  out: two device uint64 the caller set to 0 and
// UINT64_MAX: the cases that differ are added to out[0], the smallest
// such k is kept in out[1].
extern "C" int mx_half_pair_check(int dtype, int op, unsigned long long* out,
                                  void* stream) {
  if (op < kPairAdd || op > kPairDiv) return MX_ERR_UNKNOWN_RULE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = 132 * 16;
  if (dtype == kBf16)
    pair_check_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(op, out);
  else if (dtype == kF16)
    pair_check_kernel<__half><<<blocks, kThreads, 0, s>>>(op, out);
  else
    return MX_ERR_UNSUPPORTED_DTYPE;
  return static_cast<int>(cudaGetLastError());
}

// rule: 0 sgd, 1 sgd_mom, 2 nag, 3 adamw, 4 rmsprop, 5 adagrad.  prec:
// the instance (PrecId; the promoting ones for adamw only).  table:
// n_leaves rows of (w, g, [m], [v], wo, numel) as 64-bit integers in host
// memory (4 + the rule's state count columns; wo as K8's); read here,
// before the launch returns.  hp: the device floats lr, c1, c2 (c1, c2 read by adamw
// only).  a, b, oma, omb: the rule's constants (see RuleParams).
// nonfinite: null, or the all-finite check's device flag.  launches: the
// launches made are added to it.
extern "C" int mx_multi_tensor_update(int rule, int prec,
                                      const long long* table,
                                      int n_leaves, const float* hp,
                                      float a, float b, float oma,
                                      float omb, float eps, float rescale,
                                      float clip, float wd, int flags,
                                      const int* nonfinite, int* launches,
                                      void* stream) {
  if (rule < kSgd || rule > kAdagrad) return MX_ERR_UNKNOWN_RULE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static thread_local RuleParams p;   // ~27 KB: off the host stack
  p.flags = flags;
  p.hp = hp;
  p.nonfinite = nonfinite;
  p.a = a;
  p.b = b;
  p.oma = oma;
  p.omb = omb;
  p.eps = eps;
  p.rescale = rescale;
  p.clip = clip;
  p.wd = wd;
  switch (rule) {
    case kSgd: return run_prec<kSgd>(prec, p, table, n_leaves, s, launches);
    case kSgdMom:
      return run_prec<kSgdMom>(prec, p, table, n_leaves, s, launches);
    case kNag: return run_prec<kNag>(prec, p, table, n_leaves, s, launches);
    case kAdamW:
      return run_prec<kAdamW>(prec, p, table, n_leaves, s, launches);
    case kRmsprop:
      return run_prec<kRmsprop>(prec, p, table, n_leaves, s, launches);
    default:
      return run_prec<kAdagrad>(prec, p, table, n_leaves, s, launches);
  }
}
