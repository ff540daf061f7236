// K5 verify: Q query rows per slot against a dense KV cache (the
// speculative-decode verify step).
//
// Replaces: _verify_kernel in incubator_mxnet_tpu/kernels/
// flash_attention.py (launched by _verify_pallas).  q (S, H, Q, D), k, v
// (S, H, T, D), positions (S,): row j of slot s attends to cache entries
// 0..min(positions[s] + j, T - 1); later entries are stale by contract and
// never read.  The Pallas kernel walks every key block of T and masks; this
// one reads only the keys up to the last row's head.  K2/K3's split over
// 64-key chunks with Q rows per chunk, then the merge, over the dense
// address computation, so a paged and a dense engine holding the same K/V
// produce bit-identical outputs.  part: the (S, H, Q, ceil(T / 64), D + 2)
// fp32 scratch of the split.  Bound and design: see decode_common.cuh.
#include "decode_common.cuh"

// q and o of the element type `dtype` (0 fp32, 1 bf16, 2 fp16); k, v fp32.
extern "C" int mx_verify(const void* q, const float* k, const float* v,
                         const int* positions, float* part, void* o, int S,
                         int H, int T, int Q, int D, float scale, int dtype,
                         int* launches, void* stream) {
  const mxdec::DenseKV kv{k, v, H, T};
  return mxdec::launch(q, kv, positions, part, o, S, H, T, Q, D, scale,
                       dtype, static_cast<cudaStream_t>(stream), launches);
}
