// K5 verify: Q query rows per slot against a dense KV cache (the
// speculative-decode verify step).
//
// Replaces: _verify_kernel in incubator_mxnet_tpu/kernels/
// flash_attention.py (launched by _verify_pallas).  q (S, H, Q, D), k, v
// (S, H, T, D), positions (S,): row j of slot s attends to cache entries
// 0..min(positions[s] + j, T - 1); later entries are stale by contract and
// never read.  The Pallas kernel walks every key block of T and masks; this
// one stops at the last row's head.  Same loop as K4 over the dense address
// computation, so a paged and a dense engine holding the same K/V produce
// bit-identical outputs.  Bound and design: see verify_common.cuh.
#include "verify_common.cuh"

extern "C" int mx_verify(const float* q, const float* k, const float* v,
                         const int* positions, float* o, int S, int H, int T,
                         int Q, int D, float scale, void* stream) {
  const mxdec::DenseKV kv{k, v, H, T};
  return mxver::launch(q, kv, positions, o, S, H, Q, D, scale,
                       static_cast<cudaStream_t>(stream));
}
