// K3 decode: one query per slot against a dense KV cache.
//
// Replaces: _decode_kernel in incubator_mxnet_tpu/kernels/
// flash_attention.py (launched by _decode_pallas).  q (S, H, D), k, v
// (S, H, T, D), positions (S,): slot s attends to cache entries
// 0..positions[s]; later entries are stale by contract and never read.
// Same loop as K2 over the dense address computation, so a paged and a
// dense engine holding the same K/V produce bit-identical outputs.  part:
// the (S, H, ceil(T / 64), D + 2) fp32 scratch of the split.  Bound and
// design: see decode_common.cuh.
#include "decode_common.cuh"

// q and o of the element type `dtype` (0 fp32, 1 bf16, 2 fp16); k, v fp32.
extern "C" int mx_decode(const void* q, const float* k, const float* v,
                         const int* positions, float* part, void* o, int S,
                         int H, int T, int D, float scale, int dtype,
                         int* launches, void* stream) {
  const mxdec::DenseKV kv{k, v, H, T};
  return mxdec::launch(q, kv, positions, part, o, S, H, T, 1, D, scale,
                       dtype, static_cast<cudaStream_t>(stream), launches);
}
