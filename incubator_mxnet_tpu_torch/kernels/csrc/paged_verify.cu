// K4 paged_verify: Q query rows per slot against a paged KV cache (the
// speculative-decode verify step of the default paged engine).
//
// Replaces: _paged_verify_kernel in incubator_mxnet_tpu/kernels/
// flash_attention.py (launched by _paged_verify_pallas).  q (S, H, Q, D),
// pages (NB, H, bs, D), an int32 block table (S, MB) padded with the null
// block 0, and positions (S,): row j of slot s attends to logical positions
// 0..min(positions[s] + j, MB * bs - 1), key t living in
// pages[tables[s, t / bs], h, t % bs].  The Pallas kernel walks every table
// entry and masks; this one reads only the keys up to the last row's head
// (masked keys weigh exactly 0 there, so the results match).  part: the
// (S, H, Q, ceil(MB * bs / 64), D + 2) fp32 scratch of the split.  Bound
// and design: see decode_common.cuh.
#include "decode_common.cuh"

// q and o of the element type `dtype` (0 fp32, 1 bf16, 2 fp16); pages fp32.
extern "C" int mx_paged_verify(const void* q, const float* k_pages,
                               const float* v_pages, const int* tables,
                               const int* positions, float* part, void* o,
                               int S, int H, int NB, int bs, int MB, int Q,
                               int D, float scale, int dtype, int* launches,
                               void* stream) {
  const mxdec::PagedKV kv{k_pages, v_pages, tables, H, NB, bs, MB};
  return mxdec::launch(q, kv, positions, part, o, S, H, MB * bs, Q, D, scale,
                       dtype, static_cast<cudaStream_t>(stream), launches);
}
