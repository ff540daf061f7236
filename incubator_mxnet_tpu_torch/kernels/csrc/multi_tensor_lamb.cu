// K10 multi_tensor_lamb: LAMB's update over the whole parameter tree in
// two launches, each over every leaf.
//
// Replaces: no Pallas kernel.  In the JAX package XLA fuses the tree map
// of incubator_mxnet_tpu/parallel/optim.py's lamb (:227-252; and
// optimizer/fused.py's lamb branch for the Gluon Trainer) into one step
// program; this is the port's counterpart of that fused update.  Per leaf,
// after g = prep(g) (rescale and clip when their flags are set; LAMB's wd
// is decoupled):
//   m = m * b1 + g * (1 - b1);  v = v * b2 + (g * (1 - b2)) * g
//   u = (m / c1) / (sqrt(v / c2) + eps) + wd * w
//   r1 = ||w|| (clamped to [lower, upper] where given),  r2 = ||u||
//   ratio = r1 / r2 where r1 > 0 and r2 > 0, else 1
//   w = w - (lr * ratio) * u
// with c1 = 1 - b1^t and c2 = 1 - b2^t (1 without bias correction) and lr
// read from device memory (hp[0..2]), so a CUDA graph that computes them
// from the step on the device replays with each step's values.  Each
// elementwise operation is an explicitly rounded intrinsic, so m, v and u
// are bit for bit the plain version's (optimizer/cores.py lamb_direction);
// the norms are sums in another order than torch.linalg.vector_norm's, so
// w is held to the plain version within a stated tolerance.
//
// Design: K8's chunked map (multi_tensor_common.cuh) twice.
//   Launch 1, one block per chunk: m and v updated in place, u computed,
//     and the chunk's sums of w^2 and u^2 written to partials[2 b], [2 b
//     + 1] (each thread sums its elements in fp32, the block sums the
//     threads in fp64 in a fixed tree).
//   Launch 2, one block per chunk: the block sums its leaf's partials in
//     chunk order in fp64 (every block of a leaf gets the same bits), forms
//     the ratio, recomputes u from the new m, v and the old w, and writes
//     w.  No atomics: two runs on the same inputs are bit-equal.
// Bound on this card: bytes.  The function reads w, g, m, v and writes w,
// m, v: 28 bytes per parameter.  This design moves 40 (launch 1 reads w,
// g, m, v and writes m, v; launch 2 reads w, m, v and writes w), so it
// reaches at most 0.70 of that bound.
//
// The skip_nonfinite guard, as in K8: given the all-finite check's device
// flag, every block of launch 1 reads it before any write and, when it is
// set, zeroes its chunk of the gradient and returns; launch 2 then writes
// nothing.
#include "multi_tensor_common.cuh"

namespace {

using namespace mxmt;

struct Params {
  Table t;
  int flags;
  const float* hp;         // lr, c1, c2 on the device
  const int* nonfinite;    // the guard's flag, or null
  double* partials;        // 2 doubles per block
  float b1, b2, omb1, omb2, eps, rescale, clip, wd, lower, upper;
};

__device__ __forceinline__ float direction(float w, float m, float v,
                                           float c1, float c2,
                                           const Params& p) {
  const float dir = __fdiv_rn(__fdiv_rn(m, c1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)),
                                        p.eps));
  return __fadd_rn(dir, __fmul_rn(p.wd, w));
}

__device__ __forceinline__ void moments_dir(float w, float g, float& m,
                                            float& v, float c1, float c2,
                                            const Params& p, float& sw,
                                            float& su) {
  g = prep(g, w, p.flags, p.rescale, p.clip, 0.f);
  m = __fadd_rn(__fmul_rn(m, p.b1), __fmul_rn(g, p.omb1));
  v = __fadd_rn(__fmul_rn(v, p.b2), __fmul_rn(__fmul_rn(g, p.omb2), g));
  const float u = direction(w, m, v, c1, c2, p);
  sw = __fmaf_rn(w, w, sw);
  su = __fmaf_rn(u, u, su);
}

// the block's sum of x in fp64, in a fixed order
__device__ __forceinline__ double block_sum(double x, double* smem) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads / 32; ++i) total += smem[i];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads)
lamb_phase1_kernel(const __grid_constant__ Params p) {
  __shared__ double smem[kThreads / 32];
  const int b = blockIdx.x;
  const Chunk ch = chunk_of(p.t, b);
  const int li = ch.leaf, len = ch.len;
  const long long begin = ch.begin;
  const float* w = p.t.w[li] + begin;
  float* g = p.t.g[li] + begin;
  if (p.nonfinite != nullptr && *p.nonfinite) {   // a skipped step
    for (int i = threadIdx.x; i < len; i += kThreads) g[i] = 0.f;
    return;
  }
  const float c1 = p.hp[1], c2 = p.hp[2];
  float* m = p.t.s1[li] + begin;
  float* v = p.t.s2[li] + begin;
  float sw = 0.f, su = 0.f;
  int done = 0;
  if (p.t.vec[li]) {
    const int n4 = len >> 2;
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 wv = w4[i], gv = g4[i];
      float4 mv = m4[i], vv = v4[i];
      moments_dir(wv.x, gv.x, mv.x, vv.x, c1, c2, p, sw, su);
      moments_dir(wv.y, gv.y, mv.y, vv.y, c1, c2, p, sw, su);
      moments_dir(wv.z, gv.z, mv.z, vv.z, c1, c2, p, sw, su);
      moments_dir(wv.w, gv.w, mv.w, vv.w, c1, c2, p, sw, su);
      m4[i] = mv;
      v4[i] = vv;
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) {
    float mv = m[i], vv = v[i];
    moments_dir(w[i], g[i], mv, vv, c1, c2, p, sw, su);
    m[i] = mv;
    v[i] = vv;
  }
  const double tw = block_sum(static_cast<double>(sw), smem);
  const double tu = block_sum(static_cast<double>(su), smem);
  if (threadIdx.x == 0) {
    p.partials[2 * b] = tw;
    p.partials[2 * b + 1] = tu;
  }
}

__global__ void __launch_bounds__(kThreads)
lamb_phase2_kernel(const __grid_constant__ Params p) {
  __shared__ float scale_s;
  if (p.nonfinite != nullptr && *p.nonfinite) return;   // a skipped step
  const Chunk ch = chunk_of(p.t, blockIdx.x);
  const int li = ch.leaf, len = ch.len;
  const long long begin = ch.begin;
  if (threadIdx.x == 0) {
    double sw = 0.0, su = 0.0;
    for (int c = p.t.first_block[li]; c < p.t.first_block[li + 1]; ++c) {
      sw += p.partials[2 * c];
      su += p.partials[2 * c + 1];
    }
    float r1 = static_cast<float>(sqrt(sw));
    const float r2 = static_cast<float>(sqrt(su));
    if (p.lower > 0.f) r1 = fmaxf(r1, p.lower);
    if (p.upper > 0.f) r1 = fminf(r1, p.upper);
    const float ratio = (r1 > 0.f && r2 > 0.f) ? __fdiv_rn(r1, r2) : 1.f;
    scale_s = __fmul_rn(p.hp[0], ratio);
  }
  __syncthreads();
  const float scale = scale_s;
  const float c1 = p.hp[1], c2 = p.hp[2];
  float* w = p.t.w[li] + begin;
  const float* m = p.t.s1[li] + begin;
  const float* v = p.t.s2[li] + begin;
  int done = 0;
  if (p.t.vec[li]) {
    const int n4 = len >> 2;
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float4 wv = w4[i];
      const float4 mv = m4[i], vv = v4[i];
      wv.x = __fsub_rn(wv.x, __fmul_rn(scale,
                                        direction(wv.x, mv.x, vv.x, c1, c2, p)));
      wv.y = __fsub_rn(wv.y, __fmul_rn(scale,
                                        direction(wv.y, mv.y, vv.y, c1, c2, p)));
      wv.z = __fsub_rn(wv.z, __fmul_rn(scale,
                                        direction(wv.z, mv.z, vv.z, c1, c2, p)));
      wv.w = __fsub_rn(wv.w, __fmul_rn(scale,
                                        direction(wv.w, mv.w, vv.w, c1, c2, p)));
      w4[i] = wv;
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads)
    w[i] = __fsub_rn(w[i], __fmul_rn(scale,
                                     direction(w[i], m[i], v[i], c1, c2, p)));
}

}  // namespace

// table: n_leaves rows of (w, g, m, v, numel) as 64-bit integers in host
// memory; read here, before the launches return.  hp: the device floats
// lr, c1, c2.  partials: device scratch of 2 doubles per block (the sum
// over leaves of ceil(numel / 16384)).  lower, upper: the bounds on ||w||,
// <= 0 for none.  nonfinite: null, or the all-finite check's device flag.
// launches: the launches made (two per kMaxLeaves leaves) are added to it.
extern "C" int mx_multi_tensor_lamb(const long long* table, int n_leaves,
                                    const float* hp, double* partials,
                                    float b1, float b2, float omb1,
                                    float omb2, float eps, float rescale,
                                    float clip, float wd, float lower,
                                    float upper, int flags,
                                    const int* nonfinite, int* launches,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static thread_local Params p;   // ~27 KB: off the host stack
  int i = 0;
  while (i < n_leaves) {
    const int blocks = fill_table(p.t, table, 5, n_leaves, i);
    if (p.t.n_leaves == 0) break;
    p.flags = flags & (kRescale | kClip);
    p.hp = hp;
    p.nonfinite = nonfinite;
    p.partials = partials;
    p.b1 = b1;
    p.b2 = b2;
    p.omb1 = omb1;
    p.omb2 = omb2;
    p.eps = eps;
    p.rescale = rescale;
    p.clip = clip;
    p.wd = wd;
    p.lower = lower;
    p.upper = upper;
    lamb_phase1_kernel<<<blocks, kThreads, 0, s>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
    lamb_phase2_kernel<<<blocks, kThreads, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}
