// K8 multi_tensor_adam: the train step's whole-tree Adam update, every
// parameter leaf in one launch.
//
// Replaces: no Pallas kernel.  In the JAX package XLA fuses the tree map
// of incubator_mxnet_tpu/parallel/optim.py adam's update into the step
// program; this is the port's counterpart of that fused update.  Same
// function as the per-leaf plain version (optimizer/fused.py, itself
// optimizer/cores.py prep_grad + adam), element by element and in the same
// order, one fp32 rounding per torch op:
//   g = g * rescale            (when rescale != 1)
//   g = clamp(g, -clip, clip)  (when clip)
//   g = g + wd * w             (when wd)
//   m = m * beta1 + g * (1 - beta1)
//   v = v * beta2 + (g * (1 - beta2)) * g
//   w = w - (m * lr_t) / (sqrt(v) + eps)
// Every operation is an explicitly rounded intrinsic (__fmul_rn, ...):
// nvcc would otherwise contract a * b + c into one FMA, which rounds once
// where torch rounds twice, so the update is bit for bit the plain
// version's on the card.  lr_t (the bias-corrected learning rate) is read
// from a device pointer, so a CUDA graph that computes it on the device
// replays with each step's value.
//
// Bound on this card: bytes.  Each parameter reads w, g, m, v and writes
// w, m, v: 28 bytes for ~15 FLOP.
//
// Design: a grid-stride-free chunked map.  Each leaf is cut into chunks of
// kChunk elements; block b owns one chunk and finds its leaf by a binary
// search over the per-leaf first-block table.  The leaf table (four
// pointers and a length per leaf) and the first-block table travel as the
// kernel's one __grid_constant__ parameter (~23 KB, CUDA >= 12.1), so a
// launch needs no device-side table and a captured launch keeps the
// addresses it was captured with.  A chunk whose four pointers are 16-byte
// aligned moves float4s; a leaf's last chunk finishes its < 4 ragged
// elements one by one, and an unaligned leaf runs scalar.  More than
// kMaxLeaves leaves take one launch per kMaxLeaves.
#include "common.cuh"

namespace {

constexpr int kMaxLeaves = 512;
constexpr int kChunk = 16384;   // elements per block
constexpr int kThreads = 256;

enum : int { kRescale = 1, kClip = 2, kWd = 4 };

struct Leaf {
  float* w;
  const float* g;
  float* m;
  float* v;
};

struct Params {
  Leaf leaf[kMaxLeaves];
  long long n[kMaxLeaves];
  int first_block[kMaxLeaves + 1];
  unsigned char vec[kMaxLeaves];
  int n_leaves;
  int flags;
  const float* lr;
  float beta1, beta2, omb1, omb2, eps, rescale, clip, wd;
};

__device__ __forceinline__ void adam_elem(float& w, float g, float& m,
                                          float& v, const Params& p,
                                          float lr) {
  if (p.flags & kRescale) g = __fmul_rn(g, p.rescale);
  if (p.flags & kClip)    // torch.clamp: a NaN passes through
    g = isnan(g) ? g : fminf(fmaxf(g, -p.clip), p.clip);
  if (p.flags & kWd) g = __fadd_rn(g, __fmul_rn(w, p.wd));
  m = __fadd_rn(__fmul_rn(m, p.beta1), __fmul_rn(g, p.omb1));
  v = __fadd_rn(__fmul_rn(v, p.beta2), __fmul_rn(__fmul_rn(g, p.omb2), g));
  w = __fsub_rn(w, __fdiv_rn(__fmul_rn(m, lr),
                             __fadd_rn(__fsqrt_rn(v), p.eps)));
}

__global__ void __launch_bounds__(kThreads)
multi_tensor_adam_kernel(const __grid_constant__ Params p) {
  const int b = blockIdx.x;
  int lo = 0, hi = p.n_leaves - 1;      // last leaf with first_block <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.first_block[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int li = lo;
  const Leaf L = p.leaf[li];
  const long long begin =
      static_cast<long long>(b - p.first_block[li]) * kChunk;
  const long long rest = p.n[li] - begin;
  const int len = rest < kChunk ? static_cast<int>(rest) : kChunk;
  const float lr = *p.lr;
  float* w = L.w + begin;
  const float* g = L.g + begin;
  float* m = L.m + begin;
  float* v = L.v + begin;
  int done = 0;
  if (p.vec[li]) {
    const int n4 = len >> 2;
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float4 wv = w4[i], mv = m4[i], vv = v4[i];
      const float4 gv = g4[i];
      adam_elem(wv.x, gv.x, mv.x, vv.x, p, lr);
      adam_elem(wv.y, gv.y, mv.y, vv.y, p, lr);
      adam_elem(wv.z, gv.z, mv.z, vv.z, p, lr);
      adam_elem(wv.w, gv.w, mv.w, vv.w, p, lr);
      w4[i] = wv;
      m4[i] = mv;
      v4[i] = vv;
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) {
    float wv = w[i], mv = m[i], vv = v[i];
    adam_elem(wv, g[i], mv, vv, p, lr);
    w[i] = wv;
    m[i] = mv;
    v[i] = vv;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<unsigned long long>(ptr) & 15ull) == 0;
}

}  // namespace

// table: n_leaves rows of (w, g, m, v, numel) as 64-bit integers, in host
// memory; read here, before the launch returns.  lr: a device fp32 scalar.
extern "C" int mx_multi_tensor_adam(const long long* table, int n_leaves,
                                    const float* lr, float beta1,
                                    float beta2, float omb1, float omb2,
                                    float eps, float rescale, float clip,
                                    float wd, int flags, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static thread_local Params p;   // ~23 KB: off the host stack
  int i = 0;
  while (i < n_leaves) {
    int k = 0, blocks = 0;
    for (; i < n_leaves && k < kMaxLeaves; ++i) {
      const long long* row = table + 5 * static_cast<long long>(i);
      const long long n = row[4];
      if (n <= 0) continue;
      Leaf L{reinterpret_cast<float*>(row[0]),
             reinterpret_cast<const float*>(row[1]),
             reinterpret_cast<float*>(row[2]),
             reinterpret_cast<float*>(row[3])};
      p.leaf[k] = L;
      p.n[k] = n;
      p.vec[k] = aligned16(L.w) && aligned16(L.g) && aligned16(L.m) &&
                 aligned16(L.v);
      p.first_block[k] = blocks;
      blocks += static_cast<int>((n + kChunk - 1) / kChunk);
      ++k;
    }
    if (k == 0) break;
    p.first_block[k] = blocks;
    p.n_leaves = k;
    p.flags = flags;
    p.lr = lr;
    p.beta1 = beta1;
    p.beta2 = beta2;
    p.omb1 = omb1;
    p.omb2 = omb2;
    p.eps = eps;
    p.rescale = rescale;
    p.clip = clip;
    p.wd = wd;
    multi_tensor_adam_kernel<<<blocks, kThreads, 0, s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
