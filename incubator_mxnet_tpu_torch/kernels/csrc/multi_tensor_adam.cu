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
// It is the kAdam instance of the elementwise rules' one kernel body
// (multi_tensor_common.cuh rule_kernel, which K9's six rules share):
// explicitly rounded intrinsics, so the update is bit for bit the plain
// version's on the card; lr_t (the bias-corrected learning rate) read from
// a device pointer, so a CUDA graph that computes it on the device replays
// with each step's value; the skip_nonfinite guard's flag read before any
// write.
//
// Bound on this card: bytes.  Each parameter reads w, g, m, v and writes
// w, m, v: 28 bytes for ~15 FLOP in fp32, 14 in the 16-bit instance
// (cast nets in the Gluon loop), 16 in the promoting one (SPMDTrainer's
// first step of a cast net: 16-bit w, g, m, v read, m, v written, fp32 w
// written), 22 in the multi_precision one (fp32 master, m, v; fp16 g and
// weight copy).  The instance is the `prec` argument (multi_tensor_common.cuh
// PrecId).
//
// The skip_nonfinite guard's check (the Gluon Trainer's; the JAX package
// gates its fused update with an all-finite flag inside the one compiled
// program, optimizer/fused.py): mx_all_finite reads every gradient leaf
// over the same chunked leaf table in one launch and sets a device int
// flag where it meets a NaN or an Inf (the caller zeroes the flag first).
// A guarded K8, K9 or K10 launch later on the same stream reads that flag.
// The check's bound is its 4 bytes read per parameter (2 for the 16-bit
// gradients of a cast net, the dtype a template parameter).
#include "multi_tensor_common.cuh"

using namespace mxmt;

namespace {

struct FiniteParams {
  Table t;     // g and n only
  int* flag;
};

__device__ __forceinline__ bool bad(float x) { return !isfinite(x); }

// a 16-bit NaN or Inf is a NaN or Inf as a float, so one test serves
template <typename T>
__global__ void __launch_bounds__(kThreads)
all_finite_kernel(const __grid_constant__ FiniteParams p) {
  const Chunk c = chunk_of(p.t, blockIdx.x);
  const char* g =
      reinterpret_cast<const char*>(p.t.g[c.leaf]) + c.begin * sizeof(T);
  bool found = false;
  int done = 0;
  if (p.t.vec[c.leaf]) {
    const int n4 = c.len >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float v[4];
      Elem<T>::load4(g, i, v);
      found |= bad(v[0]) | bad(v[1]) | bad(v[2]) | bad(v[3]);
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < c.len; i += kThreads)
    found |= bad(Elem<T>::load(g, i));
  if (__syncthreads_or(found) && threadIdx.x == 0) *p.flag = 1;
}

}  // namespace

// prec: the instance (PrecId: 0 fp32, 1 bf16, 2 fp16, 3 and 4 promoting
// bf16 and fp16, 5 fp16 with fp32 masters).  table: n_leaves rows of (w,
// g, m, v, wo, numel) as 64-bit integers, in host memory (wo: 0, or the
// new fp32 weights (promoting), or the fp16 weights the masters round to
// (multi_precision)); read here, before the launch returns.  lr: a device
// fp32 scalar.
// nonfinite: null, or the all-finite check's device flag (see above).
// launches: the launches made are added to it.
extern "C" int mx_multi_tensor_adam(int prec, const long long* table,
                                    int n_leaves,
                                    const float* lr, float beta1,
                                    float beta2, float omb1, float omb2,
                                    float eps, float rescale, float clip,
                                    float wd, int flags,
                                    const int* nonfinite, int* launches,
                                    void* stream) {
  static thread_local RuleParams p;   // ~27 KB: off the host stack
  p.flags = flags;
  p.hp = lr;
  p.nonfinite = nonfinite;
  p.a = beta1;
  p.b = beta2;
  p.oma = omb1;
  p.omb = omb2;
  p.eps = eps;
  p.rescale = rescale;
  p.clip = clip;
  p.wd = wd;
  return run_prec<kAdam>(prec, p, table, n_leaves,
                         static_cast<cudaStream_t>(stream), launches);
}

// dtype: the gradients' (0 fp32, 1 bf16, 2 fp16).  table: n_leaves rows
// of (0, g, numel) as 64-bit integers, in host memory; read here, before
// the launch returns.  flag: a device int the caller zeroed; set to 1
// where a NaN or an Inf is found.  launches: the launches made are added
// to it.
extern "C" int mx_all_finite(int dtype, const long long* table,
                             int n_leaves, int* flag, int* launches,
                             void* stream) {
  if (dtype < 0 || dtype > 2) return MX_ERR_UNSUPPORTED_DTYPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static thread_local FiniteParams p;
  int i = 0;
  while (i < n_leaves) {
    const int blocks = fill_table(p.t, table, 3, n_leaves, i);
    if (p.t.n_leaves == 0) break;
    p.flag = flag;
    if (dtype == 0)
      all_finite_kernel<float><<<blocks, kThreads, 0, s>>>(p);
    else if (dtype == 1)
      all_finite_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(p);
    else
      all_finite_kernel<__half><<<blocks, kThreads, 0, s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}
