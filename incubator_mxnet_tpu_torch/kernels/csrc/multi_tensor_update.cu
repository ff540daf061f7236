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
// on aligned chunks.
#include "multi_tensor_common.cuh"

using namespace mxmt;

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
