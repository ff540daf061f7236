#!/usr/bin/env python
"""Where does XLA round a 16-bit optimizer update?  The reference's
``SPMDTrainer`` runs its update inside ``jax.jit``; the port's plain
versions and kernels round every operation to the 16-bit type, as JAX's
eager ops do.  This measures, on the CPU with the JAX package's own Adam
formula (``incubator_mxnet_tpu/optimizer/cores.py`` ``adam``; nothing of
the repository is changed):

* the pure 16-bit update (lr cast to the weight's dtype, as the JAX
  fused update casts it): how many of N elements the jitted result
  differs from the op-by-op one in, per output;
* the promoting update (a strong fp32 lr_t with bf16 weights and
  moments, the train step's first step of a cast net): the largest and
  the median distance of three models from XLA's new weights, in units
  of the update's own size: op-by-op rounding (JAX's eager ops), every
  intermediate kept at fp32 with 16-bit-rounded constants, and XLA's
  excess precision as ``incubator_mxnet_tpu_torch/optimizer/cores.py``
  models it (each bf16 op rounded, but a result that a promoting op
  reads read unrounded);
* fp16: the share of elements whose second moment (1 - beta2) g^2
  underflows to 0 at a gradient scale (the step then divides by
  epsilon, which is 0 in fp16); and the share of a jitted fp16
  ``w - lr g`` that differs from op-by-op rounding and from one
  rounding of the exact value (a fused multiply-add), which shows
  whether XLA's CPU backend fuses fp16 multiply-adds on this host.

    python tools/jax_half_update_rounding.py [--n 100000] [--grad 1e-2]

Prints one JSON object."""
import argparse
import json


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100000)
    ap.add_argument("--grad", type=float, default=1e-2,
                    help="the gradients' scale")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    rng = np.random.default_rng(0)
    n, gs = args.n, np.float32(args.grad)
    bf = jnp.bfloat16
    w = jnp.asarray(rng.standard_normal(n).astype(np.float32)).astype(bf)
    g = jnp.asarray(rng.standard_normal(n).astype(np.float32) * gs).astype(bf)
    m = jnp.asarray(rng.standard_normal(n).astype(np.float32) * gs).astype(bf)
    v = jnp.asarray(np.abs(rng.standard_normal(n)).astype(np.float32)
                    * gs * gs).astype(bf)
    lr = jnp.asarray(1e-3, jnp.float32)

    def adam(w, g, m, v, lr):         # cores.adam with wd folded (none)
        nm = 0.9 * m + (1 - 0.9) * g
        nv = 0.999 * v + (1 - 0.999) * g * g
        return w - lr * nm / (jnp.sqrt(nv) + 1e-8), nm, nv

    def f32(x):
        return np.asarray(x.astype(jnp.float32))
    out = {"n": n, "grad_scale": float(gs)}
    # the pure 16-bit update: lr cast to the weights' dtype
    half = jax.jit(lambda *a: adam(*a[:4], a[4].astype(bf)))
    eager = adam(w, g, m, v, lr.astype(bf))
    out["bf16_update_jit_vs_op_by_op_differing"] = [
        int((f32(a) != f32(b)).sum()) for a, b in zip(half(w, g, m, v, lr),
                                                      eager)]
    # the promoting update: a strong fp32 lr
    J = f32(jax.jit(adam)(w, g, m, v, lr)[0])
    W, M, V, G = f32(w), f32(m), f32(v), f32(g)
    upd = np.abs(J - W)
    ok = upd > 0
    op_by_op = f32(adam(w, g, m, v, lr)[0])

    def b(x):
        return np.float32(f32(jnp.asarray(x, bf)))
    nm = b(0.9) * M + b(0.1) * G
    nv = b(0.999) * V + b(1 - 0.999) * G * G
    all_fp32 = W - np.float32(1e-3) * nm / (np.sqrt(nv) + b(1e-8))
    # excess precision: nm and sqrt(nv) + eps are read unrounded by the
    # promoting ops (lr * nm, the division); nv, sqrt(nv) stay rounded
    nm_x = b(b(0.9) * M) + b(b(0.1) * G)
    nv_r = b(b(0.999) * V + b(b(b(1 - 0.999) * G) * G))
    den_x = b(np.sqrt(nv_r)) + b(1e-8)
    excess = W - (np.float32(1e-3) * nm_x) / den_x
    for name, x in (("op_by_op", op_by_op), ("all_fp32", all_fp32),
                    ("excess_precision", excess)):
        rel = np.abs(x - J)[ok] / upd[ok]
        out[f"promoting_{name}_vs_jit_of_update"] = {
            "max": float(rel.max()), "median": float(np.median(rel))}
    # fp16: the share of (1 - beta2) g^2 that rounds to 0
    g16 = rng.standard_normal(n).astype(np.float32) * gs
    term = (np.float16(1 - 0.999) * g16.astype(np.float16)).astype(
        np.float16) * g16.astype(np.float16)
    out["fp16_second_moment_underflow_share"] = float(
        (term.astype(np.float16) == 0).mean())
    w16 = (rng.standard_normal(n) * 0.02).astype(np.float16)
    jit16 = np.asarray(jax.jit(lambda w, g: w - 1e-3 * g)(w16, g16.astype(
        np.float16)))
    c, gg = np.float16(1e-3), g16.astype(np.float16)
    op16 = (w16 - (c * gg).astype(np.float16)).astype(np.float16)
    fma16 = (w16.astype(np.float64) - np.float64(c) * gg.astype(
        np.float64)).astype(np.float16)
    out["fp16_sgd_jit_differs_from"] = {
        "op_by_op": float((jit16 != op16).mean()),
        "one_rounding": float((jit16 != fma16).mean())}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
