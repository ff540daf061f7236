#!/usr/bin/env python3
"""How close K1, K6 and K7's product arithmetic comes to their fp32 plain
versions, emulated on the CPU with numpy (no card needed; the numbers are
of the arithmetic, not of the device).

Run from the repository root::

    python3 tools/tf32_split_error.py [--seeds 5]

The attention forward with lse and the FlashAttention-2 backward are
computed with every T x T x D product done three ways, then held to the
port's plain versions (``_plain_attention_lse``, ``_plain_flash_bwd_dd``)
on the same inputs, as ``tests/test_torch_flash_bwd.py``'s card test
holds the kernels (atol = rtol = 1e-4):

* ``1xtf32``: both operands truncated to TF32 (10 mantissa bits), one
  product;
* ``3xtf32``: the kernels' split (``csrc/tf32_mma.cuh``): hi = x
  truncated, lo = x - hi truncated, a_lo b_hi + a_hi b_lo + a_hi b_hi;
* ``exact``: the products in float64, rounded to fp32.

Sums run in float64 (the tensor core's fp32 accumulation is not
emulated).  For each way and each scale of q and k (the scores grow with
its square), it prints the worst ratio of error to tolerance over every
output and ``--seeds`` seeds at B*H = 8, T = 128, D = 64; a ratio above 1
misses the tolerance."""
import argparse
import importlib
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

fa = importlib.import_module(
    "incubator_mxnet_tpu_torch.kernels.flash_attention")

F32 = np.float32


def _trunc(x):
    return (x.astype(F32).view(np.uint32) & np.uint32(0xffffe000)).view(F32)


def _mm(x, y):
    return np.matmul(x.astype(np.float64), y.astype(np.float64))


def mm_1xtf32(a, b):
    return _mm(_trunc(a), _trunc(b)).astype(F32)


def mm_3xtf32(a, b):
    ah, bh = _trunc(a), _trunc(b)
    al, bl = _trunc(a - ah), _trunc(b - bh)
    return (_mm(al, bh) + _mm(ah, bl) + _mm(ah, bh)).astype(F32)


def mm_exact(a, b):
    return _mm(a, b).astype(F32)


def attention_bwd(mm, q, k, v, g, scale):
    """out, lse, dq, dk, dv with every product through ``mm``."""
    def t(x):
        return x.transpose(0, 2, 1)
    s = mm(q, t(k)) * scale
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l_ = p.sum(-1, keepdims=True)
    out = mm(p, v) / l_
    lse = (m + np.log(l_))[..., 0]
    dd = (out * g).sum(-1)
    p = np.exp(s - lse[..., None])
    ds = p * (mm(g, t(v)) - dd[..., None])
    return (out, lse, mm(ds, k) * scale, mm(t(ds), q) * scale,
            mm(t(p), g))


def worst_ratio(mm, seed, mag, bh=8, T=128, D=64):
    rng = np.random.RandomState(seed)
    q, k = (rng.randn(bh, T, D).astype(F32) * F32(mag) for _ in range(2))
    v, g = (rng.randn(bh, T, D).astype(F32) for _ in range(2))
    scale = F32(1.0 / np.sqrt(D))
    got = attention_bwd(mm, q, k, v, g, scale)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = fa._plain_attention_lse(tq, tk, tv, float(scale), False)
    want = (out, lse) + fa._plain_flash_bwd_dd(
        tq, tk, tv, None, tg, lse, fa._bwd_dd(out, tg), float(scale),
        False, 1)[:3]
    return max(float((np.abs(a - b.numpy())
                      / (1e-4 + 1e-4 * np.abs(b.numpy()))).max())
               for a, b in zip(got, want))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    args = ap.parse_args()
    for mag in (1, 2, 4, 8):
        for name, mm in (("1xtf32", mm_1xtf32), ("3xtf32", mm_3xtf32),
                         ("exact", mm_exact)):
            r = [worst_ratio(mm, s, mag) for s in range(args.seeds)]
            print(f"q, k x{mag}: {name:7s} worst error / tolerance per seed "
                  + " ".join(f"{x:.3f}" for x in r), flush=True)


if __name__ == "__main__":
    main()
