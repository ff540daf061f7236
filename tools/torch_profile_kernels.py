#!/usr/bin/env python3
"""Time the port's attention kernels of one source tree on one NVIDIA GPU,
the same way for any tree, so two trees can be compared in one call.

Run from the repository root on a machine with one CUDA card::

    python3 tools/torch_profile_kernels.py                      # this tree
    python3 tools/torch_profile_kernels.py --root build/parent  # another tree

For an A/B of a change against its parent, unpack the parent into a
directory that ``.gitignore`` lists and run the two in turns in one
command (parent, change, change, parent)::

    git archive <parent> --prefix=parent/ | tar -x -C build
    for r in build/parent . . build/parent; do
        python3 tools/torch_profile_kernels.py --root $r; done

It imports ``incubator_mxnet_tpu_torch.kernels.flash_attention`` from
``--root`` (building that tree's kernels into its own ``build/``) and
calls only functions every tree of the port has, on inputs drawn from
``--seed``: K1 ``flash_attention`` at the serving shape (B=1 H=12
T=1024 D=64 causal) and ``flash_attention_lse`` at the training shape
(B=32 H=16 T=128 D=64 dense, no gradient recorded), the backward at
that shape through ``_flash_bwd_cuda`` (K6 then K7, on lse and dd from
``flash_attention_lse`` and ``_bwd_dd``) and K6 and K7 each alone, K2
``paged_decode_attention`` and K3 ``decode_attention`` at
``chip_smoke.py``'s decode shape and inputs (``decode_inputs``: 8 slots
at positions 0..1023, 12 heads of 64, blocks of 16, 64 blocks a slot),
and K4 ``paged_verify_decode_attention`` and K5
``verify_decode_attention`` at ``check_k4_k5``'s timed shape and inputs
(the same slots with Q = 5 query rows, tables holding 9 rows' blocks).
Each is timed over 8 (K1, K6, K7) or 12 (K2-K5) rotating input sets by
this tree's ``chip_smoke.py`` timers, two ways: on the card (``device_ms``:
one round captured in a CUDA graph, replayed between CUDA events) and
eagerly (``time_ms``: CUDA events around the Python calls, host work
included).  Prints one line
per kernel and, last, one JSON object with every number, the tree and
the card's name and power limit."""
import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

# the timers and decode inputs of this tree's chip_smoke.py, which imports
# no port module at import time, so the port below can come from --root
from chip_smoke import (card_line, decode_inputs, dense_view,  # noqa: E402
                        device_ms, time_ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="the source tree whose kernels are timed")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_kernels: no CUDA device")
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels.flash_attention")
    if not fa.__file__.startswith(root):
        raise SystemExit(f"imported {fa.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    rng = np.random.RandomState(args.seed)
    torch.manual_seed(args.seed)
    out = {}

    def rand(*shape):
        return torch.randn(*shape, device=dev)

    def report(name, fn, sets, reps):
        out[name] = {"card_ms": device_ms(fn, sets, reps),
                     "eager_ms": time_ms(fn, sets, reps)}
        print(f"{name}: {out[name]['card_ms']:.4f} ms on the card, "
              f"{out[name]['eager_ms']:.4f} ms eager [{card}; {root}]",
              flush=True)

    serve = [tuple(rand(1, 12, 1024, 64) for _ in range(3)) for _ in range(8)]
    report("flash_fwd serving B=1 H=12 T=1024 D=64 causal",
           lambda q, k, v: fa.flash_attention(q, k, v, scale=0.125,
                                              causal=True), serve, 20)
    del serve
    train = [tuple(rand(32, 16, 128, 64) for _ in range(3)) for _ in range(8)]
    report("flash_fwd+lse training B=32 H=16 T=128 D=64 dense",
           lambda q, k, v: fa.flash_attention_lse(q, k, v, scale=0.125),
           train, 20)
    del train
    # the backward at the training shape: K6 then K7 through the wrapper,
    # then each kernel alone, on lse and dd from the forward
    BH, T, D = 32 * 16, 128, 64
    bwd = []
    for _ in range(8):
        q, k, v, g = (rand(32, 16, T, D) for _ in range(4))
        o, lse = fa.flash_attention_lse(q, k, v, scale=0.125)
        flat = [x.reshape(BH, T, D) for x in (o, q, k, v, g)]
        bwd.append((*flat[1:], lse.reshape(BH, T),
                    fa._bwd_dd(flat[0], flat[4])))
    report("flash_bwd (K6 + K7) training B=32 H=16 T=128 D=64 dense",
           lambda q, k, v, g, lse, dd: fa._flash_bwd_cuda(
               q, k, v, None, g, lse, dd, 0.125, False, 16), bwd, 20)
    dq, dk, dv = (torch.empty(BH, T, D, device=dev) for _ in range(3))
    dbs = torch.empty(BH, T, device=dev)
    # dense; a tree whose K6/K7 take an element type (fp32 here) after
    # the causal flag
    shape = (BH, 16, T, D, 0.125, 0) + \
        ((0,) if hasattr(fa, "DTYPE_CODES") else ())
    report("flash_bwd_dq (K6) training B=32 H=16 T=128 D=64 dense",
           lambda q, k, v, g, lse, dd: fa._launch(
               "flash_bwd_dq", q, k, v, None, g, lse, dd, dq, *shape),
           bwd, 20)
    report("flash_bwd_dkv (K7) training B=32 H=16 T=128 D=64 dense",
           lambda q, k, v, g, lse, dd: fa._launch(
               "flash_bwd_dkv", q, k, v, None, g, lse, dd, dk, dv, dbs,
               *shape), bwd, 20)
    del bwd
    sets, tables, pos, _, _ = decode_inputs(dev, rng, 12)
    report("paged_decode S=8 H=12 D=64 bs=16 MB=64",
           lambda q, kp, vp: fa.paged_decode_attention(
               q, kp, vp, tables, pos, scale=0.125), sets, 50)
    dsets = [(q, dense_view(kp, tables), dense_view(vp, tables))
             for q, kp, vp in sets]
    del sets
    report("decode S=8 H=12 D=64 T=1024",
           lambda q, k, v: fa.decode_attention(q, k, v, pos, scale=0.125),
           dsets, 50)
    del dsets
    sets, tables, pos, _, _ = decode_inputs(dev, rng, 12, rows=9)
    vsets = [(rand(8, 12, 5, 64), kp, vp) for _, kp, vp in sets]
    del sets
    report("paged_verify S=8 H=12 Q=5 D=64 bs=16 MB=64",
           lambda q, kp, vp: fa.paged_verify_decode_attention(
               q, kp, vp, tables, pos, scale=0.125), vsets, 50)
    dsets = [(q, dense_view(kp, tables), dense_view(vp, tables))
             for q, kp, vp in vsets]
    del vsets
    report("verify S=8 H=12 Q=5 D=64 T=1024",
           lambda q, k, v: fa.verify_decode_attention(q, k, v, pos,
                                                      scale=0.125),
           dsets, 50)
    print(json.dumps({"root": root, "card": card, "kernels": out,
                      "ms_per": "mean per call"}), flush=True)


if __name__ == "__main__":
    main()
