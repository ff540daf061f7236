#!/usr/bin/env python3
"""Device time of the attention kernels in one profiled step of the
16-bit Gluon loop of one source tree on one NVIDIA GPU, the same way for
any tree, so two trees can be compared in one call.

Run from the repository root on a machine with one CUDA card::

    python3 tools/torch_profile_gluon16.py                      # this tree
    python3 tools/torch_profile_gluon16.py --root build/parent  # another

The step is ``chip_smoke.py``'s gluon16 loop (``gluon16_net``,
``gluon16_step_fn``: ``gpt2_124m`` at B = 8, T = 1024, Adam through the
fused ``gluon.Trainer``) cast to bf16, or with ``--dtype fp16`` cast to
fp16 with ``multi_precision=True``.  ``chip_smoke.profile_window`` runs
``WARMUP`` unprofiled steps (their median wall is its ``wall_ms``), then
one step under ``torch.profiler``; the device time of that step's
kernels is summed by name.  Prints the summed time and launches of K1
(``flash_fwd*``), K6 (``flash_bwd_dq*``) and K7 (``flash_bwd_dkv*``),
K6 + K7 and the step's whole device time, then one JSON object with
every number, the tree and the card's name and power limit."""
import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

# this tree's harness; chip_smoke.py imports no port module at import
# time, so the port its helpers import can come from --root
from chip_smoke import (GLUON16_CASES, GLUON_B, GLUON_LR,  # noqa: E402
                        GLUON_T, GPT_VOCAB, SEED, card_line, gluon16_net,
                        gluon16_step_fn, gpt_batch, profile_window)

KERNELS = (("K6", "flash_bwd_dq"), ("K7", "flash_bwd_dkv"),
           ("K1", "flash_fwd"))
WARMUP = 3   # unprofiled steps before the profiled one (the first builds)


def kernel_of(name):
    """K1, K6 or K7 for a profiled kernel's name, else None."""
    for tag, stem in KERNELS:
        if stem in name:
            return tag
    return None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="the source tree whose port is run")
    ap.add_argument("--dtype", choices=("bf16", "fp16"), default="bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_gluon16: no CUDA device")
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    mx = importlib.import_module("incubator_mxnet_tpu_torch")
    if not mx.__file__.startswith(root):
        raise SystemExit(f"imported {mx.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    _, dtype, optimizer, opts, _ = next(c for c in GLUON16_CASES
                                        if c[0].startswith(args.dtype))
    net = gluon16_net(dtype)
    trainer = mx.gluon.Trainer(net.collect_params(), optimizer,
                               dict({"learning_rate": GLUON_LR}, **opts))
    step = gluon16_step_fn()
    rng = np.random.RandomState(SEED)
    stats, prof = profile_window(
        lambda: None,
        lambda: step(net, trainer, *gpt_batch(rng, GLUON_B, GLUON_T,
                                              GPT_VOCAB)),
        repeats=WARMUP)
    by = {tag: [0.0, 0] for tag, _ in KERNELS}
    for e in prof.events():
        tag = kernel_of(e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and tag:
            by[tag][0] += (e.time_range.end - e.time_range.start) / 1e3
            by[tag][1] += 1
    rec = {"dtype": args.dtype, **stats,
           **{t: {"ms": ms, "launches": n} for t, (ms, n) in by.items()},
           "K6+K7_ms": by["K6"][0] + by["K7"][0]}
    print(f"gluon16 {args.dtype}: K6 {by['K6'][0]:.4f} ms ({by['K6'][1]} "
          f"launches), K7 {by['K7'][0]:.4f} ms ({by['K7'][1]}), K6 + K7 "
          f"{rec['K6+K7_ms']:.4f} ms, K1 {by['K1'][0]:.4f} ms "
          f"({by['K1'][1]}); device {stats['device_ms']:.2f} ms in the "
          f"step [{card}; {root}]", flush=True)
    print(json.dumps({"root": root, "card": card, **rec}), flush=True)


if __name__ == "__main__":
    main()
