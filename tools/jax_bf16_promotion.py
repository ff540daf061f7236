#!/usr/bin/env python
"""Does the JAX package's ``SPMDTrainer`` keep a bf16-cast net in bf16?

Runs the reference in a child interpreter on the CPU (every ``MXNET_*``
variable unset, ``JAX_PLATFORMS=cpu``; no file of the JAX package is
touched): a ``BERTForPretrain`` of 2 layers, 32 units, vocab 64, cast to
bfloat16 with ``net.cast("bfloat16")`` (as ``bench.py``'s ``_bench_bert``
casts BERT-large on the accelerator), a one-device ``SPMDTrainer`` with
``"adam"``, B = 2, T = 16.  After each of ``--steps`` steps it records the
dtype of the step's loss, of every trainable value (``_tr_vals``) and of
every Adam moment (``_opt_state``), and prints one JSON object::

    python tools/jax_bf16_promotion.py [--steps 2]

The likely cause of a promotion, read from the code: the Adam update's
``lr * coef`` (``incubator_mxnet_tpu/parallel/optim.py:126-127``) is a
float32 0-d array computed from the traced step, and a bf16 weight
minus a float32 product is float32."""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import collections, json, sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import parallel
from incubator_mxnet_tpu.models import bert as B

steps = int(sys.argv[1])
V, nb, nt = 64, 2, 16
mx.random.seed(0)
net = B.BERTForPretrain(B.BERTModel(vocab_size=V, units=32, hidden_size=64,
                                    num_layers=2, num_heads=2,
                                    max_length=32, dropout=0.0),
                        vocab_size=V)
net.initialize(init=mx.init.Normal(0.02))
net.cast("bfloat16")
rng = np.random.default_rng(0)
ids = rng.integers(0, V, (nb, nt)).astype(np.int32)
types = np.zeros((nb, nt), np.int32)
labels = np.concatenate([rng.integers(0, V, (nb, nt)),
                         rng.integers(0, 2, (nb, 1))], axis=1).astype(
                             np.float32)
tr = parallel.SPMDTrainer(net, B.BERTPretrainLoss(V), "adam",
                          {"learning_rate": 1e-4},
                          mesh=parallel.make_mesh({"data": 1},
                                                  devices=jax.devices()[:1]))


def census(arrs):
    return dict(collections.Counter(str(a.dtype) for a in arrs))


out = {"before": {"values": census(tr._tr_vals),
                  "moments": census(jax.tree.leaves(tr._opt_state))}}
for s in range(1, steps + 1):
    loss = tr.step(ids, types, labels)
    out["step%d" % s] = {
        "loss": str(loss.dtype),
        "values": census(tr._tr_vals),
        "moments": census(jax.tree.leaves(tr._opt_state))}
print(json.dumps(out))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(args.steps)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(proc.returncode)
    print(json.dumps(json.loads(proc.stdout.strip().splitlines()[-1]),
                     indent=1))


if __name__ == "__main__":
    main()
