"""``train_gpt.py``'s loop, hybridized, as a user writes it who keeps the
logits: ``logits = net(x)`` at the loop's level, so the last step's
logits are still held when the next step calls the net.  ``gpt2_124m`` (B
= 8, T = 1024, dropout 0.1, ``Normal(0.02)`` from seed 0, Adam), fp32 and
cast to bf16, hybridized and ``hybridize(False)`` from one seed.

For each: the losses of ``--check`` warm-up steps and ``--steps`` timed
steps; the timed steps' ms by CUDA events (median, spread) and their peak
allocated bytes; the allocator's reserve after ``empty_cache`` with the
net, its optimizer and the last logits alive; for the hybridized loop its
captures, replays, live programs and their pool bytes.  The hybridized
loop must equal the eager one bit for bit (losses and weights).

Run it on the card from the root of the tree whose package it measures
(two trees compare in one call, each from its own root)::

    python3 tools/torch_hybrid_held.py [--steps 5] [--check 3] [--out F]

It prints one line per loop and, with ``--out``, writes them as JSON."""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

V, B, T, LR, DROPOUT, SEED = 50257, 8, 1024, 1e-4, 0.1, 0


def batch(rng):
    """``train_gpt.py``'s ``make_batch``: arithmetic sequences mod V."""
    start = rng.randint(0, V, (B, 1))
    stride = rng.randint(1, 4, (B, 1))
    seq = (start + stride * np.arange(T + 1)[None]) % V
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def loop(dtype, hybrid, check, steps):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd as ag
    from incubator_mxnet_tpu_torch.models import gpt
    mx.random.seed(SEED)
    net = gpt.gpt2_124m(vocab_size=V, dropout=DROPOUT)
    net.initialize(init=mx.init.Normal(0.02))
    if dtype is not None:
        net.cast(dtype)
    net.hybridize(hybrid)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(SEED)
    mx.random.seed(SEED + 1)
    losses, ms = [], []
    t0 = time.perf_counter()
    for s in range(check + steps):
        if s == check:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        x, y = batch(rng)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        with ag.record():
            logits = net(mx.nd.array(x, dtype="int32"))
            L = loss_fn(logits.reshape((-1, V)), mx.nd.array(
                y.reshape(-1).astype(np.float32))).mean()
        L.backward()
        trainer.step(1)
        b.record()
        b.synchronize()
        losses.append(float(L.asnumpy()))
        if s >= check:
            ms.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    out = {"dtype": dtype or "float32", "hybrid": hybrid, "losses": losses,
           "ms": ms, "median_ms": float(np.median(ms)),
           "spread": (max(ms) - min(ms)) / float(np.median(ms)),
           "peak_allocated": peak,
           "reserved": torch.cuda.memory_reserved(),
           "seconds": time.perf_counter() - t0}
    cg = net._cached_graph
    if cg is not None:
        out.update(captures=cg.captures, replays=cg.replays,
                   programs=sum(len(e.programs)
                                for e in cg._cache.values()),
                   pool_bytes=sum(p.pool_bytes for e in cg._cache.values()
                                  for p in e.programs))
    weights = [p.data()._data.clone() for p in
               net.collect_params().values()]
    del logits, L, net, trainer
    torch.cuda.empty_cache()
    return out, weights


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--check", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    rows, ok = [], True
    for dtype in (None, "bfloat16"):
        runs = {h: loop(dtype, h, args.check, args.steps)
                for h in (True, False)}
        same = runs[True][0]["losses"] == runs[False][0]["losses"] and all(
            torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(runs[True][1], runs[False][1]))
        ok = ok and same
        for h in (True, False):
            row = runs[h][0]
            row["equal_to_eager"] = same
            rows.append(row)
            print(json.dumps({k: v for k, v in row.items()
                              if k != "losses"}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    if not ok:
        print("the hybridized loop differs from the eager loop",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
