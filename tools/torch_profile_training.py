#!/usr/bin/env python3
"""Where the PyTorch port's BERT training step spends its time on one
NVIDIA GPU.

Run from the repository root on a machine with one CUDA card::

    python3 tools/torch_profile_training.py [--seed 0] [--repeats 5]

Builds ``chip_smoke.py``'s training set-up: BERT-large at full width and
depth (random ``Normal(0.02)`` weights from ``--seed``) with the
pretraining heads and loss, Adam (lr 1e-4) through the one-device
``SPMDTrainer``, fp32 with TF32 off, on ``bench.py``'s batch (B = 32,
T = 128, ``chip_smoke.bert_batch``).  After 2 warm-up steps it measures
three windows with ``tools/torch_profile_serving.py``'s ``measure``
(median host-clock wall of ``--repeats`` unprofiled runs, then one
``torch.profiler`` run: device kernel time, idle share, top kernels, top
host operators):

* ``step``: one ``SPMDTrainer.step`` (forward, backward, Adam);
* ``fwd-bwd``: the step's loss and gradients alone;
* ``adam``: the optimizer's update alone, on those gradients.

For each window it also prints the device time of the attention kernels
(K1 flash_fwd, K6 flash_bwd_dq, K7 flash_bwd_dkv) and their share of the
window's device time.  Every line carries the card's name and power
limit."""
import argparse
import importlib
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import (BERT_VOCAB, TRAIN_B, TRAIN_T,  # noqa: E402
                        bert_batch, card_line)
from torch_profile_serving import measure  # noqa: E402

ATTENTION = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
             "flash_bwd_dkv_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this measurement runs only on a "
                         "GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels.flash_attention")
    from incubator_mxnet_tpu_torch import initializer as init
    from incubator_mxnet_tpu_torch.models import bert as bert_mod
    from incubator_mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)

    V, B, T = BERT_VOCAB, TRAIN_B, TRAIN_T
    net = bert_mod.BERTForPretrain(bert_mod.bert_large(dropout=0.0),
                                   vocab_size=V)
    net.initialize(init.Normal(0.02), seed=args.seed)
    trainer = SPMDTrainer(net, bert_mod.BERTPretrainLoss(V), "adam",
                          {"learning_rate": 1e-4},
                          mesh=make_mesh({"data": 1}))
    batch = bert_batch(V, B, T, args.seed)
    for _ in range(2):
        trainer.step(*batch)
    torch.cuda.synchronize()
    params = list(trainer.params.values())
    state = {}

    def grads():
        state["grads"] = trainer._loss_and_grads(*batch)[1]

    def update():
        trainer._opt.update(params, state["grads"], trainer._opt_state,
                            trainer._step_count + 1)

    fa.reset_launch_counts()
    for name, setup, window in (
            ("step", lambda: None, lambda: trainer.step(*batch)),
            ("fwd-bwd", lambda: None, grads),
            ("adam", grads, update)):
        wall, kt = measure(name, setup, window, args.repeats, card)
        busy = sum(t for t, _ in kt.values())
        att = {k: sum(t for n, (t, _) in kt.items() if k in n)
               for k in ATTENTION}
        n_att = {k: sum(c for n, (_, c) in kt.items() if k in n)
                 for k in ATTENTION}
        share = sum(att.values()) / busy if busy else 0.0
        print(f"{name}: attention kernels "
              + ", ".join(f"{k} {att[k] / 1e3:.3f} ms x{n_att[k]}"
                          for k in ATTENTION)
              + f"; {100 * share:.1f}% of the window's device time "
              f"[{card}]", flush=True)
    print(f"launches: {dict(fa.launch_counts)}", flush=True)


if __name__ == "__main__":
    main()
