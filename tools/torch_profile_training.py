#!/usr/bin/env python3
"""Where the PyTorch port's BERT training step spends its time on one
NVIDIA GPU.

Run from the repository root on a machine with one CUDA card::

    python3 tools/torch_profile_training.py [--seed 0] [--repeats 5]
        [--root DIR]

``--root`` measures the ``incubator_mxnet_tpu_torch`` package of another
checkout (for example an older commit unpacked with ``git archive``)
with this script's method, so two trees compare in one call: the
package, and so its kernels (built into ``DIR/build/kernels``), come
from ``DIR``; the set-up and the measurement from this tree.

Builds ``chip_smoke.py``'s training set-up: BERT-large at full width and
depth (random ``Normal(0.02)`` weights from ``--seed``) with the
pretraining heads and loss, Adam (lr 1e-4) through the one-device
``SPMDTrainer``, fp32 with TF32 off, on ``bench.py``'s batch (B = 32,
T = 128, ``chip_smoke.bert_batch``).  After 3 steps it measures these
windows with ``tools/torch_profile_serving.py``'s ``measure`` (median
host-clock wall of ``--repeats`` unprofiled runs, each ending
synchronised, then one ``torch.profiler`` run: device time, host
launches, idle share, top kernels, top host operators):

* ``step``: one ``SPMDTrainer.step`` as the tree runs it (a CUDA graph
  replay where the tree captures the step; the eager step before);
* ``step-eager``: one step with the body run eagerly (trees whose
  trainer has ``_eager_steps`` only);
* ``fwd-bwd``: the step's loss and gradients alone;
* ``adam``: the optimizer's update alone, on those gradients.

For each window it also prints the device time of the attention kernels
(K1 flash_fwd, K6 flash_bwd_dq, K7 flash_bwd_dkv) and of K8
multi_tensor_adam, and ends with one ``summary:`` JSON line.  Every line
carries the card's name and power limit."""
import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))

from chip_smoke import (BERT_VOCAB, TRAIN_B, TRAIN_T,  # noqa: E402
                        bert_batch, card_line)
from torch_profile_serving import measure, kernel_times  # noqa: E402

# each kernel's label and the substrings of its profiler names: K8 is
# ``multi_tensor_adam_kernel`` in older checkouts and the Adam instance
# ``rule_kernel<6>`` of the shared update body in newer ones
KERNELS = {"flash_fwd_kernel": ("flash_fwd_kernel",),
           "flash_bwd_dq_kernel": ("flash_bwd_dq_kernel",),
           "flash_bwd_dkv_kernel": ("flash_bwd_dkv_kernel",),
           "multi_tensor_adam_kernel": ("multi_tensor_adam_kernel",
                                        "rule_kernel<6>")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--root", default=str(HERE),
                    help="the checkout whose package is measured")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this measurement runs only on a "
                         "GPU")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels.flash_attention")
    pkg = Path(fa.__file__).resolve().parents[2]
    if pkg != root:
        raise SystemExit(f"imported the package from {pkg}, not {root}")
    from incubator_mxnet_tpu_torch import initializer as init
    from incubator_mxnet_tpu_torch.models import bert as bert_mod
    from incubator_mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; package from {root}",
          flush=True)

    V, B, T = BERT_VOCAB, TRAIN_B, TRAIN_T
    net = bert_mod.BERTForPretrain(bert_mod.bert_large(dropout=0.0),
                                   vocab_size=V)
    net.initialize(init.Normal(0.02), seed=args.seed)
    trainer = SPMDTrainer(net, bert_mod.BERTPretrainLoss(V), "adam",
                          {"learning_rate": 1e-4},
                          mesh=make_mesh({"data": 1}))
    batch = bert_batch(V, B, T, args.seed)
    for _ in range(3):
        trainer.step(*batch)
    torch.cuda.synchronize()
    params = list(trainer.params.values())
    state = {}

    def grads():
        state["grads"] = trainer._loss_and_grads(*batch)[1]

    # the step as a 0-d tensor, which every tree's update takes
    step = torch.tensor(trainer._step_count + 1, dtype=torch.int32,
                        device=params[0].device)

    def update():
        trainer._opt.update(params, state["grads"], trainer._opt_state, step)

    def eager_step():
        with trainer._eager_steps():
            trainer.step(*batch)

    windows = [("step", lambda: None, lambda: trainer.step(*batch))]
    if hasattr(trainer, "_eager_steps"):
        windows.append(("step-eager", lambda: None, eager_step))
    windows += [("fwd-bwd", lambda: None, grads), ("adam", grads, update)]
    fa.reset_launch_counts()
    summary = {"root": str(root), "card": card}
    for name, setup, window in windows:
        r = measure(name, setup, window, args.repeats, card)
        summary[name] = {k: r[k] for k in ("wall_ms", "walls", "device_ms",
                                           "host_launches", "idle_share")}
    # one more profiled step: each kernel's device time in it
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.step(*batch)
        torch.cuda.synchronize()
    kt = kernel_times(prof)
    busy = sum(t for t, _ in kt.values())
    for k, subs in KERNELS.items():
        mine = [v for n, v in kt.items() if any(x in n for x in subs)]
        t = sum(t for t, _ in mine)
        c = sum(c for _, c in mine)
        summary.setdefault("kernels", {})[k] = {"ms": t / 1e3, "count": c}
        print(f"step: {k} {t / 1e3:.3f} ms x{c} "
              f"({100 * t / busy if busy else 0.0:.1f}% of the step's "
              f"device time) [{card}]", flush=True)
    pool = getattr(trainer, "graph_pool_bytes", None)
    summary["graph_pool_bytes"] = pool() if pool else None
    summary["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    print(f"launches: {dict(fa.launch_counts)}", flush=True)
    print("summary: " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
