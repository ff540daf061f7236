#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes on one NVIDIA GPU.

Run from the repository root on a machine with one CUDA card::

    python3 tools/torch_profile_serving.py [--seed 0] [--repeats 5]

Builds the model, engine and prompts through ``chip_smoke.py``'s
``build_served`` and ``served_requests``, and measures the windows of
``chip_smoke.serving_windows`` with its ``profile_window``, so both
scripts measure one set-up: ``gpt2_124m`` at full width (random
``Normal(0.02)`` weights from ``--seed``) behind the default paged
``GenerationEngine`` (8 slots, max_len 1024, bursts of 8), its closed
program set captured as CUDA graphs at warmup, with all 8 slots holding
the smoke's prompts of 5 to 700 tokens:

* ``burst``: one ``decode_burst`` of 8 steps over the 8 live slots;
* ``decode``: one per-step ``decode`` over the 8 live slots;
* ``prefill-1024`` / ``prefill-64``: one prefix-cache-miss prefill in
  the 1024- and 64-token buckets;
* ``spec-step``: one speculative step over the 8 live slots of a second
  target engine with ``chip_smoke.py``'s 6-layer draft attached
  (``build_draft``, ``spec_k`` 4), and its two parts on their own:
  ``spec-draft``, the draft's burst of 4 steps, and ``verify``, the
  target's verify of 5 rows per slot.

For each window it prints the host-clock wall time (median of
``--repeats`` unprofiled runs, each ending synchronised), then one
``torch.profiler`` run of the same window: the summed device time of
every kernel and copy, the host API calls that launch work on the card,
the device's idle share (1 - device time / unprofiled wall), the kernels
that take the most device time, and the host-side operators that take
the most CPU time.  Every line carries the card's name and power limit."""
import argparse
import importlib
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (LENGTHS, build_draft, build_served,  # noqa: E402
                        card_line, profile_window, program_line,
                        served_requests, serving_windows)


def kernel_times(prof):
    """{kernel name: (device us, launches)} from a profiler run."""
    out = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.end - evt.time_range.start
        t, n = out.get(evt.name, (0.0, 0))
        out[evt.name] = (t + us, n + 1)
    return out


def measure(name, setup, window, repeats, card):
    """``profile_window`` of ``window``; print its numbers and the
    profiled run's breakdown."""
    r, prof = profile_window(setup, window, repeats)
    print(f"{name}: wall {r['wall_ms']:.3f} ms (median of {repeats}: "
          f"{', '.join(f'{w:.3f}' for w in r['walls'])}); device "
          f"{r['device_ms']:.3f} ms in {r['device_ops']} kernels and copies; "
          f"{r['host_launches']} host launches; idle share "
          f"{r['idle_share']:.3f} [{card}]", flush=True)
    kt = kernel_times(prof)
    busy = max(r["device_ms"], 1e-9)
    if not kt:
        print(f"{name}: the profiler recorded no device time", flush=True)
    for kname, (t, n) in sorted(kt.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"{name}:   {t / 1e3:8.3f} ms {100 * t / 1e3 / busy:5.1f}% "
              f"x{n:<4d} {kname[:100]}", flush=True)
    # the host side: operators by self CPU time (profiled, so inflated)
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    host = sum(e.self_cpu_time_total for e in ops) / 1e3
    print(f"{name}: host aten ops {host:.3f} ms self CPU (profiled) in "
          f"{sum(e.count for e in ops)} calls; top:", flush=True)
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"{name}:   {e.self_cpu_time_total / 1e3:8.3f} ms "
              f"x{e.count:<4d} {e.key}", flush=True)
    return r


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
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)

    net, eng = build_served(args.seed)
    prompts, _ = served_requests(net._vocab_size, args.seed)
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    spec = GenerationEngine(net, name="spec")
    spec.attach_draft(GenerationEngine(build_draft(net), name="draft6"))
    spec.warmup()
    for what, e in (("plain", eng), ("spec target", spec),
                    ("spec draft", spec.draft)):
        program_line(what, e, card)
    live = int(np.sum(np.array(LENGTHS) + 1))
    print(f"slots: prompts {LENGTHS} ({live} live positions), bursts of "
          f"{eng.scan_steps}", flush=True)
    fa.reset_launch_counts()
    serving_windows(eng, spec, prompts,
                    lambda name, setup, window: measure(
                        name, setup, window, args.repeats, card))
    print(f"launches: {dict(fa.launch_counts)}", flush=True)


if __name__ == "__main__":
    main()
