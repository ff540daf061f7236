#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s fleet phase (phase 5) alone, several times, on
one card: how often it fails, and what its capture shows each time.

Run from the repository root (or from an unpacked archive of it) on a
machine with one CUDA card::

    python3 tools/torch_fleet_repeat.py --runs 4

First a child process builds the phase's reference (``REF.json`` in a
temporary directory): the served requests (``chip_smoke.
served_requests``) and the plain tokens of each, generated alone by the
warmed ``gpt2_124m`` engine of ``chip_smoke.build_served`` (the path
phase checks that its batched tokens equal these); the serve phase's
client figures, which the fleet phase only prints beside its own, are 0.
The child exits before the fleet starts, so the card holds only the
fleet's processes.  Then ``chip_smoke.py --fleet REF.json`` runs
``--runs`` times, each in a child as the full run starts it; each run's
output goes to ``chiprun_out/fleet_repeat_<i>.log`` and a failed run's
directory (replica logs, router incidents) to ``chiprun_out/``
(``chip_smoke.keep_fleet_files``).  Prints per run its exit code, its
wall and its capture lines, and last one JSON object with them and the
card's name and power limit."""
import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def make_ref(out):
    """Write the fleet phase's reference to ``out`` (runs on the card)."""
    from chip_smoke import build_served, served_requests
    net, eng = build_served()
    prompts, budgets = served_requests(net._vocab_size)
    plain = []
    for p, b in zip(prompts, budgets):
        eng.reset()
        plain.append([int(t) for t in eng.generate(p, b)])
    serve = dict.fromkeys(("tokens_per_s", "ttft_p50", "ttft_p99",
                           "gap_p50", "gap_p99"), 0.0)
    Path(out).write_text(json.dumps({"prompts": prompts, "budgets": budgets,
                                     "plain": plain, "serve": serve}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--make-ref", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.make_ref:
        make_ref(args.make_ref)
        return
    from chip_smoke import card_line
    card = card_line()
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    ref = Path(tempfile.mkdtemp(prefix="fleet_repeat_")) / "REF.json"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, __file__, "--make-ref", str(ref)],
                   check=True, cwd=HERE, timeout=600)
    print(f"fleet_repeat: reference built in {time.perf_counter() - t0:.1f}"
          f" s [{card}]", flush=True)
    runs = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-X", "faulthandler",
                               str(HERE / "chip_smoke.py"), "--fleet",
                               str(ref)], cwd=HERE, capture_output=True,
                              text=True, timeout=900)
        wall = time.perf_counter() - t0
        log = out_dir / f"fleet_repeat_{i}.log"
        log.write_text(proc.stdout + "\n--- stderr\n" + proc.stderr)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("fleet: ") and ("capture" in ln
                                                  or "failed" in ln)]
        err = [ln for ln in proc.stderr.splitlines()
               if ln.startswith("AssertionError")]
        runs.append({"run": i, "rc": proc.returncode, "seconds": wall,
                     "capture": lines, "error": err[-1:]})
        print(f"fleet_repeat: run {i}: exit {proc.returncode} in {wall:.1f}"
              f" s [{card}]", flush=True)
        for ln in lines + err[-1:]:
            print(f"fleet_repeat:   {ln[:1500]}", flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
