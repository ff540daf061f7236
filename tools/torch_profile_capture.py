#!/usr/bin/env python3
"""Profiling a live serving process on one NVIDIA GPU: does it crash or
hang, and what does the trace see?

Run from the repository root on a machine with one CUDA card::

    python3 tools/torch_profile_capture.py [--captures 4] [--seconds 0.5]
                                            [--modes raw,port,...]

Each mode runs in its own child process (so a crash or a hang ends only
the child: a child still running after ``--watchdog`` seconds prints
every thread's Python stack and exits), over ``gpt2_124m`` at full width
(random ``Normal(0.02)`` weights from seed 0, the default paged engine,
its programs captured as CUDA graphs):

* ``raw``: a ``ContinuousBatcher`` whose worker thread replays the graphs
  while 8 client threads submit the smoke's prompts over and over; the
  main thread takes ``--captures`` profiles of ``--seconds`` with
  ``torch.profiler.profile(activities=[CPU, CUDA])`` as a caller would
  write it;
* ``port``: the same with ``telemetry_device.capture_profile``, which
  stops the profiler holding the dispatch gate (its start is ungated);
* ``http``: a ``ModelServer`` serving the engine to 8 SSE clients (one
  handler thread per request, threads that come and go during each
  window), profiled through ``POST /debug/profile``;
* ``after-exit``: the batcher serves, is closed (its threads exit), then
  the main thread profiles engine calls with ``torch.profiler`` (the
  order of the serving windows measured in PR 8's single process);
* ``gate-stop``: as ``raw``, but the profiler's stop holds the dispatch
  gate exclusive (its start does not);
* ``gate-enable``: as ``gate-stop``, and the profiler is prepared
  (``prepare_trace``) outside the gate and enabled (``start_trace``)
  holding it.

A mode may be named more than once (``--modes raw,raw,port``): each is
a fresh child.  For each it prints the child's exit code (and the tail
of its stderr when it failed), and for each capture: the kernel events in
the trace, those of the paged-decode kernel (K2), the ``cudaGraphLaunch``
runtime events, whether a kernel event carries a CUDA graph id, and
which threads' host operators appear (by thread name); how long the
profiler's start and stop took and held the gate; and the longest
interval with no engine dispatch completed inside the capture (from its
request to its trace on disk) against the same in the second before it
(every mode but ``after-exit``: the child times every dispatch by
wrapping the engine's ``_run``).  Every line carries the
card's name and power limit."""
import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MODES = ("raw", "port", "http", "after-exit", "gate-stop", "gate-enable")


def child(mode, captures, seconds, out_dir):
    import numpy as np
    import torch
    from chip_smoke import (build_served, http_json, longest_quiet,
                            served_requests, sse_client, trace_summary)
    from incubator_mxnet_tpu_torch import telemetry_device as td
    from incubator_mxnet_tpu_torch.serving import (ContinuousBatcher,
                                                   ModelServer)
    net, eng = build_served()
    done, run = [], eng._run

    def timed_run(*a, **kw):
        out = run(*a, **kw)
        done.append(time.perf_counter())
        return out
    eng._run = timed_run

    prompts, budgets = served_requests(net._vocab_size)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    stop, served, srv, bat = threading.Event(), [], None, None
    if mode == "http":
        os.environ["MXNET_PROFILE_DIR"] = out_dir
        srv = ModelServer(port=0, host="127.0.0.1")
        srv.add_model("plain", eng)
        srv.start()
        base = f"http://127.0.0.1:{srv.port}"

        def client(i):
            while not stop.is_set():
                r = {}
                sse_client(base, "plain", prompts[i], budgets[i], r)
                served.append(len(r["tokens"]))
    else:
        bat = ContinuousBatcher(eng)

        def client(i):
            while not stop.is_set():
                served.append(len(bat.submit(prompts[i],
                                             max_new_tokens=budgets[i])))
    clients = [threading.Thread(target=client, args=(i,), name=f"client{i}")
               for i in range(len(prompts))]
    for t in clients:
        t.start()
    time.sleep(1.0)
    if mode == "after-exit":
        stop.set()
        for t in clients:
            t.join(timeout=120)
        bat.close()
        S = eng.max_slots
        last = np.array([eng.prefill(p, s, reserve_tokens=len(p) + 64)
                         for s, p in enumerate(prompts)], np.int32)
        pos = np.array([len(p) for p in prompts], np.int32)
    out = []
    for k in range(captures):
        if k:
            time.sleep(1.0)     # the second before: the clients alone
        t0 = time.perf_counter()
        if mode in ("port", "http"):
            if mode == "port":
                path = td.capture_profile(seconds, out_dir=out_dir)
            else:
                code, _, body = http_json(
                    base, f"/debug/profile?seconds={seconds}", body={},
                    timeout=120)
                assert code == 200, (code, body)
                path = body["profile"]
            trace = os.path.join(path, "trace.json")
            with open(os.path.join(path, "capture.json")) as f:
                held = json.load(f)
        elif mode in ("gate-stop", "gate-enable"):
            prof = torch.profiler.profile(activities=acts)
            held = {}
            t1 = time.perf_counter()
            if mode == "gate-stop":
                prof.start()
            else:
                prof.prepare_trace()
                held["prepare_s"] = time.perf_counter() - t1
                td._gated(prof.start_trace, held, "start")
            held["start_s"] = time.perf_counter() - t1
            time.sleep(seconds)
            td._gated(prof.stop if mode == "gate-stop" else prof.stop_trace,
                      held, "stop")
            trace = os.path.join(out_dir, f"{mode}_{k}.json")
            prof.export_chrome_trace(trace)
        else:
            held = {}
            with torch.profiler.profile(activities=acts) as prof:
                if mode == "after-exit":
                    eng.decode_burst(last, pos, np.full(S, 8),
                                     np.full(S, -1), np.ones(S, bool))
                    torch.cuda.synchronize()
                else:
                    time.sleep(seconds)
            trace = os.path.join(out_dir, f"{mode}_{k}.json")
            prof.export_chrome_trace(trace)
        t_end = time.perf_counter()
        wall = t_end - t0
        names = {t.native_id: t.name for t in threading.enumerate()}
        row = trace_summary(trace, names)
        row["wall_s"] = wall
        row["held"] = held
        if mode != "after-exit":
            ts = sorted(done)
            row["idle_in_ms"] = longest_quiet(ts, t0, t_end)
            row["idle_before_ms"] = longest_quiet(ts, t0 - 1.0, t0)
        out.append(row)
        print(f"capture {k}: {json.dumps(row)}", flush=True)
    stop.set()
    for t in clients:
        t.join(timeout=120)
    if bat is not None:
        bat.close()
    if srv is not None:
        srv.stop()
    print(json.dumps({"mode": mode, "captures": out,
                      "requests_served": len(served)}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--captures", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--watchdog", type=float, default=240.0,
                    help="seconds before a child prints its threads' "
                         "stacks and exits")
    ap.add_argument("--child", choices=MODES, default=None)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    if args.child:
        import faulthandler
        faulthandler.dump_traceback_later(args.watchdog, exit=True)
        child(args.child, args.captures, args.seconds, args.out_dir)
        return
    import tempfile
    from chip_smoke import card_line
    card = card_line()
    env = dict(os.environ)
    for mode in args.modes.split(","):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-X", "faulthandler", __file__, "--child",
                 mode, "--captures", str(args.captures), "--seconds",
                 str(args.seconds), "--out-dir", tmp, "--watchdog",
                 str(args.watchdog)], env=env, cwd=ROOT,
                capture_output=True, text=True, timeout=args.watchdog + 60)
            print(f"capture: mode {mode}: exit code {proc.returncode} in "
                  f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
            for line in proc.stdout.splitlines():
                if line.startswith("capture "):
                    print(f"capture: mode {mode}: {line}", flush=True)
            if proc.returncode != 0:
                print(f"capture: mode {mode}: stderr tail:\n"
                      f"{proc.stderr[-3000:]}", flush=True)


if __name__ == "__main__":
    main()
