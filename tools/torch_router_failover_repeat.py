#!/usr/bin/env python3
"""``tests/test_torch_router.py``'s ``failover_keeps_request_id`` scenario
run many times in each package, outside the test suite: which of its
recorded fields vary from run to run, and in which package.

    python3 tools/torch_router_failover_repeat.py [--runs 40]
        [--health-interval 0.05]

Each package runs in its own child interpreter (``MXNET_*`` unset, JAX on
the CPU), as the test's children do, with the scenario's router, fake
replicas and requests taken from the test file.  Besides the fields the
test compares (``requests``, ``failed_over``, ``live_rids``) each run
records its count of failovers.  The parent prints, per package, every
distinct observation with its count, and the fields that varied.  A
health interval far below the scenario's own (a poll every millisecond)
widens the race between the health poll and ``route()`` that a busy host
opens at 50 ms."""
import argparse
import collections
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("incubator_mxnet_tpu", "incubator_mxnet_tpu_torch")


def observe(pkg, runs, interval):
    """``runs`` observations of the scenario in ``pkg``, each as JSON."""
    if pkg == "incubator_mxnet_tpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
    spec = importlib.util.spec_from_file_location(
        "router_scenarios", ROOT / "tests" / "test_torch_router.py")
    tr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tr)
    Router = importlib.import_module(pkg + ".serving").Router
    m = importlib.import_module(pkg + ".serving.metrics")
    seen = collections.Counter()
    for _ in range(runs):
        live = tr.FakeReplica().start()
        dead_id = f"127.0.0.1:{tr._dead_port()}"
        r = Router([dead_id, live.id], port=0, health_interval=interval,
                   retry_deadline=5.0, retries=3, affinity=False).start()
        try:
            dead = r.replica(dead_id)
            fo0 = m.ROUTER_FAILOVERS.value
            requests = []
            for _ in range(4):
                dead.ready = dead.reachable = True
                dead.breaker.record_success()
                status, body, hdrs = tr._predict(r.port,
                                                 {"x-request-id": "fo-1"})
                requests.append([status, body.get("ok"),
                                 body.get("request_id"),
                                 hdrs.get("x-request-id")])
            obs = {"requests": requests,
                   "failed_over": m.ROUTER_FAILOVERS.value > fo0,
                   "failovers": int(m.ROUTER_FAILOVERS.value - fo0),
                   "live_rids": sorted(set(live.predict_rids))}
        finally:
            r.stop()
            live.stop()
        seen[json.dumps(obs, sort_keys=True)] += 1
    return dict(seen)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=40)
    ap.add_argument("--health-interval", type=float, default=0.05)
    ap.add_argument("--child", choices=PKGS, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(observe(args.child, args.runs,
                                 args.health_interval)))
        return
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    procs = {pkg: subprocess.Popen(
        [sys.executable, __file__, "--child", pkg, "--runs", str(args.runs),
         "--health-interval", str(args.health_interval)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pkg in PKGS}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=3600)
        if proc.returncode:
            raise SystemExit(f"{pkg} exited {proc.returncode}:\n{err[-3000:]}")
        seen = json.loads(out.strip().splitlines()[-1])
        obs = [json.loads(k) for k in seen]
        varied = sorted(f for f in obs[0]
                        if len({json.dumps(o[f]) for o in obs}) > 1)
        print(f"{pkg}: {args.runs} runs at a health interval of "
              f"{args.health_interval} s; fields that varied: "
              f"{varied or 'none'}")
        for k, n in sorted(seen.items(), key=lambda kv: -kv[1]):
            print(f"  {n} x {k}")


if __name__ == "__main__":
    main()
