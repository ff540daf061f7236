"""Time a CPU replica's requests on a busy host.

Starts ``mxtpu-serve-torch`` on the CPU with a tiny generation model
(the fleet CLI test's config), optionally beside ``--busy N`` processes
that keep torch's CPU matmuls running, waits for ``/readyz``, and times
``--requests`` 8-token ``:generate`` calls.  ``--threads K`` starts the
replica with ``OMP_NUM_THREADS=K`` (default: torch's own, one thread
per core)::

    python tools/torch_replica_latency.py --busy 6
    python tools/torch_replica_latency.py --busy 6 --threads 1

Prints one JSON line: the seconds to ready and of each request.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TINY = {"vocab_size": 512, "units": 64, "hidden_size": 128,
        "num_layers": 2, "num_heads": 2, "max_length": 128,
        "max_slots": 2, "max_len": 64}
BUSY = ("import time, torch\nx = torch.randn(512, 512)\n"
        "while True:\n    x = (x @ x).tanh()\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--busy", type=int, default=0)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--requests", type=int, default=4)
    args = ap.parse_args()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env["PYTHONPATH"] = str(ROOT)
    if args.threads is not None:
        env["OMP_NUM_THREADS"] = str(args.threads)
    procs = [subprocess.Popen([sys.executable, "-c", BUSY])
             for _ in range(args.busy)]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Path(tmp) / "g.json"
        cfg.write_text(json.dumps(TINY))
        t0 = time.perf_counter()
        rep = subprocess.Popen(
            [sys.executable, "-m", "incubator_mxnet_tpu_torch._cli",
             "--gen-model", f"g={cfg}", "--device", "cpu", "--port", "0"],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        procs.append(rep)
        lines = []
        threading.Thread(target=lambda: lines.extend(rep.stderr),
                         daemon=True).start()
        try:
            port = None
            while port is None and time.perf_counter() - t0 < 300:
                m = re.search(r"listening on http://[0-9.]+:(\d+)",
                              "".join(lines))
                port = int(m.group(1)) if m else None
                if rep.poll() is not None:
                    raise SystemExit("".join(lines))
                time.sleep(0.05)
            base = f"http://127.0.0.1:{port}"
            while True:
                try:
                    with urllib.request.urlopen(base + "/readyz",
                                                timeout=5) as r:
                        if r.status == 200:
                            break
                except OSError:
                    pass
                time.sleep(0.1)
            ready = time.perf_counter() - t0
            body = json.dumps({"tokens": [3, 7, 11, 2, 9],
                               "max_new_tokens": 8}).encode()
            secs = []
            for _ in range(args.requests):
                req = urllib.request.Request(
                    base + "/v1/models/g:generate", data=body,
                    headers={"Content-Type": "application/json"})
                t = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as r:
                    r.read()
                secs.append(time.perf_counter() - t)
        finally:
            for p in procs:
                p.kill()
                p.wait()
    print(json.dumps({"busy": args.busy, "threads": args.threads,
                      "cores": os.cpu_count(), "ready_s": ready,
                      "request_s": secs}))


if __name__ == "__main__":
    main()
