"""``mxtpu-serve-torch`` (``incubator_mxnet_tpu_torch._cli:serve_main``)
as a user runs it, in a subprocess on the CPU: a ``gpt_tiny`` config is
served (``/readyz`` 200, one ``:generate``), SIGTERM drains it (exit 0,
"drained, exiting", the port closed); a config with ``"params"`` and a
host without a card (without ``--device cpu``) exit non-zero with the
``MXNetError`` that says why."""
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TINY = {"vocab_size": 512, "units": 64, "hidden_size": 128,
        "num_layers": 2, "num_heads": 2, "max_length": 128,
        "max_slots": 2, "max_len": 32}


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def _cmd(*args):
    return [sys.executable, "-m", "incubator_mxnet_tpu_torch._cli", *args]


def _config(tmp_path, **extra):
    path = tmp_path / "gpt.json"
    path.write_text(json.dumps(dict(TINY, **extra)))
    return str(path)


def test_serve_generate_then_sigterm_drains(tmp_path):
    proc = subprocess.Popen(
        _cmd("--gen-model", f"gpt={_config(tmp_path)}", "--device", "cpu",
             "--port", "0", "--host", "127.0.0.1", "--warmup"),
        env=_env(MXNET_FLIGHT_DUMP_DIR=str(tmp_path / "flight")), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stderr),
                              daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 120
        port = None
        while port is None and time.monotonic() < deadline:
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)",
                          "".join(lines))
            port = int(m.group(1)) if m else None
            assert proc.poll() is None, "".join(lines)
            time.sleep(0.05)
        assert port, "".join(lines)
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/readyz", timeout=30) as r:
            assert r.status == 200
        req = urllib.request.Request(
            base + "/v1/models/gpt:generate",
            data=json.dumps({"tokens": [3, 7, 11],
                             "max_new_tokens": 6}).encode(),
            headers={"x-request-id": "cli-1"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert body["count"] == 6 and body["request_id"] == "cli-1"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    assert "drained, exiting" in "".join(lines)
    # the SIGTERM is an incident: the flight recorder dumped it
    assert list((tmp_path / "flight").glob("flight_*_sigterm_drain.json"))
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()


@pytest.mark.parametrize("case", ["params", "no_card"])
def test_refuses_to_serve_what_it_cannot(tmp_path, case):
    if case == "params":
        cfg = _config(tmp_path, params="gpt-0000.params")
        args, env = ("--device", "cpu"), _env()
        why = '"params" weights files cannot be read'
    else:
        # an empty CUDA_VISIBLE_DEVICES hides any card
        cfg = _config(tmp_path)
        args, env = (), _env(CUDA_VISIBLE_DEVICES="")
        why = "no CUDA device is available"
    out = subprocess.run(_cmd("--gen-model", f"gpt={cfg}", "--port", "0",
                              *args), env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "MXNetError" in out.stderr and why in out.stderr, out.stderr
