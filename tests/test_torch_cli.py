"""The port's console entry points as a user runs them, in subprocesses on
the CPU.

``mxtpu-serve-torch`` (``_cli:serve_main``): a ``gpt_tiny`` config is
served (``/readyz`` 200, one ``:generate``), SIGTERM drains it (exit 0,
"drained, exiting", the port closed); a config whose ``"params"`` file
is missing and a host without a card (without ``--device cpu``) exit
non-zero with the ``MXNetError`` that says why (a config's ``"params"``
file is served by ``tests/test_torch_gluon.py``).

``mxtpu-stats-torch`` (``_cli:stats_main``): script mode prints the
Prometheus dump (or JSON) after the script, exits with the script's
status, prints ``/slo`` and writes a flight dump when asked, and with
``--serve`` runs the live exporter the script can scrape; ``--fleet``
reads a CPU port server's ``/metrics``, ``--programs``, ``--memory``,
``--health`` and ``--profile``; fleet flags without ``--fleet`` exit 2,
an unreachable URL exits 1."""
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
        # a params file that is not there: no random weights in its place
        cfg = _config(tmp_path, params="gpt-0000.params")
        args, env = ("--device", "cpu"), _env()
        why = "gpt-0000.params does not exist"
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


# ------------------------------------------------------ mxtpu-stats-torch
def _stats(*args):
    return [sys.executable, "-c",
            "from incubator_mxnet_tpu_torch._cli import stats_main; "
            "stats_main()", *args]


_SCRIPT = r"""
import json, sys, urllib.request
from incubator_mxnet_tpu_torch import telemetry, telemetry_http
telemetry.counter("mxtpu_cli_probe", "a probe counter").inc(3, model="m")
with telemetry.trace_span("cli.probe"):
    pass
srv = telemetry_http.server()
if srv is not None:
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    text = urllib.request.urlopen(base + "/metrics", timeout=10).read()
    health = json.loads(urllib.request.urlopen(base + "/healthz",
                                               timeout=10).read())
    state = json.loads(urllib.request.urlopen(base + "/metrics.json",
                                              timeout=10).read())
    assert b'mxtpu_cli_probe{model="m"} 3' in text, text
    assert health["status"] == "ok" and health["collecting"], health
    assert state["counters"]["mxtpu_cli_probe"]["values"] == {"model=m": 3.0}
    print("SERVED", file=sys.stderr)
sys.exit(int(sys.argv[1]))
"""


@pytest.mark.parametrize("serve", [False, True])
def test_stats_runs_a_script_and_prints_the_dump(tmp_path, serve):
    script = tmp_path / "probe.py"
    script.write_text(_SCRIPT)
    flight = tmp_path / "flight.json"
    args = ["--slo", "--flight-dump", str(flight)]
    if serve:
        args += ["--serve", "--port", "0"]
    out = subprocess.run(_stats(*args, str(script), "3"), env=_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 3, out.stderr      # the script's own status
    assert '# TYPE mxtpu_cli_probe counter' in out.stdout
    assert 'mxtpu_cli_probe{model="m"} 3' in out.stdout
    slo = json.loads(out.stdout[out.stdout.index('{\n'):])
    assert set(slo) == {"objectives", "models"}
    assert json.loads(flight.read_text())["reason"] == "cli"
    assert ("SERVED" in out.stderr) == serve, out.stderr
    js = subprocess.run(_stats("--format", "json", str(script), "0"),
                        env=_env(), cwd=ROOT, capture_output=True,
                        text=True, timeout=120)
    assert js.returncode == 0
    snap = json.loads(js.stdout)
    assert snap["counters"]["mxtpu_cli_probe"]["total"] == 3


def test_stats_refuses_fleet_flags_without_fleet():
    out = subprocess.run(_stats("--health"), env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "need --fleet" in out.stderr
    out = subprocess.run(_stats(), env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "a script is required" in out.stderr


@pytest.fixture(scope="module")
def cpu_server():
    from incubator_mxnet_tpu_torch import initializer as tinit
    from incubator_mxnet_tpu_torch import telemetry
    from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
    from incubator_mxnet_tpu_torch.serving import (GenerationEngine,
                                                   ModelServer)
    net = gpt_tiny(dropout=0.0, device="cpu")
    net.initialize(tinit.Normal(0.02), seed=0)
    srv = ModelServer(port=0, host="127.0.0.1")
    srv.add_model("gpt", GenerationEngine(net, name="gpt", max_slots=2,
                                          max_len=32), warmup=True)
    srv.start()
    yield srv
    srv.stop()
    telemetry.reset()


@pytest.mark.parametrize("view", ["metrics", "slo", "programs", "memory",
                                  "health", "profile"])
def test_stats_fleet_reads_a_server(cpu_server, tmp_path, monkeypatch,
                                    view):
    # the capture runs in the server's process: this one
    monkeypatch.setenv("MXNET_PROFILE_DIR", str(tmp_path))
    args = ["--fleet", f"127.0.0.1:{cpu_server.port}"]
    if view == "profile":
        args += ["--profile", "0.1"]
    elif view != "metrics":
        args.append(f"--{view}")
    out = subprocess.run(_stats(*args), env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if view == "metrics":
        assert "# TYPE mxtpu_kernel_launches gauge" in out.stdout
        return
    body = json.loads(out.stdout)
    if view == "slo":
        assert set(body) == {"objectives", "models"}
    elif view == "programs":
        gpt = body["engines"]["gpt"]
        assert gpt["compiled_programs"] == gpt["expected_programs"]
    elif view == "memory":
        assert body["owners"]["kv:gpt"] > 0
        assert body["owners"]["params:gpt"] > 0
    elif view == "health":
        assert {"enabled", "status", "anomaly_total"} <= set(body)
    else:
        assert os.path.dirname(body["profile"]) == str(tmp_path)
        assert os.path.isfile(os.path.join(body["profile"], "trace.json"))


def test_stats_fleet_unreachable_exits_1():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out = subprocess.run(_stats("--fleet", f"127.0.0.1:{port}"),
                         env=_env(), cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 1 and "--fleet" in out.stderr
