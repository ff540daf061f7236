"""The port's self-healing fleet (``incubator_mxnet_tpu_torch/serving/
supervisor.py`` and ``mxtpu-supervise-torch``) on the CPU.

* The pure policy surface against the JAX package's, in-process, on the
  cases of ``tests/test_supervisor.py``: ``scale_decision`` (the decision
  table), ``FlapBreaker`` (the flap table) and the federated-signal
  extractors.
* The stub-replica tests of ``tests/test_supervisor.py``, on the port's
  ``Supervisor`` and ``Router``: real subprocesses (a stdlib fake that
  answers ``/readyz``/``/healthz``) gated on ``/readyz``, restarted after
  SIGKILL on the same port, quarantined when they flap, scaled up and
  down through the router's drain, and joined to and removed from a
  router over ``POST``/``DELETE /admin/replicas``.
* ``mxtpu-supervise-torch --replicas 2 --no-autoscale -- --gen-model
  g=cfg.json --device cpu`` end to end, as a user runs it: the router
  becomes ready over two ``gpt_tiny`` replicas, a ``:generate`` through
  it equals the same engine's tokens, a SIGKILLed replica is restarted
  and serves again, SIGTERM exits 0 and stops every replica.
* ``--compile-cache`` is refused by name."""
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from incubator_mxnet_tpu_torch import fault, telemetry
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.serving import (AutoscalePolicy, FlapBreaker,
                                               Router, ScaleSignals,
                                               Supervisor, scale_decision)
from incubator_mxnet_tpu_torch.serving import supervisor as sup_mod

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_state(tmp_path, monkeypatch):
    # quarantines dump the flight recorder, ejections write incidents
    monkeypatch.setenv("MXNET_FLIGHT_DUMP_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("MXNET_ROUTER_INCIDENT_DIR",
                       str(tmp_path / "incidents"))
    fault.clear_plan()
    telemetry.reset()
    yield
    fault.clear_plan()
    telemetry.reset()


# ------------------------------------------------ policy against JAX's
_POLICY = dict(min_replicas=1, max_replicas=4, burn_up=1.0, burn_down=0.25,
               queue_up=8.0, queue_down=1.0, kv_up=0.85,
               cooldown_seconds=30.0)

# (case, signals) from tests/test_supervisor.py's decision table, plus the
# boundaries between its bands
_SIGNALS = [
    ("below_min_beats_cooldown",
     dict(replicas=0, now=1.0, last_scale_time=0.0)),
    ("cooldown_blocks_up", dict(replicas=2, burn_rate=5.0,
                                queue_depth=100.0, now=10.0,
                                last_scale_time=0.0)),
    ("cooldown_blocks_down", dict(replicas=3, now=29.0,
                                  last_scale_time=0.0)),
    ("cooldown_expiry_boundary", dict(replicas=2, burn_rate=5.0, now=30.0,
                                      last_scale_time=0.0)),
    ("burn_up", dict(replicas=2, burn_rate=1.0, now=100.0)),
    ("burn_beats_queue", dict(replicas=2, burn_rate=2.0,
                              queue_depth=1000.0, now=100.0)),
    ("queue_up_is_per_replica", dict(replicas=2, queue_depth=16.0,
                                     now=100.0)),
    ("queue_below_per_replica_threshold", dict(replicas=4,
                                               queue_depth=16.0,
                                               now=100.0)),
    ("queue_beats_kv", dict(replicas=2, queue_depth=16.0,
                            kv_utilization=0.99, now=100.0)),
    ("kv_up", dict(replicas=2, kv_utilization=0.85, now=100.0)),
    ("at_max_holds", dict(replicas=4, burn_rate=9.0, queue_depth=1000.0,
                          kv_utilization=1.0, now=100.0)),
    ("down_when_all_calm", dict(replicas=3, burn_rate=0.25,
                                queue_depth=3.0, kv_utilization=0.5,
                                now=100.0)),
    ("burn_blocks_down", dict(replicas=3, burn_rate=0.26, now=100.0)),
    ("queue_blocks_down", dict(replicas=3, queue_depth=3.1, now=100.0)),
    ("min_blocks_down", dict(replicas=1, now=100.0)),
    ("dead_band_burn", dict(replicas=2, burn_rate=0.5, now=100.0)),
    ("dead_band_queue", dict(replicas=2, queue_depth=8.0, now=100.0)),
    ("one_step_up", dict(replicas=1, burn_rate=100.0, queue_depth=1e6,
                         now=100.0)),
    ("kv_just_below", dict(replicas=2, kv_utilization=0.8499, now=100.0)),
    ("queue_just_above_down", dict(replicas=2, queue_depth=2.0001,
                                   now=100.0)),
]


@pytest.mark.parametrize("case,sig", _SIGNALS,
                         ids=[row[0] for row in _SIGNALS])
def test_scale_decision_equals_jax(case, sig):
    from incubator_mxnet_tpu.serving import supervisor as jsup
    got = scale_decision(ScaleSignals(**sig), AutoscalePolicy(**_POLICY))
    want = jsup.scale_decision(jsup.ScaleSignals(**sig),
                               jsup.AutoscalePolicy(**_POLICY))
    assert (got.action, got.target, got.reason) == \
        (want.action, want.target, want.reason)
    assert ScaleSignals(**sig).snapshot() == \
        jsup.ScaleSignals(**sig).snapshot()


def test_policy_defaults_and_validation_equal_jax(monkeypatch):
    from incubator_mxnet_tpu.serving import supervisor as jsup
    monkeypatch.setenv("MXNET_AUTOSCALE_MAX_REPLICAS", "2")
    monkeypatch.setenv("MXNET_AUTOSCALE_BURN_UP", "0.5")
    assert AutoscalePolicy().snapshot() == jsup.AutoscalePolicy().snapshot()
    act = scale_decision(ScaleSignals(replicas=2, burn_rate=0.5, now=100.0))
    assert (act.action, act.reason) == ("hold", "at_max")
    for kw, match in ((dict(min_replicas=0), "min_replicas"),
                      (dict(min_replicas=3, max_replicas=2),
                       "max_replicas")):
        with pytest.raises(MXNetError, match=match):
            AutoscalePolicy(**kw)


# (case, (max_restarts, window), record times): tests/test_supervisor.py's
# flap table
_FLAP = [
    ("budget_blown_on_excess", (2, 10.0), [0.0, 1.0, 2.0]),
    ("window_prunes_old_events", (2, 10.0), [0.0, 1.0, 20.0, 21.0, 22.0]),
    ("single_restart_budget", (1, 60.0), [0.0, 5.0]),
    ("slow_flap_never_trips", (2, 5.0), [0.0, 10.0, 20.0, 30.0]),
    ("zero_budget", (0, 10.0), [0.0, 1.0]),
]


@pytest.mark.parametrize("case,cfg,times", _FLAP,
                         ids=[row[0] for row in _FLAP])
def test_flap_breaker_equals_jax(case, cfg, times):
    from incubator_mxnet_tpu.serving import supervisor as jsup
    ours = FlapBreaker(max_restarts=cfg[0], window_seconds=cfg[1])
    ref = jsup.FlapBreaker(max_restarts=cfg[0], window_seconds=cfg[1])
    got = [(ours.record(t), ours.count(t + 0.5)) for t in times]
    assert got == [(ref.record(t), ref.count(t + 0.5)) for t in times]


def test_signal_extractors_equal_jax():
    from incubator_mxnet_tpu.serving import supervisor as jsup
    state = {"gauges": {
        "mxtpu_serve_queue_depth": {"values": {
            "model=gen": 7.0, "replica=127.0.0.1:1": 4.0,
            "replica=127.0.0.1:2": 3.0}},
        "mxtpu_kv_blocks_in_use": {"values": {
            "replica=a:1": 9.0, "replica=b:2": 2.0, "model=gen": 11.0}},
        "mxtpu_kv_blocks_total": {"values": {
            "replica=a:1": 10.0, "replica=b:2": 10.0, "replica=c:3": 0.0,
            "model=gen": 20.0}}}}
    slo = {"models": {"gen": {"burn_rate": 0.4}, "clf": {"burn_rate": 1.2},
                      "weird": "not-a-dict"}}
    for ours, ref, args in (
            (sup_mod._fleet_gauge_sum, jsup._fleet_gauge_sum,
             [(state, "mxtpu_serve_queue_depth"), (state, "missing"),
              ({}, "x")]),
            (sup_mod._kv_utilization, jsup._kv_utilization,
             [(state,), ({},)]),
            (sup_mod._fleet_burn, jsup._fleet_burn,
             [(slo,), ({},), ({"models": {}},)])):
        for a in args:
            assert ours(*a) == ref(*a)
    assert sup_mod._fleet_gauge_sum(state, "mxtpu_serve_queue_depth") == 7.0
    assert sup_mod._kv_utilization(state) == pytest.approx(0.9)


# ----------------------------------------------- supervised fake fleet
# a stdlib replica: /readyz + /healthz like a server, no torch import
_FAKE = r"""
import http.server, json, sys
class H(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        body = json.dumps({}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self.do_GET()
    def log_message(self, *a):
        pass
http.server.ThreadingHTTPServer(("127.0.0.1", int(sys.argv[1])),
                                H).serve_forever()
"""
_FAKE_CMD = [sys.executable, "-c", _FAKE, "{port}"]


def _mk_sup(**kw):
    kw.setdefault("replicas", 1)
    kw.setdefault("autoscale", False)
    kw.setdefault("interval_seconds", 0.05)
    kw.setdefault("ready_timeout", 30)
    kw.setdefault("backoff_base", 0.05)
    kw.setdefault("backoff_max", 0.2)
    return Supervisor(_FAKE_CMD, **kw)


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for "
                         f"{what() if callable(what) else what}")


def test_supervisor_refuses_bad_configs():
    with pytest.raises(MXNetError, match="port"):
        Supervisor([sys.executable, "-c", "pass"])
    with pytest.raises(MXNetError, match="max_replicas"):
        _mk_sup(replicas=5, policy=AutoscalePolicy(max_replicas=4))


def test_supervisor_health_gates_and_restarts():
    """Spawn -> /readyz gate -> router registration; SIGKILL -> restart on
    the same port (stable membership), counted as a restart."""
    sup = _mk_sup(max_restarts=5, restart_window_seconds=60)
    try:
        sup.start()
        slot = sup.slots()[0]
        assert slot.state == sup_mod.RUNNING
        router = sup.router
        assert router.replica(slot.id).id == slot.id
        old_pid = slot.pid
        os.kill(slot.pid, signal.SIGKILL)
        _wait(lambda: slot.restarts == 1 and slot.state == sup_mod.RUNNING,
              30, "restart after SIGKILL")
        assert slot.pid != old_pid
        assert slot.id == f"{slot.host}:{slot.port}"
        assert router.replica(slot.id).id == slot.id
        snap = sup.state()
        assert snap["slots"][0]["restarts"] == 1 and snap["alive"] == 1
        text = router.render_fleet_metrics()
        assert f'mxtpu_supervise_restarts{{replica="{slot.id}"}} 1' in text
    finally:
        sup.stop()
    assert not sup.slots()[0].alive()


def test_supervisor_quarantines_flapping_slot():
    sup = _mk_sup(max_restarts=1, restart_window_seconds=60)
    try:
        sup.start()
        slot = sup.slots()[0]
        for kill in range(2):
            _wait(lambda k=kill: slot.restarts == k
                  and slot.state == sup_mod.RUNNING, 30,
                  f"slot RUNNING before kill {kill + 1}")
            os.kill(slot.pid, signal.SIGKILL)
        _wait(lambda: slot.state == sup_mod.QUARANTINED, 30, "quarantine")
        with pytest.raises(KeyError):
            sup.router.replica(slot.id)
        assert sup.active_count() == 0
        time.sleep(0.3)
        assert slot.state == sup_mod.QUARANTINED and not slot.alive()
    finally:
        sup.stop()


def test_supervisor_executes_scale_actions_with_drain():
    events = []
    sub = telemetry.FAULT.subscribe(
        lambda *a, **kw: events.append(kw), passive=True)
    sup = _mk_sup(policy=AutoscalePolicy(min_replicas=1, max_replicas=4,
                                         cooldown_seconds=0.0))

    def force(**sig):
        sig.setdefault("replicas", sup.active_count())
        sig.setdefault("now", time.monotonic())
        sup.collect_signals = lambda: ScaleSignals(**sig)
        return sup.autoscale_once()

    try:
        sup.start()
        act = force(burn_rate=5.0)
        assert (act.action, act.reason) == ("up", "burn")
        assert sup.active_count() == 2
        _wait(lambda: sup.alive_count() == 2, 30, "scale-up member ready")
        second = sup.slots()[1]
        assert sup.router.replica(second.id).id == second.id
        act = force(replicas=2)
        assert act.action == "down"
        _wait(lambda: sup.alive_count() == 1, 30, "scale-down executed")
        assert second.state == sup_mod.STOPPED and not second.alive()
        with pytest.raises(KeyError):
            sup.router.replica(second.id)
        assert any(e.get("site") == "router.admin"
                   and e.get("event") == "drain"
                   and e.get("kind") == "begin"
                   and e.get("replica") == second.id for e in events), \
            "scale-down did not route through the router drain"
        act = force(replicas=1)
        assert (act.action, act.reason) == ("hold", "steady")
    finally:
        telemetry.FAULT.unsubscribe(sub)
        sup.stop()


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def _request(port, method, path, body=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read() or b"{}"))
    conn.close()
    return out


def test_admin_replicas_join_and_leave_http():
    procs, ids = [], []
    for _ in range(2):
        port = _free_port()
        procs.append(subprocess.Popen([sys.executable, "-c", _FAKE,
                                       str(port)]))
        ids.append(f"127.0.0.1:{port}")
    router = None
    try:
        for rid in ids:
            _wait(lambda r=rid: _ping(r), 30, f"fake member {rid}")
        router = Router([ids[0]], port=0, host="127.0.0.1",
                        health_interval=0.05).start()
        status, out = _request(router.port, "POST", "/admin/replicas",
                               {"replica": ids[1]})
        assert status == 200 and out["added"] is True
        assert {r["id"] for r in _get_json(router.port, "/replicas")[
            "replicas"]} == set(ids)
        status, out = _request(router.port, "POST", "/admin/replicas",
                               {"replica": ids[1]})
        assert status == 200 and out["added"] is False
        assert _request(router.port, "POST", "/admin/replicas",
                        {"nope": 1})[0] == 400
        status, out = _request(router.port, "DELETE",
                               f"/admin/replicas/{ids[1]}?wait_seconds=5")
        assert status == 200 and out["removed"] is True
        assert out["replica"] == ids[1]
        assert [r["id"] for r in _get_json(router.port, "/replicas")[
            "replicas"]] == [ids[0]]
        assert _request(router.port, "DELETE",
                        "/admin/replicas/127.0.0.1:1")[0] == 404
        by = telemetry.registry.counter(
            "mxtpu_router_membership_changes").sample()["by"]
        assert by.get("action=join", 0) >= 1
        assert by.get("action=leave", 0) >= 1
    finally:
        if router is not None:
            router.stop()
        for p in procs:
            p.kill()
            p.wait()


def _ping(rid):
    try:
        with urllib.request.urlopen(f"http://{rid}/readyz", timeout=2) as r:
            return r.status == 200
    except OSError:
        return False


# ----------------------------------------- mxtpu-supervise-torch itself
TINY = {"vocab_size": 512, "units": 64, "hidden_size": 128,
        "num_layers": 2, "num_heads": 2, "max_length": 128,
        "max_slots": 2, "max_len": 64}


def _env(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env["PYTHONPATH"] = str(ROOT)
    # one intra-op thread per replica: on a host busy with other work, a
    # CPU replica's default thread pool (one per core) is oversubscribed:
    # an 8-token generate took 7 s instead of 0.04 s beside 6 busy torch
    # processes (tools/torch_replica_latency.py), and past the router's
    # 10 s upstream timeout on both replicas on a busier host
    env["OMP_NUM_THREADS"] = "1"
    env["MXNET_FLIGHT_DUMP_DIR"] = str(tmp_path / "flight")
    env["MXNET_ROUTER_INCIDENT_DIR"] = str(tmp_path / "incidents")
    env["MXNET_SUPERVISE_INTERVAL_SECONDS"] = "0.1"
    env["MXNET_SUPERVISE_BACKOFF_SECONDS"] = "0.1"
    env["MXNET_ROUTER_HEALTH_INTERVAL_SECONDS"] = "0.1"
    return env


def _supervise(*args):
    return [sys.executable, "-c",
            "from incubator_mxnet_tpu_torch._cli import supervise_main; "
            "supervise_main()", *args]


def test_supervise_cli_serves_restarts_and_drains(tmp_path):
    cfg = tmp_path / "g.json"
    cfg.write_text(json.dumps(TINY))
    logs = tmp_path / "logs"
    proc = subprocess.Popen(
        _supervise("--replicas", "2", "--no-autoscale", "--router-port",
                   "0", "--log-dir", str(logs), "--", "--gen-model",
                   f"g={cfg}", "--device", "cpu"),
        env=_env(tmp_path), cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stderr),
                              daemon=True)
    reader.start()

    def replica_pids():
        pids = {}
        for log in logs.glob("replica-*.log"):
            found = re.findall(r"\(pid (\d+);",
                               log.read_text(errors="replace"))
            if found:
                pids[log.name] = int(found[-1])
        return pids

    def tail(what=""):
        """``what``, then the supervisor's stderr and every replica's
        log, for a failure's message."""
        return what + "\n" + "".join(lines)[-3000:] + "".join(
            f"\n--- {log.name}\n{log.read_text(errors='replace')[-2000:]}"
            for log in sorted(logs.glob("replica-*.log")))

    def restarts():
        """{replica: restarts} over the replicas restarted at least once,
        from the router's ``/metrics``."""
        text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=10).read().decode()
        found = re.findall(r'mxtpu_supervise_restarts\{replica="([^"]+)"\} '
                           r'(\S+)', text)
        return {rep: float(n) for rep, n in found if float(n)}
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            m = re.search(r"router on http://0\.0\.0\.0:(\d+)",
                          "".join(lines))
            port = int(m.group(1)) if m else None
            assert proc.poll() is None, tail()
            time.sleep(0.05)
        assert port, tail()
        _wait(lambda: _eligible(port) == 2, 120,
              lambda: tail("two eligible replicas"))
        from incubator_mxnet_tpu_torch._cli import _load_generation_engine
        eng, _ = _load_generation_engine("g", str(cfg), "cpu")
        prompt = [3, 7, 11, 2, 9]
        want = eng.generate(prompt, max_new_tokens=8)
        status, body = _request(port, "POST", "/v1/models/g:generate",
                                {"tokens": prompt, "max_new_tokens": 8})
        assert status == 200 and body["tokens"] == want, tail(str(body))

        pids = replica_pids()
        assert len(pids) == 2, tail(str(pids))
        victim_log, victim = sorted(pids.items())[0]
        replica = "127.0.0.1:" + victim_log[len("replica-"):-len(".log")]
        assert restarts() == {}, tail()
        os.kill(victim, signal.SIGKILL)
        _wait(lambda: replica_pids().get(victim_log, victim) != victim,
              120, lambda: tail("the killed replica restarted"))
        _wait(lambda: _eligible(port) == 2, 120,
              lambda: tail("the restarted replica eligible again"))
        assert restarts() == {replica: 1.0}, tail(replica)
        for i in range(4):
            status, body = _request(port, "POST", "/v1/models/g:generate",
                                    {"tokens": prompt, "max_new_tokens": 8})
            assert status == 200 and body["tokens"] == want, \
                tail(str(body))
        alive = list(replica_pids().values())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, tail()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=30)     # the last lines may still be in the pipe
    assert "drained, exiting" in "".join(lines), tail()
    for pid in alive:
        _wait(lambda p=pid: not _pid_alive(p), 10, f"replica {pid} gone")


def _eligible(port):
    """The router's eligible-replica count (``/readyz`` answers 503 with
    the same body while none is)."""
    try:
        return _request(port, "GET", "/readyz", timeout=5)[1].get("eligible")
    except OSError:
        return None


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:       # a zombie of a dead child is not alive
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def test_supervise_cli_refuses_compile_cache(tmp_path):
    out = subprocess.run(
        _supervise("--compile-cache", str(tmp_path), "--", "--gen-model",
                   "g=cfg.json"), env=_env(tmp_path), cwd=ROOT,
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 2
    assert "--compile-cache is refused" in out.stderr
    assert "no XLA compile cache" in out.stderr
