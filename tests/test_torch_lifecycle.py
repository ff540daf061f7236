"""The port's serving lifecycle on the CPU: the continuous batcher's
join/leave machinery (a mid-flight join equal to its solo run, a queued
request admitted when a slot frees, cancel and deadline freeing a slot
mid-decode, a watchdog restart failing the riders with their ids and
then serving the next request correctly) — the counterparts of
``tests/test_generation.py``'s batcher tests — and the fault domains at
the HTTP front: a full queue answers 429 with ``Retry-After``,
``/admin/drain`` turns ``/readyz`` to 503 while an in-flight stream
finishes, repeated injected ``serving.infer`` errors open the breaker,
and the fault-plan parser equals the JAX package's."""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from incubator_mxnet_tpu_torch import fault, telemetry
from incubator_mxnet_tpu_torch import initializer as tinit
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models.gpt import GPTModel
from incubator_mxnet_tpu_torch.serving import (BreakerOpen, Cancelled,
                                               ContinuousBatcher,
                                               DeadlineExceeded,
                                               GenerationEngine, ModelServer,
                                               RequestAborted)
from incubator_mxnet_tpu_torch.serving import metrics as smetrics
from incubator_mxnet_tpu_torch.serving import slo as _slo


@pytest.fixture(autouse=True)
def _clean_state():
    fault.clear_plan()
    telemetry.reset()
    _slo.tracker.reset()
    yield
    fault.clear_plan()
    telemetry.reset()
    _slo.tracker.reset()


@pytest.fixture(scope="module")
def net():
    """``tests/test_generation.py``'s model shape, port weights."""
    n = GPTModel(vocab_size=50, units=32, hidden_size=64, num_layers=2,
                 num_heads=2, max_length=128, dropout=0.0, device="cpu")
    return tinit.initialize(n, tinit.Normal(0.6), 3)


def _engine(net, max_slots=2, max_len=128):
    return GenerationEngine(net, name="g", max_slots=max_slots,
                            max_len=max_len)


def _wait(cond, seconds=10.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


# ------------------------------------------------------- batcher: joins
def test_mid_flight_join_identical_to_solo(net):
    eng = _engine(net)
    solo_long = eng.generate([9, 9, 4, 1], max_new_tokens=100)
    solo_short = eng.generate([3, 7, 11], max_new_tokens=5)
    eng.reset()
    batcher = ContinuousBatcher(eng, name="g")
    try:
        req_a = batcher.submit_async([9, 9, 4, 1], max_new_tokens=100)
        assert _wait(lambda: req_a.tokens_out)
        req_b = batcher.submit_async([3, 7, 11], max_new_tokens=5)
        got_b = req_b.result(timeout=30)
        got_a = req_a.result(timeout=30)
        assert got_a == solo_long
        assert got_b == solo_short
        assert batcher.slots_in_use() == 0
        st = batcher.stats()
        assert st["kind"] == "generation" and st["decode_steps"] > 0
        assert st["tokens_emitted"] == len(got_a) + len(got_b)
    finally:
        batcher.close()


def test_queued_request_admitted_when_slot_frees(net):
    eng = _engine(net, max_slots=1, max_len=64)
    refs = [eng.generate(p, max_new_tokens=10)
            for p in ([5, 2], [9, 9, 4, 1])]
    eng.reset()
    batcher = ContinuousBatcher(eng, name="g")
    try:
        reqs = [batcher.submit_async(p, max_new_tokens=10)
                for p in ([5, 2], [9, 9, 4, 1])]
        assert [r.result(timeout=30) for r in reqs] == refs
    finally:
        batcher.close()


# --------------------------------------------- slot free: cancel/deadline
def test_cancel_frees_slot_mid_decode(net):
    batcher = ContinuousBatcher(_engine(net), name="g")
    cancelled0 = smetrics.CANCELLED.value
    try:
        req = batcher.submit_async([3, 7, 11], max_new_tokens=100)
        got = []
        for tok in req.stream(timeout=30):
            got.append(tok)
            if len(got) == 3:
                break               # closing the generator cancels
        assert _wait(lambda: batcher.slots_in_use() == 0, 5)
        assert req.done and isinstance(req.error, Cancelled)
        assert smetrics.CANCELLED.value == cancelled0 + 1
    finally:
        batcher.close()


def test_deadline_mid_decode_frees_slot_with_decode_stage(net):
    batcher = ContinuousBatcher(_engine(net), name="g")
    # 2 ms per dispatch: 120 tokens cannot fit in the 60 ms budget
    fault.install_plan("serving.infer:latency:0.002@every=1")
    try:
        req = batcher.submit_async([3, 7, 11], max_new_tokens=120,
                                   timeout_ms=60)
        with pytest.raises(DeadlineExceeded):
            req.result(timeout=30)
        assert 0 < len(req.tokens_out) < 120      # died mid-decode
        assert _wait(lambda: batcher.slots_in_use() == 0, 5)
        after = smetrics.DEADLINE_EXCEEDED.sample()
        assert after["by"].get("model=g,stage=decode") == 1.0
    finally:
        batcher.close()


# ----------------------------------------------------- watchdog restart
def test_watchdog_restart_mid_decode_fails_riders_then_serves(net,
                                                              monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_BREAKER_COOLDOWN_SECONDS", "0")
    eng = _engine(net)
    solo = eng.generate([5, 1, 2], max_new_tokens=20)
    eng.reset()
    batcher = ContinuousBatcher(eng, name="g")
    try:
        # wedge the 5th dispatch (outside the engine's lock) for 3 s
        fault.install_plan("serving.infer:hang:3@5")
        req = batcher.submit_async([3, 7, 11], max_new_tokens=100,
                                   request_id="rider-1")
        assert _wait(lambda: fault.site_calls("serving.infer") >= 5)
        time.sleep(0.1)
        assert batcher.check_worker(hang_seconds=0.05) == "hung"
        with pytest.raises(RequestAborted) as ei:
            req.result(timeout=30)
        assert "rider-1" in str(ei.value)
        assert batcher.restarts == 1
        assert _wait(lambda: batcher.slots_in_use() == 0, 5)
        assert batcher.active_request_ids() == {"queued": [],
                                                "inflight": []}
        # the breaker tripped; with no cooldown the next request is its
        # probe, served by the new worker on a reset cache
        assert batcher.submit([5, 1, 2], max_new_tokens=20,
                              timeout=30) == solo
        assert batcher.breaker.state == "CLOSED"
        assert batcher.stats()["watchdog_restarts"] == 1
    finally:
        fault.clear_plan()
        batcher.close()


# ------------------------------------------------------ the HTTP front
def _post(port, body, rid="r", path="/v1/models/g:generate"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", "x-request-id": rid})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


@pytest.fixture
def server(net, tmp_path, monkeypatch):
    # a started server holds the flight recorder: incident dumps land here
    monkeypatch.setenv("MXNET_FLIGHT_DUMP_DIR", str(tmp_path / "flight"))
    srv = ModelServer(port=0, host="127.0.0.1", queue_size=1)
    srv.add_model("g", _engine(net, max_slots=1), warmup=True)
    srv.start()
    yield srv
    fault.clear_plan()
    srv.stop(drain=False)


def test_queue_full_answers_429_with_retry_after(server):
    fault.install_plan("serving.infer:latency:0.05@every=1")
    bat = server.get_model("g")
    first = bat.submit_async([3, 7, 11], max_new_tokens=100)
    assert _wait(lambda: first.tokens_out)
    queued = bat.submit_async([4, 4], max_new_tokens=5)     # the 1 queued
    code, headers, text = _post(server.port, {"tokens": [1, 2],
                                              "max_new_tokens": 4},
                                rid="over")
    assert code == 429
    assert int(headers["Retry-After"]) >= 1
    body = json.loads(text)
    assert body["request_id"] == "over" and body["retry_after"] >= 1.0
    assert headers["X-Request-Id"] == "over"
    first.cancel()
    assert len(queued.result(timeout=30)) == 5


def test_drain_turns_readyz_503_while_streams_finish(server):
    assert _get(server.port, "/readyz")[0] == 200
    fault.install_plan("serving.infer:latency:0.02@every=1")
    got = {}

    def stream():
        got["answer"] = _post(server.port, {"tokens": [3, 7, 11],
                                            "max_new_tokens": 60,
                                            "stream": True}, rid="s1")
    t = threading.Thread(target=stream)
    t.start()
    assert _wait(lambda: server.inflight_http == 1)
    code, _, body = _post(server.port, {}, path="/admin/drain")
    assert code == 200 and json.loads(body) == {"draining": True,
                                                "inflight": 1}
    code, headers, body = _get(server.port, "/readyz")
    assert code == 503 and body["status"] == "draining"
    assert headers["Retry-After"] == "1"
    code, headers, body = _post(server.port, {"tokens": [1],
                                              "max_new_tokens": 2})
    assert code == 503 and "Retry-After" in headers
    t.join(timeout=60)
    assert not t.is_alive()
    code, headers, text = got["answer"]
    assert code == 200 and headers["X-Request-Id"] == "s1"
    events = [ln[len("event: "):] for ln in text.splitlines()
              if ln.startswith("event: ")]
    assert events == ["token"] * 60 + ["done"]
    assert _post(server.port, {}, path="/admin/undrain")[0] == 200
    assert _get(server.port, "/readyz")[0] == 200


def test_injected_infer_errors_open_the_breaker(server, monkeypatch):
    monkeypatch.setenv("MXNET_RETRY_MAX", "0")
    bat = server.get_model("g")
    bat.breaker.threshold = 2
    bat.breaker.cooldown_seconds = 60.0
    fault.install_plan("serving.infer:ioerror@every=1")
    for i in range(2):
        code, _, text = _post(server.port, {"tokens": [3, 7],
                                            "max_new_tokens": 5},
                              rid=f"f{i}")
        assert code == 500, text        # the dispatch failed
    assert bat.breaker.state == "OPEN" and bat.state == "UNHEALTHY"
    with pytest.raises(BreakerOpen):
        bat.submit_async([1, 2], max_new_tokens=3)
    code, headers, text = _post(server.port, {"tokens": [1, 2],
                                              "max_new_tokens": 3},
                                rid="shed")
    assert code == 503 and int(headers["Retry-After"]) >= 1
    assert json.loads(text)["request_id"] == "shed"
    code, _, body = _get(server.port, "/readyz")
    assert code == 503 and body["blockers"] == ["g"]
    assert body["models"] == {"g": "UNHEALTHY"}


def test_verbs_the_port_does_not_serve_answer_400(server):
    for verb in ("predict", "load"):
        code, _, text = _post(server.port, {"inputs": [[1.0]]},
                              path=f"/v1/models/g:{verb}")
        assert code == 400 and "Queue A item 9" in json.loads(text)["error"]
    assert _post(server.port, {}, path="/debug/profile")[0] == 404
    with pytest.raises(MXNetError):
        server.add_model("x", object())


# ------------------------------------------------- health and OOM planes
def test_nonfinite_logits_raise_a_serving_anomaly(net, monkeypatch):
    """With the health plane on, a NaN in the logits becomes a
    ``nonfinite_generation`` anomaly naming the request."""
    import copy
    import torch
    from incubator_mxnet_tpu_torch import health
    health.reset()
    monkeypatch.setenv("MXNET_HEALTH_PLANE", "1")
    bad = copy.deepcopy(net)
    with torch.no_grad():
        bad.ln_f.gamma.fill_(float("nan"))
    batcher = ContinuousBatcher(_engine(bad), name="nan")
    try:
        batcher.submit([3, 7, 11], max_new_tokens=6, request_id="nan-1",
                       timeout=30)
        st = batcher.stats()
        assert st["nonfinite_generations"] >= 1
        assert st["decode_health"]["finite"] is False
        rep = health.report()
        assert rep["status"] == "anomalous"
        assert rep["last_anomaly"]["request_ids"] == ["nan-1"]
        assert rep["last_anomaly"]["kind"] == "nonfinite_generation"
    finally:
        batcher.close()
        health.reset()


def test_an_oom_dispatch_is_reported_with_its_riders(net, monkeypatch):
    import torch
    from incubator_mxnet_tpu_torch import telemetry_device as tdev
    assert tdev.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not tdev.is_oom(ValueError("no"))
    monkeypatch.setenv("MXNET_RETRY_MAX", "0")
    seen = []

    def listen(**kw):
        seen.append(kw)
    telemetry.FAULT.subscribe(listen)
    batcher = ContinuousBatcher(_engine(net), name="oom")
    fault.install_plan("serving.infer:ioerror:RESOURCE_EXHAUSTED here@1")
    try:
        req = batcher.submit_async([3, 7, 11], max_new_tokens=5,
                                   request_id="oom-1")
        with pytest.raises(OSError):
            req.result(timeout=30)
        ooms = [e for e in seen if e.get("event") == "oom"]
        assert ooms and ooms[0]["request_ids"] == ["oom-1"]
        assert telemetry.registry.get("mxtpu_oom_failures").sample()[
            "by"] == {"site=serving.infer": 1.0}
        # the engine was reset: the next request is served
        assert len(batcher.submit([5, 1], max_new_tokens=4,
                                  timeout=30)) == 4
    finally:
        telemetry.FAULT.unsubscribe(listen)
        fault.clear_plan()
        batcher.close()


# ------------------------------------------------------- fault plans
PLANS = ["serving.infer:ioerror@2",
         "serving.infer:hang:30@5;serving.queue:latency:0.05@1-3",
         "kvstore.push:ioerror:boom@every=3", "a:crash", "a:crash:7@2",
         "x.y:latency", " s:nonfinite@4 ; ", "s:hang"]
BAD_PLANS = ["nokind", ":ioerror", "s:explode", "s:latency:abc",
             "s:ioerror@x", "s:ioerror@every=0", "s:crash:z"]


@pytest.mark.parametrize("spec", PLANS)
def test_parse_plan_equals_jax(spec):
    from incubator_mxnet_tpu import fault as jfault
    got, want = fault._parse_plan(spec), jfault._parse_plan(spec)
    assert repr(got) == repr(want)
    for site, rules in want.rules.items():
        for n in range(1, 8):
            assert [r.kind for r in got.rules[site] if r.fires(n)] \
                == [r.kind for r in rules if r.fires(n)]


@pytest.mark.parametrize("spec", BAD_PLANS)
def test_parse_plan_rejects_what_jax_rejects(spec):
    from incubator_mxnet_tpu import fault as jfault
    from incubator_mxnet_tpu.base import MXNetError as JaxError
    with pytest.raises(JaxError):
        jfault._parse_plan(spec)
    with pytest.raises(MXNetError):
        fault._parse_plan(spec)


# ---------------------------------------------------- on the card (cuda)
def _need_cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs run only on the card")


def _card_engine(name="g"):
    from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
    n = gpt_tiny(dropout=0.0, device="cuda")
    tinit.initialize(n, tinit.Normal(0.02), 0)
    return GenerationEngine(n, name=name, max_slots=4, max_len=128)


@pytest.mark.cuda
def test_async_warmup_beside_scrapes_then_graphs_equal_eager():
    """The capture runs on the server's warmup thread while HTTP threads
    answer /metrics, /memory and /readyz in a loop; then the graphs'
    tokens equal the eager bodies' bit for bit, and the model serves."""
    _need_cuda()
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import graph_vs_eager
    eng = _card_engine()
    srv = ModelServer(port=0, host="127.0.0.1")
    srv.add_model("g", eng, warmup=True, async_warmup=True)
    srv.start()
    try:
        scrapes, states = 0, set()
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            code, _, _ = _get(srv.port, "/readyz")
            states.add(code)
            if code == 200:
                break
            for path in ("/metrics", "/memory"):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}{path}",
                        timeout=30) as r:
                    assert r.status == 200
                scrapes += 1
        assert 200 in states and scrapes > 0
        inv = _get(srv.port, "/programs")[2]["engines"]["g"]
        assert inv["compiled_programs"] == inv["expected_programs"]
        mem = _get(srv.port, "/memory")[2]
        assert mem["owners"]["kv:g"] > 0 and mem["owners"]["params:g"] > 0
        prompts = [[int(t) for t in np.random.RandomState(s).randint(
            0, 512, ln)] for s, ln in enumerate((5, 40, 17, 90))]
        same, graph_counts, eager_counts = graph_vs_eager(eng, prompts, 16)
        assert same and graph_counts == eager_counts
        code, _, text = _post(srv.port, {"tokens": [3, 7, 11],
                                         "max_new_tokens": 8})
        assert code == 200 and json.loads(text)["count"] == 8
    finally:
        srv.stop(drain=False)


@pytest.mark.cuda
def test_watchdog_restart_mid_burst_then_correct_request(monkeypatch):
    """A worker wedged between two bursts of a stream is replaced; the
    new worker's reset waits for the engine's lock, and the next request
    equals its solo run."""
    _need_cuda()
    monkeypatch.setenv("MXNET_SERVE_BREAKER_COOLDOWN_SECONDS", "0")
    eng = _card_engine()
    eng.warmup()
    solo = eng.generate([5, 1, 2], max_new_tokens=40)
    batcher = ContinuousBatcher(eng, name="g")
    try:
        fault.install_plan("serving.infer:hang:3@3")
        req = batcher.submit_async([3, 7, 11], max_new_tokens=100,
                                   request_id="rider-2")
        assert _wait(lambda: fault.site_calls("serving.infer") >= 3, 60)
        time.sleep(0.1)
        assert len(req.tokens_out) > 1              # bursts ran first
        assert batcher.stats()["decode_burst_dispatches"] >= 1
        assert batcher.check_worker(hang_seconds=0.05) == "hung"
        with pytest.raises(RequestAborted):
            req.result(timeout=60)
        assert batcher.submit([5, 1, 2], max_new_tokens=40,
                              timeout=120) == solo
    finally:
        fault.clear_plan()
        batcher.close()
