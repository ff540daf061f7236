"""The port's ``DynamicBatcher`` on the CPU: the one-shot batcher
contracts that ``tests/test_serving.py``, ``tests/test_lifecycle.py`` and
``tests/test_request_trace.py`` pin on the JAX package, held on the port —
coalescing, the delay window, the batch cap, backpressure, drain and
close, the ``serving.infer`` retries and the per-request fallback, the
``serving.queue`` site, the counters; the breaker tripped by fallbacks,
the three deadline stages, the watchdog (hung and dead workers, its
sweeping thread, its flight dump), the join timeout of ``close``, drain
under load; the ``serve.batch`` span under the head rider's
``serve.request`` with every rider in its ``links``, and a shed request's
id on the FAULT stream.

The engines are the reference tests' own: a two-layer ReLU MLP (16 wide,
fp32) through ``InferenceEngine.from_block``, and ``_double`` (the input
times two) through the constructor, all on ``ctx="cpu"``.  Outputs are
held to the block's own forward at rtol 1e-5, atol 1e-6, the reference
tests' tolerance (the same fp32 ops in both).  Waits are condition polls
with timeouts of 10 s or more; hygiene: ``torch_serving_hygiene``."""
import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import fault, telemetry, telemetry_ring
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.serving import (CircuitBreaker,
                                               DynamicBatcher,
                                               InferenceEngine,
                                               QueueFullError, Watchdog,
                                               lifecycle)
from incubator_mxnet_tpu_torch.serving import metrics as smetrics
from torch_serving_hygiene import (clean_state, closer,  # noqa: F401
                                   module_hygiene)

TOL = dict(rtol=1e-5, atol=1e-6)
WAIT = 10.0


def _mlp(units=16, in_units=16, layers=2, seed=7):
    with mx.cpu():
        net = nn.HybridSequential()
        for _ in range(layers):
            net.add(nn.Dense(units, in_units=in_units, activation="relu"))
            in_units = units
    net.initialize(init=mx.init.Normal(0.3), seed=seed)
    return net


def _block_engine(net=None, **kw):
    net = net or _mlp()
    kw.setdefault("max_batch_size", 8)
    return net, InferenceEngine.from_block(net, [(16,)], ctx="cpu", **kw)


def _double(in_vals, param_vals, aux_vals, key):
    return [in_vals[0] * 2]


def _engine(dim=4, dtype=np.float32, buckets=(1, 2, 4), name="m"):
    return InferenceEngine(_double, ("data",), lambda: ((), ()),
                           input_specs=[((dim,), dtype)], buckets=buckets,
                           name=name, ctx="cpu")


def _x(n, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)


def _ref(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy()


def _wait_for(pred, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.005)
    return pred()


def _gated(eng, gate):
    """Make ``eng.predict`` wait for ``gate`` (at most ``WAIT`` s)."""
    orig = eng.predict
    eng.predict = lambda arrays: (gate.wait(WAIT), orig(arrays))[1]


def _threads(target, n):
    ts = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)


# --------------------------------------------------------------- batcher
def test_batcher_coalesces_concurrent_requests(closer):
    net, eng = _block_engine(max_batch_size=16)
    batcher = closer(DynamicBatcher(eng, max_batch_size=16, max_delay_ms=25,
                                    name="coalesce"))
    req0, bat0 = smetrics.REQUESTS.value, smetrics.BATCHES.value
    results, n_clients, per = {}, 8, 3

    def client(i):
        xi = _x(1, seed=i)
        outs = [np.asarray(batcher.submit([xi], timeout=WAIT)[0])
                for _ in range(per)]
        results[i] = (xi, outs)
    _threads(client, n_clients)
    batcher.close()
    n_req = smetrics.REQUESTS.value - req0
    n_bat = smetrics.BATCHES.value - bat0
    assert n_req == n_clients * per
    assert n_bat < n_req / 2, f"{n_bat} batches for {n_req} requests"
    for xi, outs in results.values():
        for out in outs:
            np.testing.assert_allclose(out, _ref(net, xi), **TOL)


def test_batcher_deadline_dispatches_lone_request(closer):
    _, eng = _block_engine()
    batcher = closer(DynamicBatcher(eng, max_delay_ms=30.0,
                                    name="deadline"))
    eng.warmup()
    lat0 = smetrics.LATENCY.count
    batcher.submit([_x(1)], timeout=WAIT)
    t0 = time.monotonic()
    batcher.submit([_x(1)], timeout=WAIT)
    elapsed = time.monotonic() - t0
    batcher.close()
    # a lone request waits out the 30 ms window, then goes
    assert 0.03 <= elapsed < 5.0
    assert smetrics.LATENCY.count - lat0 >= 2


def test_batcher_respects_max_batch_size(closer):
    _, eng = _block_engine(max_batch_size=8)
    batcher = closer(DynamicBatcher(eng, max_batch_size=8, max_delay_ms=50,
                                    name="cap"))
    bat0 = smetrics.BATCHES.value
    _threads(lambda i: batcher.submit([_x(5, seed=i)], timeout=WAIT), 2)
    batcher.close()
    # 5 + 5 rows > 8: the second request cannot ride along
    assert smetrics.BATCHES.value - bat0 == 2


def test_batcher_backpressure_rejects_when_full(closer):
    _, eng = _block_engine()
    batcher = closer(DynamicBatcher(eng, max_delay_ms=1, queue_size=2,
                                    name="backpressure"))
    gate = threading.Event()
    _gated(eng, gate)
    rej0 = smetrics.REJECTED.value
    try:
        held = [batcher.submit_async([_x(1)])]   # the worker takes it
        assert _wait_for(lambda: batcher._busy_since is not None)
        held += [batcher.submit_async([_x(1)]) for _ in range(2)]
        with pytest.raises(QueueFullError) as e:
            batcher.submit_async([_x(1)])
        assert e.value.retry_after == 1.0
        assert smetrics.REJECTED.value - rej0 == 1
    finally:
        gate.set()
    for r in held:                       # accepted work still completes
        assert r.result(WAIT) is not None


def test_batcher_graceful_drain_on_close(closer):
    _, eng = _block_engine()
    batcher = closer(DynamicBatcher(eng, max_delay_ms=20000, name="drain"))
    reqs = [batcher.submit_async([_x(1, seed=i)]) for i in range(5)]
    t0 = time.monotonic()
    batcher.close(drain=True)            # must not wait out the 20 s window
    assert time.monotonic() - t0 < WAIT
    for r in reqs:
        assert r.result(WAIT) is not None
    assert batcher.closed


def test_batcher_submit_after_close_raises(closer):
    _, eng = _block_engine()
    batcher = closer(DynamicBatcher(eng, name="closed"))
    batcher.close()
    with pytest.raises(MXNetError):
        batcher.submit([_x(1)])


def test_batcher_close_without_drain_fails_pending(closer):
    _, eng = _block_engine()
    batcher = closer(DynamicBatcher(eng, max_delay_ms=500, name="nodrain"))
    gate = threading.Event()
    _gated(eng, gate)
    first = batcher.submit_async([_x(1)])
    assert _wait_for(lambda: batcher._busy_since is not None)
    pending = batcher.submit_async([_x(1)])
    gate.set()
    batcher.close(drain=False)
    with pytest.raises(MXNetError):
        pending.result(WAIT)
    assert first.result(WAIT) is not None    # in-flight work lands


# -------------------------------------------------------- fault injection
def test_fault_retry_recovers_batch(closer):
    telemetry.start()
    net, eng = _block_engine()
    fault.install_plan("serving.infer:ioerror@1")
    batcher = closer(DynamicBatcher(
        eng, max_delay_ms=1, name="retry",
        retry_policy=fault.RetryPolicy(max_retries=3, base_seconds=0.001)))
    x = _x(2)
    out = np.asarray(batcher.submit([x], timeout=WAIT)[0])
    batcher.close()
    np.testing.assert_allclose(out, _ref(net, x), **TOL)
    flat = telemetry.counters_flat()
    assert flat.get("mxtpu_retries", 0) > 0
    assert flat.get("mxtpu_serve_fallbacks", 0) == 0


def test_fault_fallback_to_single_requests(closer):
    """The batch dispatch keeps failing past the retry budget: the
    batcher falls back and serves every rider on its own."""
    telemetry.start()
    net, eng = _block_engine(max_batch_size=16)
    fault.install_plan("serving.infer:ioerror@1-50")
    batcher = closer(DynamicBatcher(
        eng, max_batch_size=16, max_delay_ms=25, name="fallback",
        retry_policy=fault.RetryPolicy(max_retries=1, base_seconds=0.001)))
    fb0 = smetrics.FALLBACKS.value
    results = {}

    def client(i):
        xi = _x(1, seed=i)
        results[i] = (xi, np.asarray(batcher.submit([xi], timeout=30)[0]))
    _threads(client, 4)
    batcher.close()
    assert smetrics.FALLBACKS.value - fb0 >= 1
    assert len(results) == 4
    for xi, out in results.values():
        np.testing.assert_allclose(out, _ref(net, xi), **TOL)
    assert telemetry.counters_flat().get("mxtpu_giveups", 0) > 0


def test_fault_on_queue_site_propagates_to_caller(closer):
    _, eng = _block_engine()
    fault.install_plan("serving.queue:ioerror@1")
    batcher = closer(DynamicBatcher(eng, name="qfault"))
    with pytest.raises(fault.FaultInjected):
        batcher.submit([_x(1)])
    assert batcher.submit([_x(1)], timeout=WAIT) is not None   # fired once


def test_request_counters_consistent(closer):
    _, eng = _block_engine()
    batcher = closer(DynamicBatcher(eng, max_delay_ms=1, name="counters"))
    req0, bat0 = smetrics.REQUESTS.value, smetrics.BATCHES.value
    size0 = smetrics.BATCH_SIZE.count
    for i in range(3):
        batcher.submit([_x(1, seed=i)], timeout=WAIT)
    batcher.close()
    assert smetrics.REQUESTS.value - req0 == 3
    assert 1 <= smetrics.BATCHES.value - bat0 <= 3
    assert smetrics.BATCH_SIZE.count - size0 >= 1


def test_mixed_signatures_never_coalesce(closer):
    """FIFO order is kept past an incompatible head: requests of another
    per-example shape go in their own batch."""
    eng = _engine(dim=4, buckets=(1, 2, 4, 8))
    batcher = closer(DynamicBatcher(eng, max_delay_ms=25, name="sigs"))
    gate = threading.Event()
    _gated(eng, gate)
    bat0 = smetrics.BATCHES.value
    first = batcher.submit_async([_x(1, d=4)])
    assert _wait_for(lambda: batcher._busy_since is not None)
    reqs = [batcher.submit_async([_x(1, d=4, seed=1)]),
            batcher.submit_async([_x(1, d=3, seed=2)]),
            batcher.submit_async([_x(1, d=4, seed=3)])]
    gate.set()
    for r, d, s in zip([first] + reqs, (4, 4, 3, 4), (0, 1, 2, 3)):
        np.testing.assert_array_equal(np.asarray(r.result(WAIT)[0]),
                                      2 * _x(1, d=d, seed=s))
    assert smetrics.BATCHES.value - bat0 == 4


# ------------------------------------------------------- circuit breaker
def test_breaker_trips_via_batcher_fallbacks(closer):
    """Consecutive fallbacks trip the breaker; once the fault clears, the
    half-open probe closes it again without a restart."""
    eng = _engine(name="trippy")
    fault.install_plan("serving.infer:ioerror@1-999")
    batcher = closer(DynamicBatcher(
        eng, max_delay_ms=1, name="trippy",
        retry_policy=fault.RetryPolicy(max_retries=0, base_seconds=0.001),
        breaker=CircuitBreaker("trippy", threshold=2,
                               cooldown_seconds=0.15)))
    for i in range(2):                   # fallbacks answer the clients
        assert batcher.submit([_x(1, d=4, seed=i)], timeout=WAIT) \
            is not None
    assert batcher.breaker.state == lifecycle.OPEN
    assert batcher.state == lifecycle.UNHEALTHY
    with pytest.raises(lifecycle.BreakerOpen):
        batcher.submit([_x(1, d=4)])
    fault.clear_plan()                   # the model recovers
    t_open = time.monotonic()
    assert _wait_for(lambda: time.monotonic() - t_open > 0.2)
    assert batcher.submit([_x(1, d=4)], timeout=WAIT) is not None
    assert batcher.breaker.state == lifecycle.CLOSED
    assert batcher.state == lifecycle.SERVING


# ------------------------------------------------------------- deadlines
def test_deadline_wait_stage(closer):
    eng = _engine()
    gate = threading.Event()            # never set: the dispatch is slow
    _gated(eng, gate)
    batcher = closer(DynamicBatcher(eng, max_delay_ms=1, name="slow"))
    with pytest.raises(lifecycle.DeadlineExceeded):
        batcher.submit([_x(1, d=4)], timeout_ms=120)
    gate.set()
    assert telemetry.counters_flat().get(
        "mxtpu_serve_deadline_exceeded", 0) >= 1


def _queue_sheds():
    s = smetrics.DEADLINE_EXCEEDED.sample()
    return s["by"].get("model=shed,stage=queue", 0) \
        if isinstance(s, dict) else 0


def test_deadline_queue_stage_sheds_expired(closer):
    """A request that expires while queued behind a stuck dispatch is
    shed by the gather loop (stage=queue), never dispatched."""
    eng = _engine()
    gate = threading.Event()
    _gated(eng, gate)
    batcher = closer(DynamicBatcher(eng, max_delay_ms=1, name="shed"))
    q0 = _queue_sheds()
    first = batcher.submit_async([_x(1, d=4)])     # occupies the worker
    assert _wait_for(lambda: batcher._busy_since is not None)
    doomed = batcher.submit_async([_x(1, d=4)], timeout_ms=80)
    assert _wait_for(lambda: time.monotonic() > doomed.deadline + 0.02)
    gate.set()
    assert first.result(WAIT) is not None
    assert _wait_for(doomed.event.is_set)
    with pytest.raises(lifecycle.DeadlineExceeded):
        doomed.result(0)
    assert _queue_sheds() - q0 == 1


def test_deadline_admission_stage_rejects_up_front(closer):
    """When the queue-wait estimate already busts the budget, admission
    rejects at once: the request never queues."""
    eng = _engine()
    gate = threading.Event()
    _gated(eng, gate)
    batcher = closer(DynamicBatcher(eng, max_delay_ms=1, name="admit"))
    try:
        batcher.submit_async([_x(1, d=4)])          # the worker is busy
        assert _wait_for(lambda: batcher._busy_since is not None)
        with batcher._cv:                           # evidence of a
            batcher._avg_batch_seconds = 50.0       # slow model
        with pytest.raises(lifecycle.DeadlineExceeded):
            batcher.submit_async([_x(1, d=4)], timeout_ms=100)
        assert batcher.pending == 1                 # never queued
    finally:
        gate.set()


def test_no_deadline_by_default_keeps_blocking_semantics(closer):
    batcher = closer(DynamicBatcher(_engine(), max_delay_ms=1, name="nodl"))
    assert batcher.default_timeout_ms == 0.0
    req = batcher.submit_async([_x(1, d=4)])
    assert req.deadline is None
    assert req.result(WAIT) is not None


def test_default_deadline_from_env(closer, monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_TIMEOUT_MS", "250")
    monkeypatch.setenv("MXNET_SERVE_MAX_DELAY_MS", "7")
    monkeypatch.setenv("MXNET_SERVE_QUEUE", "3")
    batcher = closer(DynamicBatcher(_engine(), name="envdl"))
    assert batcher.default_timeout_ms == 250.0
    assert batcher.max_delay == pytest.approx(0.007)
    assert batcher.queue_size == 3
    assert batcher.max_batch_size == 4          # capped by the buckets
    req = batcher.submit_async([_x(1, d=4)])
    assert req.deadline is not None
    assert req.result(WAIT) is not None


# -------------------------------------------------------------- watchdog
def test_watchdog_restarts_hung_worker_and_recovers(closer):
    """A wedged dispatch is detected, its riders fail with
    RequestAborted, the worker restarts on a fresh generation and the
    breaker trips; after the cooldown the model serves again."""
    eng = _engine(name="hangy")
    fault.install_plan("serving.infer:hang:2@1")
    batcher = closer(DynamicBatcher(
        eng, max_delay_ms=1, name="hangy",
        breaker=CircuitBreaker("hangy", threshold=5, cooldown_seconds=0.2)))
    victim = batcher.submit_async([_x(1, d=4)])
    assert _wait_for(lambda: batcher._busy_since is not None)
    busy = batcher._busy_since
    assert _wait_for(lambda: time.monotonic() - busy > 0.25)
    assert batcher.check_worker(hang_seconds=0.2) == "hung"
    with pytest.raises(lifecycle.RequestAborted):
        victim.result(WAIT)
    assert batcher.restarts == 1
    assert batcher.breaker.state == lifecycle.OPEN
    assert batcher.state == lifecycle.UNHEALTHY
    with pytest.raises(lifecycle.BreakerOpen):
        batcher.submit([_x(1, d=4)])
    t_trip = time.monotonic()
    assert _wait_for(lambda: time.monotonic() - t_trip > 0.25)
    assert batcher.submit([_x(1, d=4)], timeout=WAIT) is not None
    assert batcher.state == lifecycle.SERVING
    assert batcher.restarts == 1


def test_watchdog_thread_sweeps(closer):
    eng = _engine(name="swept")
    fault.install_plan("serving.infer:hang:2@1")
    batcher = closer(DynamicBatcher(eng, max_delay_ms=1, name="swept"))
    dog = Watchdog(hang_seconds=0.15, interval=0.05)
    dog.watch(batcher)
    dog.start()
    try:
        batcher.submit_async([_x(1, d=4)])
        assert _wait_for(lambda: batcher.restarts >= 1)
    finally:
        dog.stop()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_detects_dead_worker(closer):
    eng = _engine(name="deady")
    batcher = closer(DynamicBatcher(eng, max_delay_ms=1, name="deady"))
    # SystemExit is not an Exception: it escapes the worker's guard and
    # the thread dies
    eng.predict = lambda arrays: (_ for _ in ()).throw(SystemExit)
    batcher.submit_async([_x(1, d=4)])
    assert _wait_for(lambda: not batcher._thread.is_alive())
    assert batcher.state == lifecycle.UNHEALTHY
    assert batcher.check_worker(hang_seconds=0) == "died"
    assert batcher.restarts == 1
    assert batcher._thread.is_alive()


# ------------------------------------------------------------------ drain
def test_close_join_timeout_fails_stranded_requests(closer):
    """The drain budget blows on a wedged dispatch: every pending request
    gets a clear error instead of blocking forever."""
    eng = _engine(name="wedge")
    gate = threading.Event()
    _gated(eng, gate)
    batcher = closer(DynamicBatcher(eng, max_delay_ms=1, name="wedge"))
    try:
        stuck = batcher.submit_async([_x(1, d=4)])
        assert _wait_for(lambda: batcher._busy_since is not None)
        queued = batcher.submit_async([_x(1, d=4)])
        batcher.close(drain=True, timeout=0.3)
        for r in (stuck, queued):
            with pytest.raises(lifecycle.RequestAborted):
                r.result(WAIT)
    finally:
        gate.set()


def test_drain_under_load_every_request_resolves(closer):
    """Clients hammering the batcher race close(drain=True): every submit
    returns a result or raises cleanly; nobody blocks."""
    batcher = closer(DynamicBatcher(_engine(name="race"), max_delay_ms=2,
                                    name="race"))
    outcomes, lock = [], threading.Lock()
    started = threading.Event()

    def client(i):
        for j in range(20):
            started.set()
            try:
                ok = batcher.submit([_x(1, d=4, seed=i * 100 + j)],
                                    timeout=WAIT) is not None
            except MXNetError:
                ok = True                # a clean rejection resolves it
            except Exception:
                ok = False
            with lock:
                outcomes.append(ok)

    ts = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    assert started.wait(WAIT)
    batcher.close(drain=True)
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert outcomes and all(outcomes)


# ---------------------------------------------------------------- tracing
def test_request_span_adopts_batch_span_across_worker(closer):
    """The worker's ``serve.batch`` span nests under the submitting
    request's ``serve.request`` span and carries the rider's id."""
    telemetry.start()
    batcher = closer(DynamicBatcher(_engine(), max_delay_ms=1,
                                    name="trace"))
    batcher.submit([_x(2, d=4)], request_id="rid-head", timeout=WAIT)
    batcher.close(timeout=5)
    spans = telemetry.tracer.find_spans("request_id", "rid-head")
    assert len(spans) == 1
    root = spans[0]
    assert root["name"] == "serve.request"
    assert root["attrs"]["model"] == "trace"
    batch = [c for c in root.get("children", ())
             if c["name"] == "serve.batch"]
    assert batch, "serve.batch did not nest under serve.request"
    assert "rid-head" in batch[0]["attrs"]["links"]


def test_batch_span_links_every_rider(closer):
    """Concurrent riders coalesce; each keeps its own ``serve.request``
    root and every id appears in some batch span's ``links``."""
    telemetry.start()
    batcher = closer(DynamicBatcher(_engine(), max_delay_ms=25,
                                    name="riders"))
    rids = [f"rider-{i}" for i in range(4)]
    _threads(lambda i: batcher.submit([_x(1, d=4, seed=i)],
                                      request_id=rids[i], timeout=WAIT), 4)
    batcher.close(timeout=5)
    for rid in rids:
        found = telemetry.tracer.find_spans("request_id", rid)
        assert found and found[0]["name"] == "serve.request"
    linked = set()

    def walk(nodes):
        for node in nodes:
            if node["name"] == "serve.batch":
                linked.update(node["attrs"]["links"])
            walk(node.get("children", ()))

    tree = telemetry.tracer.tree(max_finished=256)
    walk(tree["finished"] + tree["live"])
    assert linked >= set(rids)


def test_shed_request_id_stamped_on_fault_events(closer):
    """A request shed by its deadline (never dispatched) still leaves its
    id on the FAULT stream."""
    telemetry.start()
    events = []

    def on_fault(**kw):
        events.append(kw)

    telemetry.FAULT.subscribe(on_fault, passive=True)
    fault.install_plan("serving.infer:hang:0.8@1")
    batcher = closer(DynamicBatcher(_engine(), max_delay_ms=1, name="shed"))
    try:
        hung = threading.Thread(
            target=lambda: batcher.submit([_x(1, d=4)], request_id="hang-0",
                                          timeout=WAIT))
        hung.start()
        assert _wait_for(lambda: batcher._busy_since is not None)
        with pytest.raises(lifecycle.DeadlineExceeded):
            batcher.submit([_x(1, d=4, seed=1)], timeout_ms=100,
                           request_id="shed-1")
        hung.join(timeout=WAIT)
        assert not hung.is_alive()
    finally:
        telemetry.FAULT.unsubscribe(on_fault)
    shed = [e for e in events if e.get("request_id") == "shed-1"
            and e.get("event") == "deadline"]
    assert shed and shed[0]["kind"] in ("wait", "queue", "admission")


def test_watchdog_restart_dump_names_hung_request_ids(closer, tmp_path,
                                                      monkeypatch):
    """A hung worker's watchdog abort dumps a flight recording whose ring
    names the rider's request id."""
    import json
    monkeypatch.setenv("MXNET_FLIGHT_DUMP_DIR", str(tmp_path))
    rec = telemetry_ring.FlightRecorder(size=64)
    rec.start()
    fault.install_plan("serving.infer:hang:2@1")
    batcher = closer(DynamicBatcher(
        _engine(name="hangdump"), max_delay_ms=1, name="hangdump",
        breaker=CircuitBreaker("hangdump", threshold=5,
                               cooldown_seconds=0.2)))
    try:
        victim = batcher.submit_async([_x(1, d=4)], request_id="hung-1")
        assert _wait_for(lambda: batcher._busy_since is not None)
        busy = batcher._busy_since
        assert _wait_for(lambda: time.monotonic() - busy > 0.25)
        assert batcher.check_worker(hang_seconds=0.2) == "hung"
        with pytest.raises(lifecycle.RequestAborted):
            victim.result(WAIT)
        dumps = _wait_for(lambda: list(
            tmp_path.glob("flight_*_watchdog_restart.json")))
        assert dumps, "no watchdog flight dump appeared"
        data = json.loads(dumps[0].read_text())
        assert data["reason"] == "watchdog_restart"
        hung = [e for e in data["ring"] if e["type"] == "fault"
                and e.get("event") == "watchdog"]
        assert hung and "hung-1" in hung[0]["request_ids"]
    finally:
        rec.stop()


def test_stats_and_active_request_ids(closer):
    eng = _engine(name="st")
    gate = threading.Event()
    _gated(eng, gate)
    batcher = closer(DynamicBatcher(eng, max_delay_ms=1, name="st"))
    try:
        a = batcher.submit_async([_x(1, d=4)], request_id="a")
        assert _wait_for(lambda: batcher._busy_since is not None)
        b = batcher.submit_async([_x(1, d=4)], request_id="b")
        assert batcher.active_request_ids() == {"queued": ["b"],
                                                "inflight": ["a"]}
        assert batcher.pending == 2 and not batcher.idle
        st = batcher.stats()
        assert set(st) == {"model", "queue_depth", "queue_size",
                           "max_batch_size", "max_delay_ms",
                           "default_timeout_ms", "closed", "state",
                           "breaker", "watchdog_restarts", "buckets",
                           "compiled_programs"}
        assert st["queue_depth"] == 1 and st["buckets"] == [1, 2, 4]
    finally:
        gate.set()
    for r in (a, b):
        assert r.result(WAIT) is not None
    assert _wait_for(lambda: batcher.idle)
