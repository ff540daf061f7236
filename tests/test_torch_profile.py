"""On-demand profile capture in the port (``telemetry_device.
capture_profile`` over ``torch.profiler``, and ``POST /debug/profile`` on
the port's ``ModelServer``).

On the CPU: a capture writes a Chrome trace into a fresh
``capture_<pid>_<seq>`` directory under ``out_dir`` or
``MXNET_PROFILE_DIR`` and counts itself; the window is clamped to [0.05,
60] s; one capture runs at a time (a second raises ``CaptureBusy``); the
route answers 200 with the artifact, 400 for a bad ``seconds``, 409 with
``Retry-After`` while a capture runs and 500 when the capture fails.  The
dispatch gate (``cuda_graphs.DispatchGate``) keeps every dispatch out
while the profiler stops and lets no new one in while that waits; a
capture's stop waits for a dispatch in flight, and ``capture.json``
notes how long the stop waited for the gate and held it.

On the card (``cuda``): captures taken while a ``ContinuousBatcher``
serves ``gpt_tiny`` from CUDA graphs on other threads do not crash the
process, each trace names the paged-decode kernel (K2) that the replayed
graphs launched inside the window, and the served tokens equal a run
without captures."""
import json
import os
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import telemetry
from incubator_mxnet_tpu_torch import telemetry_device as td


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset()
    yield
    telemetry.reset()


def _trace(path):
    with open(os.path.join(path, "trace.json")) as f:
        return json.load(f)


def test_capture_writes_a_chrome_trace(tmp_path, monkeypatch):
    n0 = td._c_captures.value
    path = td.capture_profile(0.05, out_dir=str(tmp_path / "a"))
    assert os.path.dirname(path) == str(tmp_path / "a")
    assert os.path.basename(path).startswith(f"capture_{os.getpid()}_")
    assert "traceEvents" in _trace(path)
    with open(os.path.join(path, "capture.json")) as f:
        held = json.load(f)
    assert held["window_s"] == 0.05
    assert held["start_s"] > 0 and held["export_s"] > 0
    assert held["stop"]["gate_wait_s"] >= 0
    assert held["stop"]["gate_held_s"] > 0
    monkeypatch.setenv("MXNET_PROFILE_DIR", str(tmp_path / "b"))
    assert td.default_profile_dir() == str(tmp_path / "b")
    second = td.capture_profile(0.05)
    assert os.path.dirname(second) == str(tmp_path / "b")
    assert second.rsplit("_", 1)[1] != path.rsplit("_", 1)[1]
    assert td._c_captures.value == n0 + 2
    assert not td.capture_active()


def test_capture_window_is_clamped(tmp_path, monkeypatch):
    slept = []
    monkeypatch.setattr(td, "time", types.SimpleNamespace(
        sleep=slept.append, perf_counter=td.time.perf_counter))
    for asked in (0.0, -3.0, 0.5, 1e6):
        td.capture_profile(asked, out_dir=str(tmp_path))
    assert slept == [td.CAPTURE_MIN_SECONDS, td.CAPTURE_MIN_SECONDS, 0.5,
                     td.CAPTURE_MAX_SECONDS]
    assert (td.CAPTURE_MIN_SECONDS, td.CAPTURE_MAX_SECONDS) == (0.05, 60.0)


def test_one_capture_at_a_time(tmp_path):
    started = threading.Event()
    real_sleep = td.time.sleep
    out = []

    def first():
        out.append(td.capture_profile(0.6, out_dir=str(tmp_path)))
    t = threading.Thread(target=first)
    t.start()
    try:
        while not td.capture_active():
            real_sleep(0.005)
        started.set()
        with pytest.raises(td.CaptureBusy):
            td.capture_profile(0.05, out_dir=str(tmp_path))
    finally:
        t.join(timeout=30)
    assert started.is_set() and not t.is_alive() and len(out) == 1
    assert not td.capture_active()


# ------------------------------------------------------- the dispatch gate
def test_gate_excludes_dispatches_while_the_profiler_starts_and_stops():
    from incubator_mxnet_tpu_torch.cuda_graphs import DispatchGate
    gate = DispatchGate()
    inside, log = threading.Event(), []
    release = threading.Event()

    def reader():
        with gate.shared():
            inside.set()
            release.wait(10)
            log.append("read")

    def writer():
        with gate.exclusive():
            log.append("write")
    r = threading.Thread(target=reader)
    r.start()
    assert inside.wait(10)
    w = threading.Thread(target=writer)
    w.start()
    w.join(0.2)
    assert w.is_alive() and log == []   # waits for the shared hold
    late = threading.Thread(target=lambda: gate.shared().__enter__()
                            or log.append("late"))
    late.start()
    late.join(0.2)
    assert late.is_alive()              # a waiting writer keeps it out
    release.set()
    for t in (r, w, late):
        t.join(10)
        assert not t.is_alive()
    assert log == ["read", "write", "late"]


def test_gate_stress_no_dispatch_inside_an_exclusive_hold():
    """More threads than cores, a short switch interval: no shared
    section ever overlaps an exclusive one, and every thread finishes."""
    import sys
    from incubator_mxnet_tpu_torch.cuda_graphs import DispatchGate
    gate, lock = DispatchGate(), threading.Lock()
    state = {"shared": 0, "exclusive": 0, "bad": 0, "writes": 0}
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            with gate.shared():
                with lock:
                    state["shared"] += 1
                    state["bad"] += state["exclusive"]
                with lock:
                    state["shared"] -= 1

    def writer():
        while not stop.is_set():
            with gate.exclusive():
                with lock:
                    state["exclusive"] += 1
                    state["bad"] += state["shared"]
                    state["writes"] += 1
                with lock:
                    state["exclusive"] -= 1
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader) for _ in range(24)] + \
        [threading.Thread(target=writer) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        threading.Event().wait(1.0)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert state["bad"] == 0 and state["writes"] > 0


def test_capture_waits_for_a_dispatch_in_flight(tmp_path):
    from incubator_mxnet_tpu_torch.cuda_graphs import DISPATCH_GATE
    started, release = threading.Event(), threading.Event()

    def dispatch():
        with DISPATCH_GATE.shared():
            started.set()
            release.wait(10)
    t = threading.Thread(target=dispatch)
    t.start()
    assert started.wait(10)
    out = []
    c = threading.Thread(target=lambda: out.append(
        td.capture_profile(0.05, out_dir=str(tmp_path))))
    c.start()
    deadline = td.time.monotonic() + 10
    while not torch.autograd.profiler._is_profiler_enabled:  # ungated start
        assert td.time.monotonic() < deadline
        td.time.sleep(0.005)
    c.join(0.3)
    assert c.is_alive() and not out     # the stop waits for the dispatch
    release.set()
    for th in (t, c):
        th.join(30)
        assert not th.is_alive()
    assert "traceEvents" in _trace(out[0])


@pytest.fixture(scope="module")
def server():
    from incubator_mxnet_tpu_torch import initializer as tinit
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


def _profile(srv, seconds):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/debug/profile?seconds={seconds}",
        data=b"{}", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_profile_route_answers_200_400_409(server, tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_PROFILE_DIR", str(tmp_path))
    status, _, body = _profile(server, 0.05)
    assert status == 200 and os.path.dirname(body["profile"]) == \
        str(tmp_path)
    assert "traceEvents" in _trace(body["profile"])
    assert _profile(server, "nope")[0] == 400
    first = []
    t = threading.Thread(target=lambda: first.append(_profile(server, 1.0)))
    t.start()
    try:
        while not td.capture_active():
            td.time.sleep(0.005)
        status, headers, body = _profile(server, 0.05)
    finally:
        t.join(timeout=60)
    assert status == 409 and int(headers["Retry-After"]) >= 1
    assert "already in progress" in body["error"]
    assert first[0][0] == 200


def test_failed_capture_answers_500(server, tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_PROFILE_DIR", str(tmp_path))

    def broken(*a, **kw):
        raise RuntimeError("profiler unavailable")
    monkeypatch.setattr(torch.profiler, "profile", broken)
    status, _, body = _profile(server, 0.05)
    assert status == 500
    assert "profiler capture failed" in body["error"]
    assert "profiler unavailable" in body["error"]
    assert not td.capture_active()


# ---------------------------------------------------- on the card (cuda)
#: the paged-decode kernel (K2) as the trace names it: the split kernel of
#: decode_common.cuh over a paged cache (gpt_tiny: head dim 32)
K2_TRACE_NAME = "split_kernel<32, mxdec::PagedKV>"


def kernel_names(trace):
    return {e.get("name", "") for e in trace["traceEvents"]
            if e.get("cat") == "kernel"}


@pytest.mark.cuda
def test_cuda_capture_during_serving(tmp_path):
    """Three captures while clients stream from a batcher whose worker
    replays CUDA graphs on its own thread: no crash, each trace names K2,
    and every request served meanwhile equals its run before the
    captures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from incubator_mxnet_tpu_torch import initializer as tinit
    from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
    from incubator_mxnet_tpu_torch.serving import (ContinuousBatcher,
                                                   GenerationEngine)
    net = gpt_tiny(dropout=0.0, device="cuda")
    tinit.initialize(net, tinit.Normal(0.02), 0)
    eng = GenerationEngine(net, name="gpt", max_slots=4, max_len=256)
    eng.warmup()
    bat = ContinuousBatcher(eng)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, n).tolist() for n in (7, 30, 64, 12)]
    stop, served, wrong = threading.Event(), [], []
    try:
        want = [bat.submit(p, max_new_tokens=150) for p in prompts]

        def client(i):
            while not stop.is_set():
                got = bat.submit(prompts[i], max_new_tokens=150)
                served.append(i)
                if got != want[i]:
                    wrong.append(i)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        paths = [td.capture_profile(0.3, out_dir=str(tmp_path))
                 for _ in range(3)]
        stop.set()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        stop.set()
        bat.close()
    assert len(served) > len(prompts) and wrong == []
    for path in paths:
        names = kernel_names(_trace(path))
        assert any(K2_TRACE_NAME in n for n in names), sorted(names)[:20]
