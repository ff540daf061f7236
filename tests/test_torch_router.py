"""The port's fleet front tier (``incubator_mxnet_tpu_torch/serving/
router.py``) against the JAX package's, on the CPU.

* The pure functions, in-process, on the same inputs: ``rendezvous_order``
  (1000 keys over fleets of 3, 4 and 5 replicas: the same order),
  ``prefix_key``, ``fault.retry_after_hint``, ``Histogram.merge`` /
  ``stats_of``, ``merge_states`` and ``render_prometheus_state``.
* The scenarios of ``tests/test_router.py`` and ``tests/test_fleet_obs.py``
  through each package's ``Router`` over the same stdlib fake replicas
  (``FakeReplica``, ``ObsReplica``, copied here): each package runs in
  its own child interpreter (this file run as a script with ``--pkg``),
  with every ``MXNET_*`` variable unset and its incident and profile
  directories under ``tmp_path``; each child writes what it observed
  (statuses, headers, body key sets, SSE frames, counter deltas, with
  replica addresses replaced by names) to JSON, and the two records must
  be equal, scenario by scenario.
* The port's ``Router`` over two port ``ModelServer``s (``device="cpu"``,
  ``gpt_tiny``, the same weights): tokens through the router equal a
  direct request, sync and SSE; the fan-outs (``/programs``,
  ``/memory``, ``/health``, ``POST /debug/profile``); and a client that
  disconnects through the router frees the replica's KV blocks.
* The JAX ``Router``, in a child, fronting a port ``ModelServer``: the
  wire compatibility the port's server claims."""
import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("incubator_mxnet_tpu", "incubator_mxnet_tpu_torch")


# ------------------------------------------------------------ fake fleet
class FakeReplica:
    """A scripted stdlib replica (a copy of ``tests/test_router.py``'s):
    answers ``/readyz``/``/slo`` like a server and plays back per-request
    plans for ``:predict`` and ``:generate``."""

    def __init__(self):
        self.ready = True
        self.burn = 0.0
        self.predict_plan = []          # ("ok"|"429"|"503", retry_after)
        self.generate_plan = []         # "ok"|"die_before_first"|"die_midstream"
        self.tokens = [5, 6, 7, 8]
        self.predict_rids = []
        self.generate_rids = []
        self.drains = 0
        self.undrains = 0
        self._srv = None
        self.port = None

    @property
    def id(self):
        return f"127.0.0.1:{self.port}"

    def start(self, port=0):
        rep = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code, obj, headers=None):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/readyz":
                    self._json(200 if rep.ready else 503,
                               {"status": "ready" if rep.ready
                                else "unready", "draining": False})
                elif self.path == "/slo":
                    self._json(200, {"models":
                                     {"g": {"burn_rate": rep.burn}}})
                else:
                    self._json(200, {"models": {}})

            def _chunk(self, data):
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                self.wfile.flush()

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(n)
                rid = self.headers.get("X-Request-Id", "")
                if self.path in ("/admin/drain", "/admin/undrain"):
                    drain = self.path == "/admin/drain"
                    rep.drains += drain
                    rep.undrains += not drain
                    rep.ready = not drain
                    self._json(200, {"draining": drain})
                    return
                if self.path.endswith(":predict"):
                    rep.predict_rids.append(rid)
                    kind, arg = rep.predict_plan.pop(0) \
                        if rep.predict_plan else ("ok", None)
                    if kind == "ok":
                        self._json(200, {"ok": True, "replica": rep.id,
                                         "request_id": rid})
                    elif kind == "429":
                        self._json(429, {"error": "queue full",
                                         "retry_after": arg},
                                   headers={"Retry-After": arg})
                    else:
                        self._json(503, {"error": "shedding"},
                                   headers={"Retry-After": arg or 1})
                    return
                if self.path.endswith(":generate"):
                    rep.generate_rids.append(rid)
                    mode = rep.generate_plan.pop(0) \
                        if rep.generate_plan else "ok"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    self.wfile.flush()
                    if mode == "die_before_first":
                        self.connection.shutdown(socket.SHUT_RDWR)
                        self.connection.close()
                        return
                    for i, t in enumerate(rep.tokens):
                        self._chunk(b"event: token\ndata: " + json.dumps(
                            {"token": t, "index": i}).encode() + b"\n\n")
                        if mode == "die_midstream" and i == 1:
                            self.connection.shutdown(socket.SHUT_RDWR)
                            self.connection.close()
                            return
                    self._chunk(b"event: done\ndata: " + json.dumps(
                        {"tokens": rep.tokens,
                         "request_id": rid}).encode() + b"\n\n")
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                    return
                self._json(404, {"error": "?"})

        self._srv = ThreadingHTTPServer(("127.0.0.1", port), H)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()
        return self

    def stop(self):
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None


def _trace_parent(raw):
    """``<request id>-<hex hop id>`` -> (request id, hop id), else None."""
    if not raw or "-" not in raw:
        return None
    rid, _, sid = raw.rpartition("-")
    return (rid, sid) if rid and sid else None


class ObsReplica:
    """A scripted replica for the observability endpoints (a copy of
    ``tests/test_fleet_obs.py``'s): ``/readyz``, ``/slo``,
    ``/metrics.json``, ``/flight`` and ``/trace``, recording the
    ``X-Trace-Id`` each ``:predict`` arrives with and serving back spans
    whose ``remote_parent`` names that hop."""

    def __init__(self):
        self.ready = True
        self.predict_plan = []          # ("ok"|"503", retry_after)
        self.metrics_state = {"counters": {}, "gauges": {},
                              "histograms": {}}
        self.slo_snapshot = {"objectives": {}, "models": {}}
        self.flight = {"ring": [], "fake": True}
        self.trace_headers = []
        self.spans_by_rid = {}
        self._srv = None
        self.port = None

    @property
    def id(self):
        return f"127.0.0.1:{self.port}"

    def start(self, port=0):
        rep = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code, obj, headers=None):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/readyz":
                    self._json(200 if rep.ready else 503,
                               {"status": "ready" if rep.ready
                                else "unready", "draining": False})
                elif path == "/slo":
                    self._json(200, rep.slo_snapshot)
                elif path == "/metrics.json":
                    self._json(200, rep.metrics_state)
                elif path == "/flight":
                    self._json(200, rep.flight)
                elif path == "/trace":
                    rid = urllib.parse.parse_qs(query).get(
                        "request_id", [None])[-1]
                    self._json(200, {"request_id": rid, "spans":
                                     rep.spans_by_rid.get(rid, [])})
                else:
                    self._json(404, {"error": "?"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(n)
                rid = self.headers.get("X-Request-Id", "")
                if self.path.endswith(":predict"):
                    raw = self.headers.get("X-Trace-Id")
                    rep.trace_headers.append(raw)
                    parsed = _trace_parent(raw)
                    kind, arg = rep.predict_plan.pop(0) \
                        if rep.predict_plan else ("ok", None)
                    if kind == "ok":
                        if parsed is not None:
                            rep.spans_by_rid.setdefault(
                                parsed[0], []).append(
                                {"name": "serve.request", "cat": "serve",
                                 "attrs": {"request_id": rid,
                                           "trace_id": parsed[0],
                                           "remote_parent": parsed[1],
                                           "replica": rep.id}})
                        self._json(200, {"ok": True, "replica": rep.id,
                                         "request_id": rid})
                    else:
                        self._json(503, {"error": "shedding"},
                                   headers={"Retry-After": arg or 1})
                    return
                self._json(404, {"error": "?"})

        self._srv = ThreadingHTTPServer(("127.0.0.1", port), H)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()
        return self

    def stop(self):
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None


# ---------------------------------------------------------- HTTP helpers
def _post(port, path, body, headers=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    return conn, conn.getresponse()


def _predict(port, headers=None):
    conn, resp = _post(port, "/v1/models/g:predict", {"inputs": [[1]]},
                       headers)
    out = (resp.status, json.loads(resp.read() or b"{}"),
           {k.lower(): v for k, v in resp.getheaders()})
    conn.close()
    return out


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = (resp.status, resp.read())
    conn.close()
    return out


def _sse(resp):
    """(tokens, events, the last error payload) of an SSE response."""
    toks, events, err = [], [], None
    for line in resp:
        line = line.strip()
        if line.startswith(b"event:"):
            events.append(line.split(b":", 1)[1].strip().decode())
        elif line.startswith(b"data:"):
            d = json.loads(line.split(b":", 1)[1])
            if "token" in d:
                toks.append(d["token"])
            elif "error" in d:
                err = d
    return toks, events, err


def _dead_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _named(obj, names):
    """``obj`` with every replica address replaced by its name (ports
    differ between the two children)."""
    text = json.dumps(obj, sort_keys=True, default=str)
    for addr, name in names.items():
        text = text.replace(addr, name).replace(addr.replace(":", "_"),
                                                name)
    return json.loads(text)


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# ------------------------------------------- the scenarios, one package
def _scenarios(pkg, tmp):
    """Run every scenario through ``pkg``'s Router; returns {scenario:
    observations}.  Runs in a child interpreter."""
    import importlib
    fault = importlib.import_module(pkg + ".fault")
    telemetry = importlib.import_module(pkg + ".telemetry")
    serving = importlib.import_module(pkg + ".serving")
    rmod = importlib.import_module(pkg + ".serving.router")
    m = importlib.import_module(pkg + ".serving.metrics")
    slo = importlib.import_module(pkg + ".serving.slo")
    OPEN = importlib.import_module(pkg + ".serving.lifecycle").OPEN
    Router = serving.Router
    prefix_key, rendezvous_order = rmod.prefix_key, rmod.rendezvous_order

    def router(reps, **kw):
        kw.setdefault("port", 0)
        kw.setdefault("health_interval", 0.05)
        kw.setdefault("retry_deadline", 5.0)
        return Router([r if isinstance(r, str) else r.id for r in reps],
                      **kw).start()

    def clean():
        fault.clear_plan()
        telemetry.stop()
        telemetry.reset()
        slo.tracker.reset()

    out = {}

    def scenario(fn):
        clean()
        out[fn.__name__] = fn()
        clean()

    @scenario
    def failover_keeps_request_id():
        # no health poll inside the scenario: a 50 ms poll could mark the
        # forced-ready dead replica dead again before route() reads it,
        # and the count of failovers then varied from run to run in both
        # packages (start() polls once; the next poll is 30 s away)
        live = FakeReplica().start()
        dead_id = f"127.0.0.1:{_dead_port()}"
        r = router([dead_id, live], retries=3, affinity=False,
                   health_interval=30)
        try:
            dead = r.replica(dead_id)
            fo0 = m.ROUTER_FAILOVERS.value
            seen = []
            for _ in range(4):
                dead.ready = dead.reachable = True
                dead.breaker.record_success()
                status, body, hdrs = _predict(r.port,
                                              {"x-request-id": "fo-1"})
                seen.append([status, body.get("ok"),
                             body.get("request_id"),
                             hdrs.get("x-request-id")])
            return {"requests": seen,
                    "failed_over": m.ROUTER_FAILOVERS.value > fo0,
                    "live_rids": sorted(set(live.predict_rids))}
        finally:
            r.stop()
            live.stop()

    @scenario
    def no_replica_503_retry_after():
        r = router([f"127.0.0.1:{_dead_port()}"], retries=1,
                   retry_deadline=1.0)
        try:
            status, body, hdrs = _predict(r.port)
            ready, raw = _get(r.port, "/readyz")
            return {"status": status, "keys": sorted(body),
                    "has_request_id": bool(body.get("request_id")),
                    "retry_after": "retry-after" in hdrs,
                    "readyz": ready, "readyz_status":
                        json.loads(raw)["status"]}
        finally:
            r.stop()

    @scenario
    def retry_after_honored():
        rep = FakeReplica().start()
        rep.predict_plan = [("429", 0.4), ("ok", None)]
        r = router([rep], retries=2)
        try:
            t0 = time.monotonic()
            status, body, _ = _predict(r.port)
            return {"status": status, "ok": body.get("ok"),
                    "attempts": len(rep.predict_rids),
                    "waited_hint": time.monotonic() - t0 >= 0.3}
        finally:
            r.stop()
            rep.stop()

    @scenario
    def fails_over_429_with_capacity():
        a, b = FakeReplica().start(), FakeReplica().start()
        a.predict_plan = [("429", 5.0)] * 10
        r = router([a, b], retries=3, affinity=False)
        try:
            t0 = time.monotonic()
            got = []
            for _ in range(4):
                status, body, _ = _predict(r.port)
                got.append([status, body.get("replica")])
            return _named({"got": got,
                           "no_sleep": time.monotonic() - t0 < 2.0,
                           "a_parked": not r.replica(a.id).eligible()
                           or not a.predict_rids},
                          {a.id: "a", b.id: "b"})
        finally:
            r.stop()
            a.stop()
            b.stop()

    @scenario
    def ejection_and_recovery():
        rep = FakeReplica().start()
        r = Router([rep.id], port=0, health_interval=30, eject_threshold=2,
                   eject_cooldown_seconds=0.1)
        obs = {}
        r.check_health_once()
        obs["eligible_before"] = r.replica(rep.id).eligible()
        port = rep.port
        rep.stop()
        for _ in range(2):
            r.check_health_once()
        obs["breaker"] = r.replica(rep.id).breaker.state
        obs["eligible_dead"] = r.replica(rep.id).eligible()
        try:
            r.route()
            obs["route"] = "routed"
        except serving.NoReplicaAvailable as e:
            obs["route"] = type(e).__name__
            obs["retry_after"] = e.retry_after
        rep2 = FakeReplica().start(port=port)
        try:
            r.check_health_once()
            obs["recovered"] = r.replica(rep.id).breaker.state != OPEN
            obs["eligible_after"] = r.replica(rep.id).eligible()
        finally:
            rep2.stop()
        return obs

    def affine_prompt(r, owner_id):
        ids = [x.id for x in r.replicas]
        for seed in range(200):
            toks = [seed] * 32
            if rendezvous_order(prefix_key(toks, 16, 2),
                                ids)[0] == owner_id:
                return toks
        raise AssertionError("no prompt found for owner")

    @scenario
    def sse_death_before_first_token():
        a, b = FakeReplica().start(), FakeReplica().start()
        a.generate_plan = ["die_before_first"] * 5
        r = router([a, b], retries=2)
        try:
            err0 = m.ROUTER_STREAM_ERRORS.value
            conn, resp = _post(r.port, "/v1/models/g:generate",
                               {"tokens": affine_prompt(r, a.id),
                                "stream": True}, {"x-request-id": "sse-fo"})
            status = resp.status
            toks, events, err = _sse(resp)
            conn.close()
            return {"status": status, "tokens": toks, "events": events,
                    "error": err, "a_rids": a.generate_rids,
                    "b_rids": b.generate_rids,
                    "stream_errors": m.ROUTER_STREAM_ERRORS.value - err0}
        finally:
            r.stop()
            a.stop()
            b.stop()

    @scenario
    def sse_death_midstream():
        rep = FakeReplica().start()
        rep.generate_plan = ["die_midstream"]
        r = router([rep], retries=2)
        try:
            err0 = m.ROUTER_STREAM_ERRORS.value
            conn, resp = _post(r.port, "/v1/models/g:generate",
                               {"tokens": [1] * 32, "stream": True},
                               {"x-request-id": "sse-mid"})
            status = resp.status
            toks, events, err = _sse(resp)
            conn.close()
            return _named({"status": status, "tokens": toks,
                           "events": events, "error": err,
                           "stream_errors":
                               m.ROUTER_STREAM_ERRORS.value - err0},
                          {rep.id: "rep"})
        finally:
            r.stop()
            rep.stop()

    @scenario
    def drain_orchestration():
        a, b = FakeReplica().start(), FakeReplica().start()
        r = router([a, b], affinity=False)
        names = {a.id: "a", b.id: "b"}
        try:
            conn, resp = _post(r.port, "/admin/drain", {"replica": a.id})
            drained = [resp.status, json.loads(resp.read())]
            conn.close()
            n0 = len(a.predict_rids)
            during = [_predict(r.port)[:2] for _ in range(8)]
            during = [[s, body.get("replica")] for s, body in during]
            a_during = len(a.predict_rids) - n0
            conn, resp = _post(r.port, "/admin/undrain", {"replica": a.id})
            undrained = [resp.status, json.loads(resp.read())]
            conn.close()
            eligible = r.replica(a.id).eligible()
            seen = sorted({_predict(r.port)[1]["replica"]
                           for _ in range(16)})
            conn, resp = _post(r.port, "/admin/drain",
                               {"replica": "nope:1"})
            unknown = [resp.status, sorted(json.loads(resp.read()))]
            conn.close()
            obs = _named({"drain": drained, "during": during,
                          "a_during": a_during, "drains": a.drains,
                          "undrain": undrained, "undrains": a.undrains,
                          "eligible": eligible, "seen": seen,
                          "unknown": unknown}, names)
            obs["seen"].sort()
            return obs
        finally:
            r.stop()
            a.stop()
            b.stop()

    @scenario
    def upstream_fault_site():
        rep = FakeReplica().start()
        r = router([rep], retries=2)
        try:
            fault.install_plan("router.upstream:ioerror@1")
            status, body, _ = _predict(r.port)
            return {"status": status, "ok": body.get("ok"),
                    "site_calls": fault.site_calls("router.upstream")}
        finally:
            r.stop()
            rep.stop()

    @scenario
    def affinity():
        reps = [FakeReplica().start() for _ in range(3)]
        r = router(reps, spill_margin=64)
        try:
            statuses = []
            for toks, n in (([3] * 32, 9), ([4] * 32, 5)):
                for _ in range(n):
                    conn, resp = _post(r.port, "/v1/models/g:generate",
                                       {"tokens": toks,
                                        "max_new_tokens": 2})
                    statuses.append(resp.status)
                    resp.read()
                    conn.close()
                if n == 9:
                    first = sorted(len(x.generate_rids) for x in reps)
            counts = sorted(len(x.generate_rids) for x in reps)
            return {"statuses": sorted(set(statuses)), "first": first,
                    "concentrated": counts[-1] in (9, 14)
                    and sum(counts) == 14}
        finally:
            r.stop()
            for x in reps:
                x.stop()

    @scenario
    def stitched_trace_across_failover():
        rep1, rep2 = ObsReplica().start(), ObsReplica().start()
        rep1.predict_plan = [("503", "0")]
        r = router([rep1, rep2], incident_dir=os.path.join(tmp, "inc_a"),
                   health_interval=30)
        names = {rep1.id: "rep1", rep2.id: "rep2"}
        try:
            with r._lock:
                r._rr = 1               # round robin: rep1 first
            status, body, _ = _predict(r.port, {"x-request-id": "trace-1"})
            parsed = [_trace_parent(h) for h in
                      rep1.trace_headers + rep2.trace_headers]
            st, raw = _get(r.port, "/trace?request_id=trace-1")
            stitched = json.loads(raw)
            hops = stitched["hops"]
            obs = {"status": status, "replica": body.get("replica"),
                   "roots": sorted({p[0] for p in parsed}),
                   "distinct_hops": len({p[1] for p in parsed}),
                   "trace_status": st, "keys": sorted(stitched),
                   "stitched": stitched["stitched"],
                   "hops": [[h["replica"], h["outcome"], h["name"],
                             sorted(h)] for h in hops],
                   "child_parent_is_hop":
                       hops[1]["children"][0]["attrs"]["remote_parent"]
                       == hops[1]["id"],
                   "child_trace_id":
                       hops[1]["children"][0]["attrs"]["trace_id"],
                   "shed_leg_children": "children" in hops[0],
                   "unknown": _get(r.port, "/trace?request_id=nope")[0],
                   "missing": _get(r.port, "/trace")[0]}
            rep2.stop()                 # the answering replica dies
            kids = r.stitch_trace("trace-1")["hops"][1]["children"]
            obs["after_death"] = [kids[0]["name"], kids[0]["synthetic"],
                                  kids[0]["replica"]]
            return _named(obs, names)
        finally:
            r.stop()
            rep1.stop()
            rep2.stop()

    def counter_state(name, value, labels="model=g"):
        return {name: {"help": "h", "values": {labels: float(value)}}}

    @scenario
    def federation_sums_and_staleness():
        rep1, rep2 = ObsReplica().start(), ObsReplica().start()
        rep1.metrics_state = {
            "counters": {**counter_state("mxtpu_serve_requests", 10),
                         **counter_state("mxtpu_router_requests", 99,
                                         labels="")},
            "gauges": counter_state("mxtpu_kernel_launches", 7,
                                    labels="kernel=paged_decode"),
            "histograms": {"mxtpu_serve_latency_seconds": {
                "help": "h", "count": 2, "sum": 0.3, "max": 0.2,
                "samples": [0.1, 0.2]}}}
        rep2.metrics_state = {
            "counters": counter_state("mxtpu_serve_requests", 32),
            "gauges": counter_state("mxtpu_kernel_launches", 5,
                                    labels="kernel=paged_decode"),
            "histograms": {"mxtpu_serve_latency_seconds": {
                "help": "h", "count": 1, "sum": 0.9, "max": 0.9,
                "samples": [0.9]}}}
        r = router([rep1, rep2], incident_dir=os.path.join(tmp, "inc_b"),
                   health_interval=30)
        names = {rep1.id: "rep1", rep2.id: "rep2"}
        try:
            r._federate_maybe(force=True)
            fleet = r.fleet_metrics_state()
            _, raw = _get(r.port, "/metrics")
            text = raw.decode()
            lines = sorted(ln for ln in text.splitlines()
                           if ln.startswith(("mxtpu_serve_requests",
                                             "mxtpu_kernel_launches",
                                             "mxtpu_serve_latency")))
            obs = {"counters": fleet["counters"], "gauges":
                   fleet["gauges"]["mxtpu_kernel_launches"],
                   "histogram": fleet["histograms"][
                       "mxtpu_serve_latency_seconds"],
                   "lines": lines,
                   "router_type_lines": text.count(
                       "# TYPE mxtpu_router_requests counter")}
            with r._lock:
                r._federation[rep1.id]["time"] -= r._stale_horizon() + 100
            fleet = r.fleet_metrics_state()
            obs["stale"] = fleet["counters"]["mxtpu_serve_requests"]
            obs["stale_gauge"] = m.ROUTER_FEDERATION_STALE.value
            obs["counters"].pop("mxtpu_router_requests", None)
            obs = _named(obs, names)
            obs["lines"].sort()
            return obs
        finally:
            r.stop()
            rep1.stop()
            rep2.stop()

    def slo_snapshot(window, bad, slow, p99):
        return {"objectives": {"availability": 0.99, "p99_seconds": 0.5},
                "models": {"g": {"model": "g", "window": window,
                                 "bad": bad, "slow": slow,
                                 "availability": 1 - bad / window,
                                 "availability_objective": 0.99,
                                 "p99_seconds": p99,
                                 "burn_rate": (bad / window) / 0.01}}}

    @scenario
    def fleet_slo():
        rep1, rep2 = ObsReplica().start(), ObsReplica().start()
        rep1.slo_snapshot = slo_snapshot(900, 0, 0, 0.1)
        rep2.slo_snapshot = slo_snapshot(100, 10, 5, 0.7)
        r = router([rep1, rep2], incident_dir=os.path.join(tmp, "inc_c"),
                   health_interval=30)
        try:
            status, raw = _get(r.port, "/slo")
            obs = _named({"status": status, "body": json.loads(raw)},
                         {rep1.id: "rep1", rep2.id: "rep2"})
            obs["body"]["replicas"].sort()      # sorted by address
            return obs
        finally:
            r.stop()
            rep1.stop()
            rep2.stop()

    @scenario
    def incident_bundle():
        rep = ObsReplica().start()
        inc = os.path.join(tmp, "incidents")
        r = router([rep], incident_dir=inc, retry_deadline=0.5,
                   eject_threshold=2, health_interval=30)
        try:
            first = _predict(r.port, {"x-request-id": "ok-req"})[0]
            rep.stop()
            doomed = _predict(r.port, {"x-request-id": "doomed-req"})[0]

            def bundles():
                return sorted(x for x in os.listdir(inc)
                              if not x.startswith(".")) \
                    if os.path.isdir(inc) else []
            _wait(lambda: len(bundles()) >= 2)
            got = bundles()
            obs = {"first": first, "doomed": doomed,
                   "reasons": sorted(b.split("_", 3)[3] for b in got)}
            ej = os.path.join(inc, [b for b in got
                                    if b.endswith("_ejected")][0])
            with open(os.path.join(ej, "incident.json")) as f:
                man = json.load(f)
            obs["manifest"] = {k: man[k] for k in ("reason", "replica",
                                                   "request_ids", "files")}
            obs["manifest_keys"] = sorted(man)
            obs["files_exist"] = all(os.path.exists(os.path.join(ej, f))
                                     for f in man["files"])
            with open(os.path.join(ej, "router_flight.json")) as f:
                flight = json.load(f)
            obs["flight_reason"] = flight["reason"]
            obs["doomed_in_ring"] = any(
                h["request_id"] == "doomed-req"
                for h in flight["router"]["recent_hops"])
            with open(os.path.join(ej, "stitched_traces.json")) as f:
                legs = json.load(f)["doomed-req"]["hops"]
            obs["legs"] = sorted({(h["replica"], h["outcome"])
                                  for h in legs})
            with open(os.path.join(ej, "metrics_delta.json")) as f:
                obs["delta_keys"] = sorted(json.load(f))
            before = len(os.listdir(inc))
            r._incident("ejected", rep.id, ["doomed-req"])
            time.sleep(0.3)
            obs["debounced"] = len(os.listdir(inc)) == before
            return _named(obs, {rep.id: "rep"})
        finally:
            r.stop()

    return out


def _run_child(pkg, tmp):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env["PYTHONPATH"] = str(ROOT)
    env["MXNET_ROUTER_INCIDENT_DIR"] = str(tmp / "incidents_default")
    env["MXNET_PROFILE_DIR"] = str(tmp / "profile")
    env["MXNET_FLIGHT_DUMP_DIR"] = str(tmp / "flight")
    out = tmp / "observed.json"
    return subprocess.Popen(
        [sys.executable, __file__, "--pkg", pkg, "--out", str(out),
         "--tmp", str(tmp)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", choices=PKGS, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--tmp", required=True)
    args = ap.parse_args()
    if args.pkg == "incubator_mxnet_tpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
    with open(args.out, "w") as f:
        json.dump(_scenarios(args.pkg, args.tmp), f, sort_keys=True)
    sys.exit(0)


# ======================================================== the pytest side
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from incubator_mxnet_tpu_torch import fault as tfault  # noqa: E402
from incubator_mxnet_tpu_torch import telemetry as ttel  # noqa: E402
from incubator_mxnet_tpu_torch.serving import router as trouter  # noqa: E402
from incubator_mxnet_tpu_torch.serving import slo as tslo  # noqa: E402

SCENARIOS = ["failover_keeps_request_id", "no_replica_503_retry_after",
             "retry_after_honored", "fails_over_429_with_capacity",
             "ejection_and_recovery", "sse_death_before_first_token",
             "sse_death_midstream", "drain_orchestration",
             "upstream_fault_site", "affinity",
             "stitched_trace_across_failover",
             "federation_sums_and_staleness", "fleet_slo",
             "incident_bundle"]


@pytest.fixture(autouse=True)
def _clean_port_state(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHT_DUMP_DIR", str(tmp_path / "flight"))
    tfault.clear_plan()
    ttel.reset()
    tslo.tracker.reset()
    yield
    tfault.clear_plan()
    ttel.stop()
    ttel.reset()
    tslo.tracker.reset()


# ------------------------------------------------------ pure functions
@pytest.mark.parametrize("n", [3, 4, 5])
def test_rendezvous_order_equals_jax(n):
    from incubator_mxnet_tpu.serving import router as jrouter
    ids = [f"10.0.0.{i}:80{i}" for i in range(n)]
    rng = np.random.RandomState(n)
    for _ in range(1000):
        key = rng.bytes(16)
        assert trouter.rendezvous_order(key, ids) == \
            jrouter.rendezvous_order(key, ids)


def test_prefix_key_equals_jax():
    from incubator_mxnet_tpu.serving import router as jrouter
    rng = np.random.RandomState(0)
    cases = [([], 16, 2), (list(range(15)), 16, 2), (list(range(16)), 16, 2),
             (list(range(47)), 16, 2), (list(range(200)), 16, 0),
             (list(range(64)) + [9, 9], 16, 4), ([-3, 7] * 20, 8, 3),
             (list(range(32)), 0, 2)]
    cases += [(rng.randint(0, 50257, rng.randint(1, 300)).tolist(),
               int(rng.choice([4, 16, 32])), int(rng.randint(0, 5)))
              for _ in range(50)]
    for toks, bs, mb in cases:
        assert trouter.prefix_key(toks, bs, mb) == \
            jrouter.prefix_key(toks, bs, mb)


def test_retry_after_hint_equals_jax():
    from incubator_mxnet_tpu import fault as jfault

    def err(v):
        e = RuntimeError("x")
        if v is not None:
            e.retry_after = v
        return e
    for v in (None, 0.25, 0, 3, -1.0, "soon", "2.5", float("inf")):
        assert tfault.retry_after_hint(err(v)) == \
            jfault.retry_after_hint(err(v))


def _hist(rng, n, lo, hi):
    s = sorted(rng.uniform(lo, hi, n).tolist())
    return {"count": n, "sum": float(sum(s)), "max": s[-1] if s else None,
            "samples": s}


def test_histogram_merge_and_states_equal_jax():
    from incubator_mxnet_tpu import telemetry as jtel
    rng = np.random.RandomState(1)
    parts = [_hist(rng, 3000, 0, 3), _hist(rng, 3000, 10, 13),
             _hist(rng, 7, 1, 2), {"count": 0, "sum": 0.0, "max": None,
                                   "samples": []}]
    for cap in (4096, 100, 5000):
        got = ttel.Histogram.merge(parts, max_samples=cap)
        assert got == jtel.Histogram.merge(parts, max_samples=cap)
        assert ttel.Histogram.stats_of(got) == jtel.Histogram.stats_of(got)
    states = [{"counters": {"mxtpu_serve_requests": {
                  "help": "h", "values": {"model=g": 10.0, "": 1.0}}},
               "gauges": {"mxtpu_kernel_launches": {
                   "help": "k", "values": {"kernel=paged_decode": 96.0}}},
               "histograms": {"mxtpu_serve_latency_seconds":
                              dict(parts[0], help="l")}},
              {"counters": {"mxtpu_serve_requests": {
                  "help": "h", "values": {"model=g": 32.0}}},
               "gauges": {"mxtpu_kernel_launches": {
                   "help": "k", "values": {"kernel=paged_decode": 4.0,
                                           "kernel=flash_fwd": 8.0}}},
               "histograms": {"mxtpu_serve_latency_seconds":
                              dict(parts[1], help="l")}},
              None]
    merged = ttel.merge_states(states)
    assert merged == jtel.merge_states(states)
    assert merged["gauges"]["mxtpu_kernel_launches"]["values"] == {
        "kernel=paged_decode": 100.0, "kernel=flash_fwd": 8.0}
    for kw in ({}, {"extra_labels": {"replica": "a:1", "stale": "true"}},
               {"type_lines": False}):
        assert ttel.render_prometheus_state(merged, **kw) == \
            jtel.render_prometheus_state(merged, **kw)
    assert ttel.render_prometheus_state({}) == \
        jtel.render_prometheus_state({})


# ------------------------------------- the scenarios through both routers
@pytest.fixture(scope="module")
def observed(tmp_path_factory):
    runs = {}
    for pkg in PKGS:
        tmp = tmp_path_factory.mktemp(pkg)
        runs[pkg] = _run_child(pkg, tmp)
    out = {}
    for pkg, (proc, path) in runs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{pkg}:\n{err[-4000:]}"
        with open(path) as f:
            out[pkg] = json.load(f)
    return out


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_router_scenario_equals_jax(observed, scenario):
    jax_obs = observed["incubator_mxnet_tpu"][scenario]
    port_obs = observed["incubator_mxnet_tpu_torch"][scenario]
    assert port_obs == jax_obs


def test_router_scenarios_hold_the_reference_contract(observed):
    """The port's observations also meet the reference tests' own
    assertions (so two equal but wrong records cannot pass)."""
    o = observed["incubator_mxnet_tpu_torch"]
    assert all(r == [200, True, "fo-1", "fo-1"]
               for r in o["failover_keeps_request_id"]["requests"])
    assert o["failover_keeps_request_id"]["failed_over"]
    nr = o["no_replica_503_retry_after"]
    assert nr["status"] == 503 and nr["retry_after"] and nr["readyz"] == 503
    assert o["retry_after_honored"]["waited_hint"]
    assert o["fails_over_429_with_capacity"]["got"] == [[200, "b"]] * 4
    ej = o["ejection_and_recovery"]
    assert ej["breaker"] == "OPEN" and ej["route"] == "NoReplicaAvailable"
    assert ej["recovered"] and ej["eligible_after"]
    s0 = o["sse_death_before_first_token"]
    assert s0["tokens"] == [5, 6, 7, 8] and s0["events"][-1] == "done"
    assert s0["a_rids"] == ["sse-fo"] and s0["stream_errors"] == 0
    s1 = o["sse_death_midstream"]
    assert s1["tokens"] == [5, 6] and s1["events"][-1] == "error"
    assert s1["error"]["request_id"] == "sse-mid"
    assert s1["stream_errors"] == 1
    d = o["drain_orchestration"]
    assert d["drain"][1]["drained"] and d["a_during"] == 0
    assert d["seen"] == ["a", "b"] and d["unknown"][0] == 404
    assert o["upstream_fault_site"]["site_calls"] >= 2
    assert o["affinity"]["first"] == [0, 0, 9]
    st = o["stitched_trace_across_failover"]
    assert [h[:2] for h in st["hops"]] == [["rep1", "shed"], ["rep2", "ok"]]
    assert st["child_parent_is_hop"] and not st["shed_leg_children"]
    assert st["after_death"] == ["unreachable", True, "rep2"]
    fed = o["federation_sums_and_staleness"]
    assert fed["counters"]["mxtpu_serve_requests"]["values"] == {
        "model=g": 42.0, "replica=rep1": 10.0, "replica=rep2": 32.0}
    assert fed["gauges"]["values"]["kernel=paged_decode"] == 12.0
    assert fed["router_type_lines"] == 1
    assert fed["stale"]["values"]["model=g"] == 32.0
    slo = o["fleet_slo"]["body"]
    assert slo["fleet"] and slo["models"]["g"]["window"] == 1000
    assert abs(slo["models"]["g"]["burn_rate"] - 1.0) < 1e-9
    inc = o["incident_bundle"]
    assert inc["reasons"] == ["ejected", "failover_exhausted"]
    assert inc["files_exist"] and inc["debounced"]


# --------------------------------- the port's router over port replicas
TINY = dict(max_slots=2, max_len=256)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Two port ``ModelServer``s on the CPU over ``gpt_tiny`` with the same
    weights, and a port ``Router`` over them."""
    from incubator_mxnet_tpu_torch import initializer as tinit
    from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
    from incubator_mxnet_tpu_torch.serving import (GenerationEngine,
                                                   ModelServer, Router)
    servers = []
    for _ in range(2):
        net = gpt_tiny(dropout=0.0, device="cpu")
        net.initialize(tinit.Normal(0.02), seed=0)
        srv = ModelServer(port=0, host="127.0.0.1")
        srv.add_model("g", GenerationEngine(net, name="g", **TINY),
                      warmup=True)
        srv.start()
        servers.append(srv)
    router = Router([f"127.0.0.1:{s.port}" for s in servers], port=0,
                    host="127.0.0.1", health_interval=0.05,
                    incident_dir=str(tmp_path_factory.mktemp("incidents")))
    router.start()
    yield router, servers
    router.stop()
    for s in servers:
        s.stop()


def _generate(port, body, rid):
    conn, resp = _post(port, "/v1/models/g:generate", body,
                       {"x-request-id": rid}, timeout=120)
    if body.get("stream"):
        toks, events, _ = _sse(resp)
        out = (resp.status, toks, events, resp.getheader("X-Request-Id"))
    else:
        out = (resp.status, json.loads(resp.read()),
               resp.getheader("X-Request-Id"))
    conn.close()
    return out


def test_port_router_serves_port_replicas(fleet):
    router, servers = fleet
    prompt = list(range(3, 40))
    body = {"tokens": prompt, "max_new_tokens": 12}
    s, direct, _ = _generate(servers[0].port, body, "direct-1")
    assert s == 200
    s, via, hdr = _generate(router.port, body, "via-1")
    assert s == 200 and via["tokens"] == direct["tokens"]
    assert via["request_id"] == "via-1" and hdr == "via-1"
    s, toks, events, hdr = _generate(router.port, dict(body, stream=True),
                                     "via-sse")
    assert s == 200 and toks == direct["tokens"] and events[-1] == "done"
    assert hdr == "via-sse"
    # the same 32-token prefix goes to the same replica: read the hop log
    owners = set()
    for i in range(3):
        _generate(router.port, {"tokens": prompt[:32] + [i],
                                "max_new_tokens": 2}, f"aff-{i}")
        st, raw = _get(router.port, f"/trace?request_id=aff-{i}")
        owners.add(json.loads(raw)["hops"][-1]["replica"])
    assert len(owners) == 1
    # :predict of a generation model: the replica's 400 passes through
    # unchanged
    conn, resp = _post(router.port, "/v1/models/g:predict",
                       {"inputs": [[1]]}, {"x-request-id": "pred-1"})
    pred = json.loads(resp.read())
    conn.close()
    assert resp.status == 400 and pred["request_id"] == "pred-1"
    assert "use :generate" in pred["error"]


class _StalledReplica:
    """A stdlib replica whose ``:generate`` answers after ``delay``
    seconds and whose ``/debug/profile`` takes ``capture`` seconds: a
    replica whose dispatch a profile capture stalls."""

    def __init__(self, delay, capture):
        rep = self
        self.delay = delay

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._json(200, {"status": "ready", "draining": False}
                           if self.path == "/readyz" else {"models": {}})

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length")
                                    or 0))
                if self.path.startswith("/debug/profile"):
                    time.sleep(capture)
                    self._json(200, {"profile": "p"})
                else:
                    time.sleep(rep.delay)
                    self._json(200, {"tokens": [5], "count": 1})

        class Srv(ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                pass            # the router hung up on a stalled answer

        self.srv = Srv(("127.0.0.1", 0), H)
        self.port = self.srv.server_address[1]
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()


def test_attempts_wait_out_the_routers_own_capture(monkeypatch):
    """While the router's profile fan-out runs, every captured replica
    stalls its dispatch: a request then waits the upstream timeout plus
    the stall a capture can cause (its window and
    ``CAPTURE_STALL_SECONDS``) for its answer, and is served; a replica
    hung past that is still failed over during the capture; before and
    after the capture the upstream timeout holds."""
    from incubator_mxnet_tpu_torch.serving import router as router_mod
    monkeypatch.setattr(router_mod, "CAPTURE_STALL_SECONDS", 1.5)
    rep = _StalledReplica(delay=1.0, capture=6.0)
    router = router_mod.Router(
        [f"127.0.0.1:{rep.port}"], port=0, host="127.0.0.1",
        health_interval=0.05, upstream_timeout=0.5, retries=0)
    router.start()
    body = {"tokens": [1, 2], "max_new_tokens": 1}
    try:
        deadline = time.monotonic() + 10
        while router._eligible() == [] and time.monotonic() < deadline:
            time.sleep(0.05)

        def generate():
            conn, resp = _post(router.port, "/v1/models/g:generate", body)
            out = resp.status, json.loads(resp.read())
            conn.close()
            return out

        assert generate()[0] == 503          # 1.0 s > the 0.5 s timeout
        cap = threading.Thread(target=lambda: _post(
            router.port, "/debug/profile?seconds=0.1", {}, timeout=60)[1]
            .read())
        cap.start()
        time.sleep(0.3)
        status, out = generate()             # 1.0 s < 0.5 + 0.1 + 1.5 s
        assert status == 200 and out["tokens"] == [5], out
        rep.delay = 3.0                      # hung past the stall allowed
        t0 = time.monotonic()
        assert generate()[0] == 503
        assert time.monotonic() - t0 < 3.0
        assert cap.is_alive()                # still inside the capture
        cap.join(timeout=60)
        assert router._captures == []
        rep.delay = 1.0
        time.sleep(0.3)                     # the health loop re-admits it
        assert generate()[0] == 503
    finally:
        router.stop()
        rep.srv.shutdown()


class _FrozenReplica:
    """A stdlib replica whose whole process stops answering while its
    profile capture ends (``/debug/profile`` takes ``capture`` seconds,
    the last ``freeze`` of them frozen): ``/readyz`` and ``:generate``
    wait until it thaws, as a card replica's HTTP threads wait while the
    profiler's stop and export hold the interpreter."""

    def __init__(self, capture, freeze):
        rep = self
        self.frozen = threading.Event()

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _thawed(self):
                while rep.frozen.is_set():
                    time.sleep(0.01)

            def do_GET(self):
                self._thawed()
                self._json(200, {"status": "ready", "draining": False}
                           if self.path == "/readyz" else {"models": {}})

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length")
                                    or 0))
                if self.path.startswith("/debug/profile"):
                    time.sleep(capture - freeze)
                    rep.frozen.set()
                    time.sleep(freeze)
                    rep.frozen.clear()
                    self._json(200, {"profile": "p"})
                else:
                    self._thawed()
                    self._json(200, {"tokens": [5], "count": 1})

        class Srv(ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                pass            # the router hung up on a frozen answer

        self.srv = Srv(("127.0.0.1", 0), H)
        self.port = self.srv.server_address[1]
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()


def test_health_polls_wait_out_the_routers_own_capture(monkeypatch):
    """The fleet smoke's 503 (chip_smoke.py phase 5): a captured replica
    answers nothing while its profiler stops and exports (12.6-16.4 s
    for ``/readyz`` on an H100, two gpt2_124m replicas, beside a 2 s poll
    timeout).  While the router's own fan-out runs, a health poll waits
    as long as an attempt does (``Router._poll_timeout``), so the frozen
    replica stays ready and unejected, and a request that arrives during
    the freeze waits and is served instead of meeting the router's 503
    (no eligible replica)."""
    from incubator_mxnet_tpu_torch.serving import router as router_mod
    monkeypatch.setattr(router_mod, "CAPTURE_STALL_SECONDS", 3.0)
    rep = _FrozenReplica(capture=2.5, freeze=2.0)
    router = router_mod.Router(
        [f"127.0.0.1:{rep.port}"], port=0, host="127.0.0.1",
        health_interval=0.05, upstream_timeout=0.5, retries=0)
    router.start()
    body = {"tokens": [1, 2], "max_new_tokens": 1}
    try:
        deadline = time.monotonic() + 10
        while router._eligible() == [] and time.monotonic() < deadline:
            time.sleep(0.05)
        ejections = router._replicas[0].breaker.state
        cap = threading.Thread(target=lambda: _post(
            router.port, "/debug/profile?seconds=0.1", {}, timeout=60)[1]
            .read())
        cap.start()
        assert rep.frozen.wait(5)
        time.sleep(0.8)                 # > 3 polls' base timeout (0.25 s)
        assert router._eligible() != [], "the frozen replica was dropped"
        conn, resp = _post(router.port, "/v1/models/g:generate", body)
        out = resp.status, json.loads(resp.read())
        conn.close()
        assert out == (200, {"tokens": [5], "count": 1}), out
        cap.join(timeout=60)
        assert not cap.is_alive() and router._captures == []
        assert router._replicas[0].breaker.state == ejections
        assert router._poll_timeout() == 0.25   # after it, the base again
    finally:
        router.stop()
        rep.srv.shutdown()


def test_port_router_fans_out_the_fleet_views(fleet, tmp_path, monkeypatch):
    router, servers = fleet
    ids = {f"127.0.0.1:{s.port}" for s in servers}
    for path in ("/programs", "/memory"):
        st, raw = _get(router.port, path)
        body = json.loads(raw)["replicas"]
        assert st == 200 and set(body) == ids
    for body in json.loads(_get(router.port, "/programs")[1])[
            "replicas"].values():
        g = body["engines"]["g"]
        assert g["compiled_programs"] == g["expected_programs"]
    for body in json.loads(_get(router.port, "/memory")[1])[
            "replicas"].values():
        assert body["owners"]["kv:g"] > 0 and body["owners"]["params:g"] > 0
    health = json.loads(_get(router.port, "/health")[1])
    assert set(health["replicas"]) == ids and "status" in health
    monkeypatch.setenv("MXNET_PROFILE_DIR", str(tmp_path))
    conn, resp = _post(router.port, "/debug/profile?seconds=1", {},
                       timeout=120)
    prof = json.loads(resp.read())
    conn.close()
    # both replicas live in this process, whose profiler takes one capture
    # at a time: one answers the artifact, the other 409 (CaptureBusy)
    assert resp.status == 200 and set(prof["replicas"]) == ids
    done = [o for o in prof["replicas"].values() if "profile" in o]
    busy = [o for o in prof["replicas"].values() if o.get("status") == 409]
    assert len(done) == 1 and len(busy) == 1, prof
    assert os.path.isfile(os.path.join(done[0]["profile"], "trace.json"))
    assert "already in progress" in busy[0]["error"]
    # the federated launches: each replica's /metrics.json refreshes the
    # kernel series, and the router sums it over replicas (both replicas
    # live in this process: 7 launches each)
    import importlib
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels.flash_attention")
    monkeypatch.setitem(fa.launch_counts, "paged_decode", 7)
    router._federate_maybe(force=True)
    text = _get(router.port, "/metrics")[1].decode()
    assert 'mxtpu_kernel_launches{kernel="paged_decode"} 14' in text
    for rid in ids:
        assert f'mxtpu_kernel_launches{{replica="{rid}"}} 7' in text
    assert text.count("# TYPE mxtpu_router_requests counter") == 1


def test_client_disconnect_through_port_router_frees_kv(fleet):
    router, servers = fleet
    m = __import__("incubator_mxnet_tpu_torch.serving.metrics",
                   fromlist=["CANCELLED"])
    cancelled0 = m.CANCELLED.value
    conn, resp = _post(router.port, "/v1/models/g:generate",
                       {"tokens": [3, 7, 11], "max_new_tokens": 200,
                        "stream": True}, {"x-request-id": "dc-1"})
    assert resp.status == 200
    seen = 0
    for line in resp:
        if line.startswith(b"data:"):
            seen += 1
            if seen >= 2:
                break
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.sock.close()

    def freed():
        return all(s.get_model("g").slots_in_use() == 0
                   and s.get_model("g").engine.pool.stats()[
                       "kv_blocks_in_use"] == 0 for s in servers) \
            and m.CANCELLED.value == cancelled0 + 1
    assert _wait(freed, 30)


_JAX_ROUTER = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import http.client, json, sys
from incubator_mxnet_tpu.serving import Router
replica, body = sys.argv[1], json.loads(sys.argv[2])
router = Router([replica], port=0, host="127.0.0.1", health_interval=0.05)
router.start()
out = {"eligible": len(router._eligible())}
for stream in (False, True):
    conn = http.client.HTTPConnection("127.0.0.1", router.port, timeout=120)
    conn.request("POST", "/v1/models/g:generate",
                 body=json.dumps(dict(body, stream=stream)).encode(),
                 headers={"Content-Type": "application/json",
                          "X-Request-Id": f"jax-{int(stream)}"})
    resp = conn.getresponse()
    if stream:
        toks, events = [], []
        for line in resp:
            line = line.strip()
            if line.startswith(b"event:"):
                events.append(line.split(b":", 1)[1].strip().decode())
            elif line.startswith(b"data:"):
                d = json.loads(line.split(b":", 1)[1])
                if "token" in d:
                    toks.append(d["token"])
        out["sse"] = [resp.status, toks, events,
                      resp.getheader("X-Request-Id")]
    else:
        out["sync"] = [resp.status, json.loads(resp.read()),
                       resp.getheader("X-Request-Id")]
    conn.close()
conn = http.client.HTTPConnection("127.0.0.1", router.port, timeout=60)
conn.request("GET", "/trace?request_id=jax-0")
out["trace"] = json.loads(conn.getresponse().read())
router.stop()
print(json.dumps(out))
"""


def test_jax_router_fronts_a_port_replica(fleet):
    _, servers = fleet
    ttel.start()            # the replica records its serve.request spans
    body = {"tokens": [9, 8, 7, 6, 5, 4, 3, 2, 1] * 4, "max_new_tokens": 10}
    s, direct, _ = _generate(servers[1].port, body, "direct-2")
    assert s == 200
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_ROUTER, f"127.0.0.1:{servers[1].port}",
         json.dumps(body)], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["eligible"] == 1
    status, sync, hdr = out["sync"]
    assert status == 200 and sync["tokens"] == direct["tokens"]
    assert sync["request_id"] == "jax-0" and hdr == "jax-0"
    status, toks, events, hdr = out["sse"]
    assert status == 200 and toks == direct["tokens"]
    assert events[-1] == "done" and hdr == "jax-1"
    # the JAX router stitched the port replica's serve.request span under
    # its hop (the port's server adopts the router's X-Trace-Id)
    hop = out["trace"]["hops"][-1]
    assert hop["outcome"] == "ok"
    kids = hop["children"]
    assert kids[0]["name"] == "serve.request"
    assert kids[0]["attrs"]["remote_parent"] == hop["id"]
    assert "unlinked_spans" not in out["trace"]
