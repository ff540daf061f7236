"""mxtpu-router-torch — a fault-tolerant HTTP front tier over a fleet of
``mxtpu-serve-torch`` replicas (the port's copy of
``incubator_mxnet_tpu/serving/router.py``: same routes, status codes,
headers, JSON keys, metric names and ``MXNET_ROUTER_*`` knobs, so either
package's router fronts either package's replicas).

One replica is a fault domain: a process that can be SIGKILLed, drained
for a weight update, or wedged behind an exhausted KV pool.  The router
hides that from clients.  It is host code only (stdlib ``http.client``
upstream, :class:`~..http_util.BaseJSONHandler` downstream) and never
touches a CUDA device:

* **health-aware balancing** — a background loop polls every replica's
  ``GET /readyz`` (readiness and blockers) and ``GET /slo`` (worst-model
  burn rate); ``:predict`` traffic goes weighted least-loaded,
  ``score = (inflight + 1) * (1 + burn)``.
* **outlier ejection** — each replica carries a
  :class:`~.lifecycle.CircuitBreaker` fed by transport failures (connect
  refused/reset, timeouts, mid-stream death); ``threshold`` consecutive
  failures eject it until a health poll succeeds.  A 503 from a
  responding replica flips ``ready`` off without charging the breaker.
* **retry with failover** — connect errors, 429 and 503 re-route under a
  per-request budget (``MXNET_ROUTER_RETRIES``) through
  :func:`fault.retry_call` with :func:`fault.retry_after_hint`: a
  ``Retry-After`` parks that replica and, when no other replica is
  eligible, becomes the sleep before the next attempt.  The body is read
  once and replayed; the client's ``X-Request-Id`` rides every hop.
* **SSE passthrough** — ``:generate`` streams are relayed chunk for
  chunk.  A replica that dies before its first SSE event fails over
  unseen; one that dies once tokens are on the wire ends the stream with
  a terminal ``event: error`` carrying the request id.  A client
  disconnect closes the upstream connection, so the replica cancels the
  request and frees its slot and KV blocks.
* **drain orchestration** — ``POST /admin/drain {"replica": id}`` stops
  routing to the replica first, forwards the drain, then waits for the
  router's in-flight count on it to reach zero; ``/admin/undrain``
  reverses it.  ``POST``/``DELETE /admin/replicas`` change membership.

Generation traffic is **prefix-affine**: requests whose leading
``MXNET_KV_BLOCK_SIZE``-aligned blocks (default 16, the port engine's
page size; up to ``MXNET_ROUTER_AFFINITY_BLOCKS``) agree rendezvous-hash
to the same replica, so its paged prefix cache is reused; an overloaded
owner (inflight above the fleet minimum by ``MXNET_ROUTER_SPILL_MARGIN``)
spills down the rendezvous order.

The fleet's views are federated: ``/metrics`` (fleet sums, among them
the replicas' ``mxtpu_kernel_launches``, plus ``replica=`` series,
from each replica's ``/metrics.json``), ``/slo``, ``/health``, ``/programs``,
``/memory``, a stitched ``/trace?request_id=`` and ``POST
/debug/profile`` fanned out to every replica; incidents (ejection,
failover exhaustion, drain timeout) write correlated bundles under
``MXNET_ROUTER_INCIDENT_DIR``.

Fault site: ``router.upstream`` fires once per upstream attempt.
Metrics: ``mxtpu_router_*``.  CLI: ``mxtpu-router-torch --replica
host:port ...``.
"""
from __future__ import annotations

import hashlib
import http.client
import json
import os
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import quote, urlsplit

from ..base import MXNetError, getenv, getenv_bool, getenv_int
from .. import fault as _fault
from .. import telemetry as _telemetry
from .. import telemetry_ring as _ring
from ..http_util import BaseJSONHandler, HTTPServerBase
from . import lifecycle as _lc
from . import metrics as _m
from . import slo as _slo

__all__ = ["Router", "Replica", "UpstreamError", "NoReplicaAvailable",
           "rendezvous_order", "prefix_key", "default_incident_dir"]

FAULT_SITE = "router.upstream"

# metric families owned by the control process (router + an in-process
# supervisor/autoscaler): rendered once from the local registry, stripped
# from replica snapshots so shared-registry test fleets don't double-count
CONTROL_PLANE_PREFIXES = ("mxtpu_router_", "mxtpu_supervise_",
                          "mxtpu_autoscale_")


def default_incident_dir() -> str:
    """Where correlated incident bundles land:
    ``MXNET_ROUTER_INCIDENT_DIR`` or ``<tmpdir>/mxtpu_incidents``."""
    return getenv("MXNET_ROUTER_INCIDENT_DIR") or \
        os.path.join(tempfile.gettempdir(), "mxtpu_incidents")

#: numeric encoding for the ``mxtpu_router_replica_state`` gauge
READY_CODE, UNREADY_CODE, DRAINING_CODE, EJECTED_CODE, DOWN_CODE = \
    0, 1, 2, 3, 4

_HOP_HEADERS = ("content-type", "retry-after")  # upstream headers kept
_TERMINAL_MARKS = (b"event: done", b"event: error")


class UpstreamError(MXNetError):
    """A retryable upstream failure: connect error, 429/503, or a
    stream that died before its first SSE event.  Carries the server's
    ``Retry-After`` (when one was sent and no alternative replica
    exists — otherwise 0 so failover is immediate);
    :func:`fault.retry_after_hint` reads it."""

    def __init__(self, msg: str, retry_after: Optional[float] = None,
                 replica: Optional[str] = None):
        super().__init__(msg)
        if retry_after is not None:
            self.retry_after = max(0.0, float(retry_after))
        self.replica = replica


class NoReplicaAvailable(UpstreamError):
    """No replica is eligible for new work right now (all ejected,
    draining, unready, or backing off)."""


def rendezvous_order(key: bytes, replicas: Sequence) -> List:
    """Highest-random-weight order of ``replicas`` for ``key``.  Each
    replica's weight is ``blake2b(key || 0 || replica_id)``, so every
    (key, replica) pair hashes independently: adding or removing one
    replica reassigns only the keys it wins/owned (~1/N of the
    keyspace), every other key keeps its owner.  ``replicas`` may be
    :class:`Replica` objects or plain id strings (tests)."""

    def weight(rep) -> bytes:
        rid = rep.id if hasattr(rep, "id") else str(rep)
        h = hashlib.blake2b(digest_size=8)
        h.update(key)
        h.update(b"\x00")
        h.update(rid.encode("utf-8"))
        return h.digest()

    return sorted(replicas, key=weight, reverse=True)


def prefix_key(tokens, block_size: int,
               max_blocks: int) -> Optional[bytes]:
    """The affinity key for a generation request: a digest of the
    leading ``block_size``-aligned token prefix, capped at
    ``max_blocks`` blocks.  Aligning to the KV block size means two
    requests share a key exactly when the paged prefix cache could
    share their leading blocks; capping keeps long unique tails from
    defeating affinity on a common system prompt.  None when the
    prompt is shorter than one block (no shareable block → no
    affinity)."""
    if not tokens or block_size <= 0:
        return None
    n = (len(tokens) // block_size) * block_size
    if n <= 0:
        return None
    if max_blocks > 0:
        n = min(n, max_blocks * block_size)
    h = hashlib.blake2b(digest_size=16)
    for t in tokens[:n]:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.digest()


def _parse_hostport(spec: str) -> Tuple[str, int]:
    spec = spec.strip()
    if "//" not in spec:
        spec = "//" + spec
    split = urlsplit(spec)
    host = split.hostname
    if not host or split.port is None:
        raise MXNetError(
            f"replica {spec!r}: expected host:port or http://host:port")
    return host, int(split.port)


class _HopLog:
    """Bounded per-request record of upstream attempts (hops).

    Every hop gets a span id from the tracer's process-wide sequence —
    the id stamped on the upstream ``X-Trace-Id`` header — so the
    replica's remote ``serve.request`` spans can name exactly which
    router attempt they served.  Works with the tracer off: the hop log
    IS the router's half of the stitched timeline, and routers don't
    require ``telemetry.start()`` to answer ``GET /trace``.  Evicts
    oldest requests beyond ``max_requests`` (LRU on request id)."""

    def __init__(self, max_requests: int = 512):
        self._lock = threading.Lock()
        self._by_rid: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._max = max(1, int(max_requests))

    def begin(self, rid: str, replica_id: str) -> dict:
        hop = {"sid": f"{next(_telemetry._span_seq):08x}",
               "replica": replica_id,
               "start_unix": round(time.time(), 6),
               "t0": time.monotonic(),
               "outcome": None}
        with self._lock:
            hops = self._by_rid.get(rid)
            if hops is None:
                hops = self._by_rid[rid] = []
                while len(self._by_rid) > self._max:
                    self._by_rid.popitem(last=False)
            else:
                self._by_rid.move_to_end(rid)
            hops.append(hop)
        return hop

    @staticmethod
    def end(hop: dict, outcome: str, error=None, status=None) -> None:
        hop["duration_s"] = round(time.monotonic() - hop["t0"], 6)
        hop["outcome"] = outcome
        if error is not None:
            hop["error"] = str(error)[:200]
        if status is not None:
            hop["status"] = int(status)

    @staticmethod
    def _view(hop: dict) -> dict:
        return {k: v for k, v in hop.items() if k != "t0"}

    def get(self, rid: str) -> List[dict]:
        with self._lock:
            return [self._view(h) for h in self._by_rid.get(rid, ())]

    def recent(self, limit: int = 32) -> List[dict]:
        with self._lock:
            items = list(self._by_rid.items())[-max(0, int(limit)):]
        return [{"request_id": rid,
                 "hops": [self._view(h) for h in hops]}
                for rid, hops in items]

    def request_ids_on(self, replica_id: str, failed: bool,
                       limit: int = 8) -> List[str]:
        """Newest-first request ids with a hop on ``replica_id`` —
        failed/open hops when ``failed`` (incident correlation), any
        otherwise."""
        out: List[str] = []
        with self._lock:
            for rid, hops in reversed(self._by_rid.items()):
                for h in hops:
                    if h["replica"] != replica_id:
                        continue
                    if failed and h["outcome"] == "ok":
                        continue
                    out.append(rid)
                    break
                if len(out) >= limit:
                    break
        return out


class Replica:
    """The router's view of one ``mxtpu-serve-torch`` (or ``mxtpu-serve``)
    process."""

    def __init__(self, url: str,
                 eject_threshold: Optional[int] = None,
                 eject_cooldown_seconds: Optional[float] = None):
        self.host, self.port = _parse_hostport(url)
        self.id = f"{self.host}:{self.port}"
        self.breaker = _lc.CircuitBreaker(
            f"replica:{self.id}", threshold=eject_threshold,
            cooldown_seconds=eject_cooldown_seconds)
        self._lock = threading.Lock()
        self.ready = False          # last /readyz verdict
        self.reachable = False      # last poll/request connected at all
        self.draining = False       # router-side drain flag
        self.burn = 0.0             # worst-model SLO burn rate
        self.blockers: List[str] = []
        self.backoff_until = 0.0    # honored Retry-After
        self.last_error = ""
        self._inflight = 0

    # -- load accounting ------------------------------------------------
    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def _inflight_add(self, delta: int) -> None:
        with self._lock:
            self._inflight += delta
            _m.ROUTER_INFLIGHT.set(self._inflight, replica=self.id)

    # -- eligibility ----------------------------------------------------
    def eligible(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return (self.ready and not self.draining
                and self.breaker.state != _lc.OPEN
                and now >= self.backoff_until)

    def note_backoff(self, seconds: float) -> None:
        """Honor a server-sent ``Retry-After``: no new work for
        ``seconds`` (routing only — the health loop keeps polling)."""
        until = time.monotonic() + max(0.0, float(seconds))
        with self._lock:
            self.backoff_until = max(self.backoff_until, until)

    def state_code(self) -> int:
        if self.draining:
            return DRAINING_CODE
        if self.breaker.state == _lc.OPEN:
            return EJECTED_CODE
        if not self.reachable:
            return DOWN_CODE
        if not self.ready:
            return UNREADY_CODE
        return READY_CODE

    def snapshot(self) -> dict:
        code = self.state_code()
        name = {READY_CODE: "READY", UNREADY_CODE: "UNREADY",
                DRAINING_CODE: "DRAINING", EJECTED_CODE: "EJECTED",
                DOWN_CODE: "DOWN"}[code]
        return {"id": self.id, "state": name,
                "ready": self.ready, "reachable": self.reachable,
                "draining": self.draining,
                "breaker": self.breaker.state,
                "burn_rate": self.burn, "blockers": list(self.blockers),
                "inflight": self.inflight,
                "backoff_seconds": max(0.0, self.backoff_until
                                       - time.monotonic()),
                "last_error": self.last_error}

    def __repr__(self):
        return f"<Replica {self.id} {self.snapshot()['state']}>"


class _RouterHTTPServer(HTTPServerBase):
    router: "Router"


#: how long a replica's profile capture may stop its dispatch past the
#: window: the profiler's stop runs holding the dispatch gate (2.0-8.0 s
#: on an H100, PERF.md)
CAPTURE_STALL_SECONDS = 10.0


def profile_timeout(seconds: float) -> float:
    """How long a profile capture of ``seconds`` may take on a replica:
    the window plus a margin for ``torch.profiler``'s first start in a
    process (10-16 s on an H100), its gated stop (2-8 s) and the trace's
    export (2.5-4 s), as PERF.md records them — the reference's 30 s
    margin, set for ``jax.profiler``, leaves under 2 s of that."""
    return float(seconds) + max(60.0, 2.0 * float(seconds))


class Router:
    """Front tier over N replicas.  Programmatic use::

        router = Router(["127.0.0.1:8080", "127.0.0.1:8081"], port=0)
        router.start()
        ... client traffic against router.port ...
        router.stop()

    Constructor args override the ``MXNET_ROUTER_*`` env defaults."""

    def __init__(self, replicas: Sequence[str],
                 port: Optional[int] = None, host: str = "0.0.0.0",
                 retries: Optional[int] = None,
                 health_interval: Optional[float] = None,
                 affinity: Optional[bool] = None,
                 affinity_blocks: Optional[int] = None,
                 spill_margin: Optional[int] = None,
                 upstream_timeout: Optional[float] = None,
                 stream_timeout: Optional[float] = None,
                 retry_deadline: Optional[float] = None,
                 eject_threshold: Optional[int] = None,
                 eject_cooldown_seconds: Optional[float] = None,
                 federate_seconds: Optional[float] = None,
                 incident_dir: Optional[str] = None):
        if not replicas:
            raise MXNetError("Router needs at least one replica")
        self._port = getenv_int("MXNET_ROUTER_PORT", 8081) \
            if port is None else int(port)
        self._host = host
        self.retries = getenv_int("MXNET_ROUTER_RETRIES", 2) \
            if retries is None else int(retries)
        self.health_interval = float(
            getenv("MXNET_ROUTER_HEALTH_INTERVAL_SECONDS", 0.5)) \
            if health_interval is None else float(health_interval)
        self.affinity = getenv_bool("MXNET_ROUTER_AFFINITY", True) \
            if affinity is None else bool(affinity)
        self.affinity_blocks = getenv_int(
            "MXNET_ROUTER_AFFINITY_BLOCKS", 2) \
            if affinity_blocks is None else int(affinity_blocks)
        self.block_size = max(1, getenv_int("MXNET_KV_BLOCK_SIZE", 16))
        self.spill_margin = getenv_int("MXNET_ROUTER_SPILL_MARGIN", 8) \
            if spill_margin is None else int(spill_margin)
        self.upstream_timeout = float(
            getenv("MXNET_ROUTER_UPSTREAM_TIMEOUT_SECONDS", 10.0)) \
            if upstream_timeout is None else float(upstream_timeout)
        # the windows of this router's profile fan-outs in flight (a
        # captured replica stalls its dispatch; see _attempt_timeout)
        self._captures: List[float] = []
        self.stream_timeout = float(
            getenv("MXNET_ROUTER_STREAM_TIMEOUT_SECONDS", 120.0)) \
            if stream_timeout is None else float(stream_timeout)
        self.retry_deadline = float(
            getenv("MXNET_ROUTER_RETRY_DEADLINE_SECONDS", 10.0)) \
            if retry_deadline is None else float(retry_deadline)
        if eject_threshold is None:
            eject_threshold = getenv_int("MXNET_ROUTER_EJECT_THRESHOLD", 3)
        if eject_cooldown_seconds is None:
            eject_cooldown_seconds = float(
                getenv("MXNET_ROUTER_EJECT_COOLDOWN_SECONDS", 2.0))
        # kept as attributes: replicas added after construction
        # (add_replica / POST /admin/replicas) get the same breaker knobs
        self.eject_threshold = int(eject_threshold)
        self.eject_cooldown_seconds = float(eject_cooldown_seconds)
        self._replicas: List[Replica] = []
        for spec in replicas:
            rep = Replica(spec, eject_threshold=self.eject_threshold,
                          eject_cooldown_seconds=self.eject_cooldown_seconds)
            if all(r.id != rep.id for r in self._replicas):
                self._replicas.append(rep)
        self._lock = threading.Lock()
        self._http: Optional[_RouterHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._draining = False
        self._rr = 0                # rotation offset for idle ties
        # -- fleet observability ------------------------------------------
        self.federate_seconds = float(
            getenv("MXNET_ROUTER_FEDERATE_SECONDS", 2.0)) \
            if federate_seconds is None else float(federate_seconds)
        self.incident_dir = default_incident_dir() \
            if incident_dir is None else str(incident_dir)
        self.incident_debounce = 10.0   # seconds per (reason, replica)
        self.max_incidents = getenv_int("MXNET_ROUTER_MAX_INCIDENTS", 8)
        self._hops = _HopLog()
        self._federation: Dict[str, dict] = {}   # rep.id -> cached view
        self._federate_last = -1e9
        self._incident_lock = threading.Lock()
        self._incident_last: Dict[tuple, float] = {}
        self._incident_count = 0
        self._incident_seq = 0
        self._metrics_baseline: Dict[str, float] = {}
        self._baseline_time = time.time()
        self.last_incident_path: Optional[str] = None
        self._recorder: Optional[_ring.FlightRecorder] = None

    # -- registry -------------------------------------------------------
    @property
    def port(self) -> int:
        return self._port

    @property
    def replicas(self) -> List[Replica]:
        return list(self._replicas)

    def replica(self, rid: str) -> Replica:
        for rep in self._replicas:
            if rep.id == rid:
                return rep
        raise KeyError(rid)

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def total_inflight(self) -> int:
        return sum(r.inflight for r in self._replicas)

    # -- health loop ----------------------------------------------------
    def check_health_once(self) -> None:
        """One synchronous sweep over every replica (tests drive this
        directly; the background loop calls it on an interval)."""
        for rep in self._replicas:
            self._poll(rep)
        self._eligible()            # refresh the eligible-count gauge

    def _poll_timeout(self) -> float:
        """How long a health poll waits for ``/readyz`` and ``/slo``: a
        few health intervals, at most 2 s; while this router's own
        profile fan-out runs, as long as a proxied attempt
        (:meth:`_attempt_timeout`).  A captured replica answers nothing
        while its profiler stops and exports (12.6-16.4 s on an H100 with
        two gpt2_124m replicas): a poll that gave up sooner marked every
        captured replica unready and ejected it, and requests arriving
        then met the router's 503 (no eligible replica)."""
        if self._captures:
            return self._attempt_timeout()
        return min(2.0, max(0.25, self.health_interval * 4.0))

    def _poll(self, rep: Replica) -> None:
        try:
            status, body = self._get_json(rep, "/readyz",
                                          self._poll_timeout())
        except OSError as e:
            rep.reachable = False
            rep.ready = False
            rep.last_error = f"health poll: {e}"
            self._record_failure(rep, "health poll failed")
            self._set_state_gauge(rep)
            return
        rep.reachable = True
        rep.ready = status == 200
        if isinstance(body, dict):
            rep.blockers = list(body.get("blockers") or [])
            if body.get("draining"):
                # the replica drains itself (SIGTERM / direct admin) —
                # treat like unready; the router-side drain flag is
                # only flipped by drain_replica()
                rep.ready = False
        rep.last_error = ""
        # a reachable replica is not a transport outlier, whatever its
        # readiness — close/feed the breaker with the success
        self._record_success(rep)
        if rep.ready:
            try:
                s, slo = self._get_json(rep, "/slo", self._poll_timeout())
                if s == 200 and isinstance(slo, dict):
                    models = slo.get("models", {})
                    burns = [m.get("burn_rate", 0.0)
                             for m in models.values()
                             if isinstance(m, dict)]
                    rep.burn = max(burns) if burns else 0.0
            except (OSError, ValueError):
                pass                # burn is advisory; keep the last view
        self._set_state_gauge(rep)

    def _set_state_gauge(self, rep: Replica) -> None:
        _m.ROUTER_REPLICA_STATE.set(rep.state_code(), replica=rep.id)

    def _record_success(self, rep: Replica) -> None:
        rep.breaker.record_success()

    def _record_failure(self, rep: Replica, reason: str) -> None:
        was_open = rep.breaker.state == _lc.OPEN
        rep.breaker.record_failure(reason)
        if not was_open and rep.breaker.state == _lc.OPEN:
            _m.ROUTER_EJECTIONS.inc(replica=rep.id)
            _telemetry.FAULT.publish(site="router.health",
                                     event="ejected", kind="breaker",
                                     replica=rep.id, reason=reason)
            self._incident("ejected", rep.id,
                           self._hops.request_ids_on(rep.id, failed=True))
        self._set_state_gauge(rep)

    def _health_run(self) -> None:
        while not self._stop.wait(self.health_interval):
            try:
                self.check_health_once()
            except Exception:       # the health loop must survive
                pass                # anything one replica throws at it
            try:
                self._federate_maybe()
            except Exception:
                pass

    # -- metrics federation ----------------------------------------------
    def _federate_maybe(self, force: bool = False) -> None:
        """Refresh the per-replica snapshot cache (``/metrics.json`` +
        ``/slo``) at the ``MXNET_ROUTER_FEDERATE_SECONDS`` cadence.
        Piggybacks on the health loop; also called on-demand by the
        federated ``GET /metrics``/``/slo`` so a router driven without
        the background loop (tests) still federates."""
        now = time.monotonic()
        if not force and now - self._federate_last < self.federate_seconds:
            return
        self._federate_last = now
        for rep in self._replicas:
            if not rep.reachable:
                continue            # last snapshot stays and ages out
            try:
                s, state = self._get_json(rep, "/metrics.json",
                                          self._poll_timeout())
                if s != 200 or not isinstance(state, dict):
                    continue
                s2, slo = self._get_json(rep, "/slo",
                                         self._poll_timeout())
            except OSError:
                continue
            entry = {"state": state,
                     "slo": slo if s2 == 200 and isinstance(slo, dict)
                     else None,
                     "time": time.monotonic(),
                     "time_unix": time.time()}
            with self._lock:
                self._federation[rep.id] = entry

    def _stale_horizon(self) -> float:
        return max(3.0 * self.federate_seconds, 1.0)

    @staticmethod
    def _strip_router_series(state: dict) -> dict:
        """Drop control-plane families (``mxtpu_router_*`` and the
        supervisor's ``mxtpu_supervise_*``/``mxtpu_autoscale_*``) from a
        replica snapshot.  Those series are rendered exactly once from
        the control process's local registry; a replica that happens to
        share a registry with a router (in-process tests) or fronts a
        nested router must not double-count them in fleet sums."""
        return {kind: {name: v for name, v in
                       (state or {}).get(kind, {}).items()
                       if not name.startswith(CONTROL_PLANE_PREFIXES)}
                for kind in ("counters", "gauges", "histograms")}

    def _federation_view(self):
        """``[(replica_id, entry, stale)]`` for every cached snapshot,
        refreshing the ``mxtpu_router_federation_stale`` gauge."""
        with self._lock:
            fed = dict(self._federation)
        now = time.monotonic()
        horizon = self._stale_horizon()
        out = [(rid, entry, now - entry["time"] > horizon)
               for rid, entry in sorted(fed.items())]
        _m.ROUTER_FEDERATION_STALE.set(sum(1 for _, _, s in out if s))
        return out

    def fleet_metrics_state(self) -> dict:
        """One mergeable state for the whole fleet: counters/gauges hold
        the fleet-sum label sets PLUS per-replica ``replica=``-labeled
        series (stale snapshots keep their series, tagged
        ``stale="true"``, but are excluded from the sums); histograms
        are the cross-replica reservoir union, so fleet quantiles come
        from merged distributions, not averaged percentiles."""
        view = self._federation_view()
        fresh = [self._strip_router_series(e["state"])
                 for _, e, stale in view if not stale]
        fleet = _telemetry.merge_states(fresh)
        for rid, entry, stale in view:
            state = self._strip_router_series(entry["state"])
            extra = f"replica={rid}" + (",stale=true" if stale else "")
            for kind in ("counters", "gauges"):
                for name, m in state.get(kind, {}).items():
                    dst = fleet[kind].setdefault(
                        name, {"help": m.get("help", ""), "values": {}})
                    total = sum(float(v) for v in
                                (m.get("values") or {}).values())
                    dst["values"][extra] = total
        return fleet

    def render_fleet_metrics(self) -> str:
        """The federated ``GET /metrics`` body: the control plane's own
        series (``mxtpu_router_*`` plus, when a supervisor shares the
        process, ``mxtpu_supervise_*``/``mxtpu_autoscale_*`` — local
        registry, rendered once) + fleet sums and per-replica series
        for everything the replicas report."""
        self._federate_maybe()
        local = _telemetry.registry.export_state()
        local = {kind: {name: v for name, v in local[kind].items()
                        if name.startswith(CONTROL_PLANE_PREFIXES)}
                 for kind in ("counters", "gauges", "histograms")}
        return _telemetry.render_prometheus_state(local) + \
            _telemetry.render_prometheus_state(self.fleet_metrics_state())

    def fleet_slo(self) -> dict:
        """The fleet ``GET /slo`` body: per-replica windows merged by
        summed counts (:func:`serving.slo.merge_snapshots`) — the burn a
        user sees through the router, not any one replica's view."""
        self._federate_maybe()
        view = self._federation_view()
        body = _slo.merge_snapshots(
            {rid: e.get("slo") for rid, e, stale in view if not stale})
        stale = [rid for rid, _, s in view if s]
        if stale:
            body["stale_replicas"] = stale
        return body

    # -- cross-process trace stitching ------------------------------------
    @staticmethod
    def _remote_parent_of(span: dict) -> Optional[str]:
        attrs = span.get("attrs") if isinstance(span, dict) else None
        return attrs.get("remote_parent") if isinstance(attrs, dict) \
            else None

    def stitch_trace(self, rid: str) -> Optional[dict]:
        """One end-to-end timeline for request ``rid``: the router's hop
        records (every upstream attempt, retries and failovers included)
        with each replica's remote span subtree grafted under the hop
        whose span id it names in its ``remote_parent`` attr.  A replica
        that can't answer ``/trace`` anymore (died mid-request) shows up
        as a synthetic ``unreachable`` span under its hop.  ``None``
        when the request id is unknown (aged out or never seen)."""
        hops = self._hops.get(rid)
        if not hops:
            return None
        remote: Dict[str, object] = {}
        for rep_id in sorted({h["replica"] for h in hops}):
            _m.ROUTER_TRACE_FANOUT.inc(replica=rep_id)
            try:
                rep = self.replica(rep_id)
                status, body = self._get_json(
                    rep, "/trace?request_id=" + quote(rid, safe=""),
                    self.upstream_timeout)
                if status == 200 and isinstance(body, dict):
                    remote[rep_id] = body.get("spans") or []
                else:
                    remote[rep_id] = OSError(f"/trace answered {status}")
            except (KeyError, OSError) as e:
                remote[rep_id] = e
        claimed = set()
        out_hops = []
        for h in hops:
            d = {"name": "router.hop", "cat": "router", "id": h["sid"],
                 "request_id": rid}
            d.update({k: v for k, v in h.items() if k != "sid"})
            spans = remote.get(h["replica"])
            if isinstance(spans, Exception):
                d["children"] = [{
                    "name": "unreachable", "cat": "router",
                    "synthetic": True, "replica": h["replica"],
                    "error": str(spans)[:200]}]
            else:
                kids = [s for s in (spans or [])
                        if self._remote_parent_of(s) == h["sid"]]
                claimed.update(id(s) for s in kids)
                if kids:
                    d["children"] = kids
            out_hops.append(d)
        out = {"request_id": rid, "trace_id": rid, "stitched": True,
               "hops": out_hops}
        unlinked = {rep_id: [s for s in spans if id(s) not in claimed]
                    for rep_id, spans in remote.items()
                    if isinstance(spans, list)}
        unlinked = {k: v for k, v in unlinked.items() if v}
        if unlinked:
            # spans that match the request id but name no known hop —
            # direct-to-replica traffic or a pre-propagation replica;
            # surfaced rather than dropped
            out["unlinked_spans"] = unlinked
        if _telemetry.tracer.active:
            router_spans = _telemetry.tracer.find_spans("request_id", rid)
            if router_spans:
                out["router_spans"] = router_spans
        return out

    # -- correlated incident bundles --------------------------------------
    def _incident(self, reason: str, replica_id: Optional[str],
                  request_ids: Sequence[str]) -> None:
        """Budgeted, debounced, async incident-bundle trigger — the
        router-side analogue of ``FlightRecorder._auto_dump``.  Debounce
        is per (reason, replica): one flapping replica costs one bundle
        per ``incident_debounce`` window, and the process writes at most
        ``MXNET_ROUTER_MAX_INCIDENTS`` bundles."""
        now = time.monotonic()
        key = (reason, replica_id or "")
        with self._incident_lock:
            if self._incident_count >= self.max_incidents:
                return
            if now - self._incident_last.get(key, -1e9) < \
                    self.incident_debounce:
                return
            self._incident_last[key] = now
            self._incident_count += 1
            self._incident_seq += 1
            seq = self._incident_seq
        threading.Thread(
            target=self._write_incident_guarded,
            args=(reason, replica_id, list(request_ids or ()), seq),
            name="mxtpu-router-incident", daemon=True).start()

    def _write_incident_guarded(self, reason, replica_id, request_ids,
                                seq) -> None:
        try:
            self.write_incident(reason, replica_id, request_ids, seq)
        except Exception:           # the observer must never take
            pass                    # the router down

    def _fleet_counters_flat(self) -> Dict[str, float]:
        """name → fleet-total for every counter (fresh replicas + the
        router's own ``mxtpu_router_*``) — the incident bundle's metrics
        delta is computed against this."""
        out: Dict[str, float] = {}
        for _, entry, stale in self._federation_view():
            if stale:
                continue
            state = self._strip_router_series(entry["state"])
            for name, m in state.get("counters", {}).items():
                out[name] = out.get(name, 0.0) + sum(
                    float(v) for v in (m.get("values") or {}).values())
        for name, m in _telemetry.registry.export_state()[
                "counters"].items():
            if name.startswith("mxtpu_router_"):
                out[name] = sum(float(v) for v in
                                (m.get("values") or {}).values())
        return out

    def write_incident(self, reason: str, replica_id: Optional[str],
                       request_ids: Sequence[str],
                       seq: Optional[int] = None) -> str:
        """Write one atomic incident bundle directory and return its
        path: the router's flight-recorder payload, the implicated
        replica's ring (``GET /flight``) and recent spans, the stitched
        traces for the request ids that observed the failure, and the
        fleet metrics delta since the router's baseline — all
        cross-keyed by request id in ``incident.json``.  Atomicity:
        assembled under a dot-tmp name, ``os.rename``d into place, so a
        reader never sees a half-written bundle."""
        request_ids = [str(r) for r in (request_ids or ())][:8]
        if seq is None:
            with self._incident_lock:
                self._incident_seq += 1
                seq = self._incident_seq
        base = self.incident_dir
        os.makedirs(base, exist_ok=True)
        name = f"incident_{os.getpid()}_{seq:03d}_{reason}"
        tmp = os.path.join(base, f".{name}.tmp-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)

        def _write(fname, payload):
            with open(os.path.join(tmp, fname), "w") as f:
                json.dump(payload, f, indent=2, default=str)
                f.write("\n")
            return fname

        files = [_write("router_flight.json",
                        _ring.recorder.payload(f"incident:{reason}"))]
        if replica_id:
            safe = replica_id.replace(":", "_")
            try:
                rep = self.replica(replica_id)
                _, flight = self._get_json(rep, "/flight",
                                           self.upstream_timeout)
            except (KeyError, OSError) as e:
                flight = {"unreachable": True, "error": str(e)[:200]}
            files.append(_write(f"replica_{safe}_flight.json", flight))
            traces = {}
            for rid in request_ids:
                try:
                    rep = self.replica(replica_id)
                    _, traces[rid] = self._get_json(
                        rep,
                        "/trace?request_id=" + quote(rid, safe=""),
                        self.upstream_timeout)
                except (KeyError, OSError) as e:
                    traces[rid] = {"unreachable": True,
                                   "error": str(e)[:200]}
            files.append(_write(f"replica_{safe}_trace.json",
                                {"replica": replica_id,
                                 "request_ids": traces}))
        files.append(_write(
            "stitched_traces.json",
            {rid: self.stitch_trace(rid) for rid in request_ids}))
        current = self._fleet_counters_flat()
        delta = {k: v - self._metrics_baseline.get(k, 0.0)
                 for k, v in sorted(current.items())
                 if v - self._metrics_baseline.get(k, 0.0) != 0.0}
        files.append(_write("metrics_delta.json", {
            "since_unix": round(self._baseline_time, 3),
            "window_seconds": round(
                time.time() - self._baseline_time, 3),
            "counters_delta": delta}))
        _write("incident.json", {
            "reason": reason,
            "time_unix": round(time.time(), 3),
            "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "pid": os.getpid(),
            "replica": replica_id,
            "request_ids": request_ids,
            "replicas": [r.snapshot() for r in self._replicas],
            "files": files,
        })
        final = os.path.join(base, name)
        os.rename(tmp, final)       # readers never see a torn bundle
        self.last_incident_path = final
        _m.ROUTER_INCIDENTS.inc(reason=reason)
        _telemetry.FAULT.publish(site="router.incident", event="bundle",
                                 kind=reason, replica=replica_id or "",
                                 path=final)
        return final

    # -- routing --------------------------------------------------------
    def _eligible(self) -> List[Replica]:
        now = time.monotonic()
        out = [r for r in self._replicas if r.eligible(now)]
        _m.ROUTER_REPLICAS_ELIGIBLE.set(len(out))
        return out

    @staticmethod
    def _load_score(rep: Replica) -> float:
        return (rep.inflight + 1.0) * (1.0 + max(0.0, rep.burn))

    def route(self, affinity_key: Optional[bytes] = None,
              exclude=()) -> Replica:
        """Pick the replica for one upstream attempt.  ``exclude``
        holds replica ids already tried this request — preferred
        avoided, reused only when nothing else is eligible."""
        pool = self._eligible()
        if not pool:
            raise NoReplicaAvailable(
                "no eligible replica (states: "
                + ", ".join(f"{r.id}={r.snapshot()['state']}"
                            for r in self._replicas) + ")",
                retry_after=min(1.0, max(0.05, self.health_interval)))
        fresh = [r for r in pool if r.id not in exclude] or pool
        if affinity_key is not None and self.affinity:
            ranked = rendezvous_order(affinity_key, fresh)
            floor = min(r.inflight for r in fresh)
            for i, rep in enumerate(ranked):
                if rep.inflight - floor <= self.spill_margin:
                    if i == 0:
                        _m.ROUTER_AFFINITY.inc(replica=rep.id)
                    else:
                        _m.ROUTER_SPILLS.inc(replica=rep.id)
                    return rep
            _m.ROUTER_SPILLS.inc(replica=ranked[-1].id)
            return min(ranked, key=self._load_score)
        with self._lock:
            self._rr += 1
            start = self._rr % len(fresh)
        rotated = fresh[start:] + fresh[:start]
        return min(rotated, key=self._load_score)

    # -- upstream transport ---------------------------------------------
    def _connect(self, rep: Replica,
                 timeout: Optional[float] = None
                 ) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(
            rep.host, rep.port,
            timeout=self.upstream_timeout if timeout is None
            else timeout)

    def _attempt_timeout(self) -> float:
        """How long a proxied attempt waits for its answer (an SSE
        stream: its first event): ``upstream_timeout``, and while this
        router's own profile fan-out runs, longer by the stall a capture
        can cause (its window and :data:`CAPTURE_STALL_SECONDS`) — every
        captured replica stops dispatching for the profiler's stop, so a
        request queued behind it is stalled, not lost, and failing over
        would only meet another stalled replica.  A replica hung for
        longer is failed over as before, that much later."""
        captures = list(self._captures)
        return self.upstream_timeout + (
            max(captures) + CAPTURE_STALL_SECONDS if captures else 0.0)

    def _get_json(self, rep: Replica, path: str,
                  timeout: float) -> Tuple[int, dict]:
        conn = self._connect(rep, timeout)
        try:
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                data = resp.read()
            except http.client.HTTPException as e:
                raise ConnectionError(str(e)) from e
            try:
                body = json.loads(data.decode("utf-8")) if data else {}
            except (ValueError, UnicodeDecodeError):
                body = {}
            return resp.status, body
        finally:
            conn.close()

    @staticmethod
    def _retry_after_of(resp, body: Optional[dict]) -> Optional[float]:
        raw = resp.getheader("Retry-After")
        if raw is None and isinstance(body, dict):
            raw = body.get("retry_after")
        try:
            return max(0.0, float(raw)) if raw is not None else None
        except (TypeError, ValueError):
            return None

    def _has_alternative(self, tried) -> bool:
        return any(r.id not in tried for r in self._eligible())

    # -- the proxy core --------------------------------------------------
    def proxy(self, handler: BaseJSONHandler, path: str, body: bytes,
              rid: str, affinity_key: Optional[bytes] = None,
              stream: bool = False) -> None:
        """Forward one ``:predict``/``:generate`` POST, retrying with
        failover, then relay the terminal response (or the SSE stream)
        to ``handler``."""
        _m.ROUTER_REQUESTS.inc()
        if self._draining:
            handler.send_json(
                503, {"error": "router is draining", "request_id": rid},
                headers={"Retry-After": 1})
            return
        tried: List[str] = []

        def attempt():
            rep = self.route(affinity_key=affinity_key, exclude=tried)
            tried.append(rep.id)
            if len(tried) > 1:
                _m.ROUTER_RETRIES.inc(replica=rep.id)
            t0 = time.monotonic()
            try:
                _fault.inject(FAULT_SITE, replica=rep.id,
                              request_id=rid)
                return self._dispatch(rep, path, body, rid, stream)
            finally:
                _m.ROUTER_UPSTREAM.observe(time.monotonic() - t0)

        try:
            result = _fault.retry_call(
                attempt, site=FAULT_SITE,
                policy=_fault.RetryPolicy(
                    max_retries=self.retries, base_seconds=0.05,
                    deadline_seconds=self.retry_deadline),
                retry_on=(UpstreamError, OSError),
                retry_after_hint=_fault.retry_after_hint)
        except (UpstreamError, OSError) as e:
            retry = getattr(e, "retry_after", None)
            self._incident("failover_exhausted",
                           getattr(e, "replica", None)
                           or (tried[-1] if tried else None), [rid])
            handler.send_json(
                503, {"error": f"no replica could serve the request: "
                               f"{e}", "request_id": rid,
                      "replicas_tried": tried},
                headers={"Retry-After": retry if retry else 1})
            return
        if len(set(tried)) > 1:
            _m.ROUTER_FAILOVERS.inc()
        if result[0] == "json":
            _, status, data, headers = result
            handler._send(status, data,
                          headers.pop("content-type",
                                      "application/json"),
                          headers=headers or None)
        else:
            _, rep, conn, resp, head, hop = result
            self._relay_stream(handler, rep, conn, resp, head, rid, hop)

    def _dispatch(self, rep: Replica, path: str, body: bytes, rid: str,
                  stream: bool):
        """One upstream attempt.  Returns ``("json", status, text,
        headers)`` for terminal responses or ``("stream", rep, conn,
        resp, head)`` once an SSE stream has produced its first event.
        Raises :class:`UpstreamError` (or ``OSError``) for anything
        worth failing over."""
        rep._inflight_add(+1)
        hop = self._hops.begin(rid, rep.id)
        conn = self._connect(rep, self._attempt_timeout())
        done = False
        try:
            try:
                conn.request(
                    "POST", path, body=body,
                    headers={"Content-Type": "application/json",
                             "X-Request-Id": rid,
                             # traceparent: <trace root>-<hop span id> —
                             # the replica's serve.request span records
                             # both, so the stitcher can graft it under
                             # exactly this attempt
                             "X-Trace-Id": f"{rid}-{hop['sid']}",
                             "Accept": "text/event-stream" if stream
                             else "application/json"})
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException) as e:
                # BadStatusLine/ConnectionReset both mean the same
                # thing here: the replica's socket is gone
                rep.reachable = False
                rep.last_error = str(e)
                self._hops.end(hop, "connect_error", error=e)
                self._record_failure(rep, f"connect: {e}")
                raise UpstreamError(
                    f"{rep.id}: {e}", replica=rep.id,
                    retry_after=0.0 if self._has_alternative([rep.id])
                    else None) from e
            if resp.status in (429, 503):
                data = resp.read()
                try:
                    parsed = json.loads(data.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    parsed = {}
                retry = self._retry_after_of(resp, parsed)
                if retry is not None:
                    rep.note_backoff(retry)
                if resp.status == 503:
                    # shedding (drain/breaker/abort) — readiness will
                    # reflect it on the next poll; not a transport fault
                    rep.ready = False
                self._set_state_gauge(rep)
                self._hops.end(hop, "shed", status=resp.status)
                raise UpstreamError(
                    f"{rep.id} answered {resp.status}", replica=rep.id,
                    retry_after=0.0 if self._has_alternative([rep.id])
                    else retry)
            if stream and resp.status == 200 and "text/event-stream" in \
                    (resp.getheader("Content-Type") or ""):
                head = b""
                while b"\n\n" not in head:
                    try:
                        chunk = resp.read1(65536)
                    except (OSError,
                            http.client.HTTPException) as e:
                        chunk = b""     # IncompleteRead == dead socket
                        rep.last_error = str(e)
                    if not chunk:
                        # died before the FIRST event: nothing reached
                        # the client, failover is transparent
                        self._hops.end(hop, "stream_died_before_first",
                                       error=rep.last_error or None)
                        self._record_failure(
                            rep, "stream died before first event")
                        raise UpstreamError(
                            f"{rep.id} closed the stream before the "
                            "first event", replica=rep.id,
                            retry_after=0.0
                            if self._has_alternative([rep.id])
                            else None)
                    head += chunk
                self._record_success(rep)
                done = True         # inflight stays held for the relay
                return ("stream", rep, conn, resp, head, hop)
            try:
                data = resp.read().decode("utf-8", "replace")
            except (OSError, http.client.HTTPException) as e:
                self._hops.end(hop, "body_read_error", error=e)
                self._record_failure(rep, f"body read: {e}")
                raise UpstreamError(
                    f"{rep.id} died mid-response: {e}", replica=rep.id,
                    retry_after=0.0 if self._has_alternative([rep.id])
                    else None) from e
            headers = {k: resp.getheader(k) for k in _HOP_HEADERS
                       if resp.getheader(k) is not None}
            if resp.status < 500:
                self._record_success(rep)
            self._hops.end(hop, "ok" if resp.status < 500
                           else "upstream_error", status=resp.status)
            return ("json", resp.status, data, headers)
        finally:
            if not done:
                rep._inflight_add(-1)
                conn.close()

    def _relay_stream(self, handler: BaseJSONHandler, rep: Replica,
                      conn, resp, head: bytes, rid: str,
                      hop: Optional[dict] = None) -> None:
        """Relay an open upstream SSE stream.  Downstream disconnect →
        close upstream (the replica cancels and frees its slot/blocks).
        Upstream EOF without a terminal ``done``/``error`` event →
        terminal SSE ``error`` event with the request id."""
        terminal = any(mark in head for mark in _TERMINAL_MARKS)
        tail = head[-64:]
        outcome = "client_disconnect"
        try:
            handler.start_stream(200)
            try:
                handler.relay_chunk(head)
            except OSError:
                return              # client gone → finally closes conn
            if conn.sock is not None:
                conn.sock.settimeout(self.stream_timeout)
            while True:
                try:
                    chunk = resp.read1(65536)
                except (OSError, http.client.HTTPException) as e:
                    rep.last_error = str(e)
                    chunk = b""
                if not chunk:
                    break
                window = tail + chunk
                if any(mark in window for mark in _TERMINAL_MARKS):
                    terminal = True
                tail = window[-64:]
                try:
                    handler.relay_chunk(chunk)
                except OSError:
                    return          # client disconnect mid-stream
            if terminal:            # done/error already on the wire —
                outcome = "ok"
                try:                # a late reset changes nothing
                    handler.end_stream()
                except OSError:
                    pass
                return
            # mid-stream death with tokens already on the wire: the
            # stream cannot be transparently replayed — fail loudly
            outcome = "midstream_error"
            _m.ROUTER_STREAM_ERRORS.inc(replica=rep.id)
            self._record_failure(rep, "mid-stream death")
            _telemetry.FAULT.publish(site=FAULT_SITE,
                                     event="stream_error",
                                     kind="midstream", replica=rep.id,
                                     request_id=rid)
            try:
                handler.send_event(
                    {"error": f"replica {rep.id} died mid-stream",
                     "request_id": rid, "replica": rep.id},
                    event="error")
                handler.end_stream()
            except OSError:
                pass
        finally:
            if hop is not None:
                self._hops.end(hop, outcome)
            rep._inflight_add(-1)
            conn.close()

    # -- GET passthrough (registry/SLO views) ----------------------------
    def forward_get(self, handler: BaseJSONHandler, path: str) -> None:
        for rep in self._eligible():
            try:
                status, body = self._get_json(rep, path,
                                              self.upstream_timeout)
            except OSError:
                continue
            handler.send_json(status, body)
            return
        handler.send_json(503, {"error": "no eligible replica"},
                          headers={"Retry-After": 1})

    def fanout_get(self, path: str,
                   timeout: Optional[float] = None) -> dict:
        """GET ``path`` on EVERY eligible replica in parallel and return
        ``{replica_id: body}`` — the fleet view behind the router's
        ``/programs`` and ``/memory`` routes (one replica's answer is
        not the fleet's: program sets and memory are per-process)."""
        reps = self._eligible()
        out: dict = {}

        def one(rep):
            try:
                status, body = self._get_json(
                    rep, path,
                    self.upstream_timeout if timeout is None
                    else timeout)
                out[rep.id] = body if status == 200 \
                    else {"error": f"HTTP {status}", "status": status}
            except OSError as e:
                out[rep.id] = {"error": str(e)}

        threads = [threading.Thread(target=one, args=(r,), daemon=True)
                   for r in reps]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    def fleet_health(self) -> dict:
        """``GET /health`` federation: every replica's health-plane
        report plus a worst-replica rollup — ``status`` is anomalous if
        ANY replica is, ``fleet_anomaly_total`` sums the per-replica
        counts, and ``worst`` names the replica with the most anomalies
        (its last anomaly inlined) so one request answers "is any
        replica's numerics going sideways, and which one"."""
        replicas = self.fanout_get("/health")
        total = 0.0
        worst_id, worst_count, worst_last = None, -1.0, None
        for rid, body in replicas.items():
            if not isinstance(body, dict) or "error" in body:
                continue
            count = float(body.get("anomaly_total", 0.0) or 0.0)
            total += count
            if count > worst_count:
                worst_id, worst_count = rid, count
                worst_last = body.get("last_anomaly")
        out = {
            "status": "anomalous" if total else "ok",
            "fleet_anomaly_total": total,
            "replicas": replicas,
        }
        if worst_id is not None:
            out["worst"] = {"replica": worst_id,
                            "anomaly_total": max(worst_count, 0.0),
                            "last_anomaly": worst_last}
        return out

    def profile_fanout(self, seconds: float) -> dict:
        """``POST /debug/profile`` fan-out: trigger one on-demand
        profiler capture on every eligible replica in parallel and
        collect the per-replica artifact paths.  Replica-side capture
        blocks for the window plus profiler startup and trace
        serialization (the FIRST capture in a process costs seconds on
        its own), so the upstream timeout is the window plus a generous
        margin — never the router's default."""
        reps = self._eligible()
        results: dict = {}
        timeout = profile_timeout(seconds)
        window = float(seconds)
        self._captures.append(window)

        def one(rep):
            conn = self._connect(rep, timeout)
            try:
                try:
                    conn.request(
                        "POST", f"/debug/profile?seconds={seconds}",
                        body=b"{}",
                        headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    data = resp.read()
                except (OSError, http.client.HTTPException) as e:
                    results[rep.id] = {"error": str(e)}
                    return
                try:
                    body = json.loads(data.decode("utf-8")) \
                        if data else {}
                except (ValueError, UnicodeDecodeError):
                    body = {}
                if resp.status != 200:
                    body.setdefault("error", f"HTTP {resp.status}")
                    body["status"] = resp.status
                results[rep.id] = body
            finally:
                conn.close()

        threads = [threading.Thread(target=one, args=(r,), daemon=True)
                   for r in reps]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            self._captures.remove(window)
        return {"seconds": float(seconds), "replicas": results}

    # -- drain orchestration ---------------------------------------------
    def _admin(self, rep: Replica, path: str) -> None:
        conn = self._connect(rep)
        try:
            conn.request("POST", path, body=b"{}",
                         headers={"Content-Type": "application/json"})
            conn.getresponse().read()
        finally:
            conn.close()

    def drain_replica(self, rid: str,
                      wait_seconds: Optional[float] = None) -> dict:
        """Zero-downtime drain of one replica: stop routing to it
        FIRST, then forward the drain (its own ``/readyz`` flips for
        any other balancer), then wait for the router's in-flight
        count on it to reach zero."""
        rep = self.replica(rid)     # KeyError → HTTP 404
        rep.draining = True
        self._set_state_gauge(rep)
        _telemetry.FAULT.publish(site="router.admin", event="drain",
                                 kind="begin", replica=rep.id)
        try:
            self._admin(rep, "/admin/drain")
        except OSError as e:        # already dead — drained by definition
            rep.last_error = str(e)
        if wait_seconds is None:
            wait_seconds = _lc.default_drain_seconds()
        deadline = time.monotonic() + max(0.0, float(wait_seconds))
        while rep.inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        left = rep.inflight
        if left > 0:
            # requests wedged past the drain budget: capture both sides
            # while the replica can still answer /flight and /trace
            self._incident("drain_timeout", rep.id,
                           self._hops.request_ids_on(rep.id,
                                                     failed=True))
        return {"replica": rep.id, "draining": True,
                "drained": left == 0, "inflight": left}

    def undrain_replica(self, rid: str) -> dict:
        """Reverse :meth:`drain_replica` and re-poll health so the
        replica rejoins the eligible set immediately."""
        rep = self.replica(rid)
        try:
            self._admin(rep, "/admin/undrain")
        except OSError as e:
            rep.last_error = str(e)
        rep.draining = False
        self._poll(rep)
        _telemetry.FAULT.publish(site="router.admin", event="drain",
                                 kind="end", replica=rep.id)
        return {"replica": rep.id, "draining": False,
                "eligible": rep.eligible()}

    # -- dynamic membership ----------------------------------------------
    def add_replica(self, spec: str) -> dict:
        """Join ``spec`` (``host:port``) to the fleet at runtime
        (``POST /admin/replicas``).  Idempotent — re-adding a member is
        a no-op, so a supervisor can retry registration blindly.  The
        newcomer is polled synchronously before this returns: it enters
        the routing tables with a real health verdict, and rendezvous
        hashing keeps the prefix-affinity remap to ~1/N keys."""
        rep = Replica(spec, eject_threshold=self.eject_threshold,
                      eject_cooldown_seconds=self.eject_cooldown_seconds)
        with self._lock:
            existing = next((r for r in self._replicas
                             if r.id == rep.id), None)
            if existing is None:
                # copy-on-write: readers iterate the old list lock-free
                self._replicas = self._replicas + [rep]
        if existing is not None:
            return {"replica": existing.id, "added": False,
                    "eligible": existing.eligible(),
                    "replicas": len(self._replicas)}
        self._poll(rep)             # route with a view, not a guess
        _m.ROUTER_MEMBERSHIP.inc(action="join")
        _telemetry.FAULT.publish(site="router.admin", event="membership",
                                 kind="join", replica=rep.id)
        return {"replica": rep.id, "added": True,
                "eligible": rep.eligible(),
                "replicas": len(self._replicas)}

    def remove_replica(self, rid: str,
                       wait_seconds: Optional[float] = None,
                       drain: bool = True) -> dict:
        """Leave the fleet (``DELETE /admin/replicas/<id>``):
        drain-then-remove, so membership changes are zero-downtime by
        construction.  ``drain=False`` skips the drain for a member
        that is already dead (a supervisor removing a quarantined
        corpse has nothing to wait for)."""
        rep = self.replica(rid)     # KeyError → HTTP 404
        drained = None
        if drain:
            drained = self.drain_replica(rid, wait_seconds=wait_seconds)
        with self._lock:
            self._replicas = [r for r in self._replicas if r.id != rid]
            self._federation.pop(rid, None)
        _m.ROUTER_MEMBERSHIP.inc(action="leave")
        _telemetry.FAULT.publish(site="router.admin", event="membership",
                                 kind="leave", replica=rep.id)
        out = {"replica": rep.id, "removed": True,
               "replicas": len(self._replicas)}
        if drained is not None:
            out["drained"] = drained["drained"]
            out["inflight"] = drained["inflight"]
        return out

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Router":
        if self._http is not None:
            return self
        srv = _RouterHTTPServer((self._host, self._port), _RouterHandler)
        srv.router = self
        self._port = srv.server_address[1]
        self._stop.clear()
        th = threading.Thread(target=srv.serve_forever,
                              name="mxtpu-router-http", daemon=True)
        th.start()
        self._http, self._http_thread = srv, th
        # the router is an incident witness: its flight ring records
        # FAULT events (ejections, stream errors) and the provider adds
        # the fleet view + recent hops to every dump/bundle
        self._recorder = _ring.recorder
        self._recorder.start()
        self._recorder.register_provider("router", self._flight_state)
        self.check_health_once()    # serve with a view, not a guess
        self._federate_maybe(force=True)
        self._metrics_baseline = self._fleet_counters_flat()
        self._baseline_time = time.time()
        self._health_thread = threading.Thread(
            target=self._health_run, name="mxtpu-router-health",
            daemon=True)
        self._health_thread.start()
        return self

    def _flight_state(self) -> dict:
        return {"draining": self._draining,
                "replicas": [r.snapshot() for r in self._replicas],
                "recent_hops": self._hops.recent(32)}

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        th, self._health_thread = self._health_thread, None
        if th is not None:
            th.join(timeout=timeout)
        srv, self._http = self._http, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=timeout)
            self._http_thread = None
        rec, self._recorder = self._recorder, None
        if rec is not None:
            rec.unregister_provider("router")
            rec.stop()

    def shutdown(self, drain_seconds: Optional[float] = None) -> None:
        """The SIGTERM sequence (``run_until_shutdown``): refuse new
        work (503 + ``Retry-After``), let in-flight requests finish
        within the drain budget, then close the port."""
        self._draining = True
        if drain_seconds is None:
            drain_seconds = _lc.default_drain_seconds()
        deadline = time.monotonic() + max(0.0, float(drain_seconds))
        while self.total_inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        self.stop()

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class _RouterHandler(BaseJSONHandler):
    server_version = "mxtpu-router/1.0"

    def do_GET(self):   # noqa: N802 (http.server API)
        self.guard(self._get)

    def do_POST(self):  # noqa: N802
        self.guard(self._post)

    def do_DELETE(self):  # noqa: N802
        self.guard(self._delete)

    def _delete(self):
        from urllib.parse import parse_qs, urlsplit
        router: Router = self.server.router
        split = urlsplit(self.path)
        params = parse_qs(split.query)
        path = split.path.rstrip("/")
        if not path.startswith("/admin/replicas/"):
            self.send_text(404,
                           "not found: DELETE /admin/replicas/<id>\n")
            return
        rid = path[len("/admin/replicas/"):]
        drain = params.get("drain", ["1"])[-1] not in ("0", "false")
        wait = params.get("wait_seconds")
        try:
            wait_seconds = float(wait[-1]) if wait else None
        except ValueError:
            self.send_json(400, {"error":
                                 "wait_seconds must be a number"})
            return
        try:
            out = router.remove_replica(rid, wait_seconds=wait_seconds,
                                        drain=drain)
        except KeyError:
            self.send_json(404, {
                "error": f"unknown replica {rid!r}",
                "replicas": [r.id for r in router.replicas]})
            return
        self.send_json(200, out)

    def _get(self):
        from urllib.parse import parse_qs, urlsplit
        router: Router = self.server.router
        split = urlsplit(self.path)
        params = parse_qs(split.query)
        path = split.path.rstrip("/") or "/"
        if path == "/healthz":
            self.send_json(200, {"status": "ok",
                                 "replicas": len(router.replicas)})
        elif path == "/readyz":
            eligible = len(router._eligible())
            ready = eligible > 0 and not router.draining
            body = {"status": "ready" if ready else
                    ("draining" if router.draining else "unready"),
                    "eligible": eligible,
                    "replicas": {r.id: r.snapshot()["state"]
                                 for r in router.replicas}}
            self.send_json(200 if ready else 503, body,
                           headers=None if ready else {"Retry-After": 1})
        elif path == "/replicas":
            self.send_json(200, {"replicas": [r.snapshot()
                                              for r in router.replicas]})
        elif path == "/v1/models":
            router.forward_get(self, path)
        elif path in ("/programs", "/memory"):
            # per-replica fan-out: program sets and device memory are
            # per-process facts — no single replica speaks for the fleet
            self.send_json(200, {"replicas": router.fanout_get(path)})
        elif path == "/slo":
            self.send_json(200, router.fleet_slo())
        elif path == "/health":
            # health-plane federation: per-replica reports plus the
            # worst-replica rollup (anomaly counts are per-process)
            self.send_json(200, router.fleet_health())
        elif path == "/trace":
            vals = params.get("request_id")
            rid = vals[-1] if vals else None
            if not rid:
                self.send_json(400, {
                    "error": "expected /trace?request_id=<rid>"})
                return
            body = router.stitch_trace(rid)
            if body is None:
                self.send_json(404, {
                    "error": f"no hops recorded for request {rid!r}",
                    "request_id": rid})
                return
            self.send_json(200, body)
        elif path in ("/metrics", "/"):
            self._send(200, router.render_fleet_metrics(),
                       "text/plain; version=0.0.4; charset=utf-8")
        else:
            self.send_text(404, "not found: try /v1/models /healthz "
                                "/readyz /replicas /metrics /slo "
                                "/health /programs /memory "
                                "/trace?request_id=<rid>\n")

    def _post(self):
        router: Router = self.server.router
        path = self.path.split("?", 1)[0]
        rid = self.request_id()
        if path == "/debug/profile":
            # fan the capture out to every eligible replica and return
            # one artifact path per replica (each replica enforces its
            # own single-capture guard — a busy one answers 409 inline)
            from urllib.parse import parse_qs, urlsplit
            params = parse_qs(urlsplit(self.path).query)
            try:
                seconds = float(params.get("seconds", ["1.0"])[0])
            except ValueError:
                self.send_json(400, {"error":
                                     "seconds must be a number"})
                return
            self.send_json(200, router.profile_fanout(seconds))
            return
        if path == "/admin/replicas":
            try:
                body = self.read_json()
            except ValueError as e:
                self.send_json(400, {"error": str(e)})
                return
            spec = body.get("replica") if isinstance(body, dict) \
                else None
            if not spec:
                self.send_json(400, {
                    "error": 'expected {"replica": "host:port"}',
                    "replicas": [r.id for r in router.replicas]})
                return
            try:
                out = router.add_replica(str(spec))
            except MXNetError as e:    # unparseable host:port
                self.send_json(400, {"error": str(e)})
                return
            self.send_json(200, out)
            return
        if path in ("/admin/drain", "/admin/undrain"):
            try:
                body = self.read_json()
            except ValueError as e:
                self.send_json(400, {"error": str(e)})
                return
            target = body.get("replica") if isinstance(body, dict) \
                else None
            if not target:
                self.send_json(400, {
                    "error": 'expected {"replica": "host:port"}',
                    "replicas": [r.id for r in router.replicas]})
                return
            try:
                if path == "/admin/drain":
                    out = router.drain_replica(
                        target, wait_seconds=body.get("wait_seconds"))
                else:
                    out = router.undrain_replica(target)
            except KeyError:
                self.send_json(404, {
                    "error": f"unknown replica {target!r}",
                    "replicas": [r.id for r in router.replicas]})
                return
            self.send_json(200, out)
            return
        if not path.startswith("/v1/models/") or ":" not in path:
            self.send_text(404,
                           "not found: POST /v1/models/<name>:predict "
                           "or :generate\n")
            return
        verb = path.rpartition(":")[2]
        body = self.read_body()
        stream, affinity_key = False, None
        if verb == "generate":
            try:
                payload = json.loads(body.decode("utf-8")) if body \
                    else {}
            except (ValueError, UnicodeDecodeError):
                payload = {}
            if isinstance(payload, dict):
                stream = bool(payload.get("stream", False))
                tokens = payload.get("tokens", payload.get("inputs"))
                if isinstance(tokens, (list, tuple)) \
                        and len(tokens) == 1 \
                        and isinstance(tokens[0], (list, tuple)):
                    tokens = tokens[0]
                if isinstance(tokens, (list, tuple)):
                    try:
                        affinity_key = prefix_key(
                            [int(t) for t in tokens],
                            router.block_size,
                            router.affinity_blocks)
                    except (TypeError, ValueError):
                        affinity_key = None
        router.proxy(self, path, body, rid,
                     affinity_key=affinity_key, stream=stream)
