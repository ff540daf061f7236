"""The telemetry HTTP plane of the port (counterpart of
``incubator_mxnet_tpu/telemetry_http.py``): the body builders that the
model server's routes and the exporter share, and the live exporter
itself, a stdlib ``http.server`` on a daemon thread that
``mxtpu-stats-torch --serve`` runs beside a script:

* ``/metrics`` — Prometheus text of the registry;
* ``/metrics.json`` — :func:`metrics_state_body`: the registry's
  mergeable export;
* ``/healthz`` — liveness, collector state and uptime;
* ``/trace`` — :func:`trace_body`: the span tree, bounded: ``?limit=N``
  caps finished roots (default 32, max 256), ``?since=S`` keeps roots of
  the last S seconds, ``?request_id=RID`` looks up one request's spans;
* ``/flight`` — :func:`flight_body`: the flight recorder's postmortem
  payload, without writing a dump file;
* ``/slo`` — :func:`slo_body`: per-model SLO state once the serving
  plane is loaded (``{"objectives": {}, "models": {}}`` before).

:func:`start_server` binds it (port 0 picks an ephemeral port:
``server_address[1]``); :func:`stop_server` releases it."""
from __future__ import annotations

import json
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Optional

from .http_util import BaseJSONHandler, start_http_server, stop_http_server

__all__ = ["start_server", "stop_server", "server", "trace_body",
           "slo_body", "flight_body", "metrics_state_body"]

#: ``/trace`` bounds: default and hard cap for ``?limit=``
TRACE_DEFAULT_LIMIT = 32
TRACE_MAX_LIMIT = 256


def _param(params: dict, key: str) -> Optional[str]:
    vals = params.get(key)
    return vals[-1] if vals else None


def trace_body(params: dict) -> dict:
    """The bounded ``/trace`` response body.  ``params`` is a ``parse_qs`` dict;
    recognized: ``limit`` (finished roots, default 32, clamped to
    [0, 256]), ``since`` (seconds of lookback), ``request_id`` (span
    lookup by the ``request_id`` attr — returns the matching spans'
    subtrees instead of the whole forest)."""
    from . import telemetry
    rid = _param(params, "request_id")
    try:
        limit = int(_param(params, "limit") or TRACE_DEFAULT_LIMIT)
    except ValueError:
        limit = TRACE_DEFAULT_LIMIT
    limit = max(0, min(limit, TRACE_MAX_LIMIT))
    if rid:
        return {"request_id": rid,
                "spans": telemetry.tracer.find_spans(
                    "request_id", rid, limit=limit or TRACE_DEFAULT_LIMIT)}
    since = None
    raw_since = _param(params, "since")
    if raw_since:
        try:
            since = float(raw_since)
        except ValueError:
            since = None
    return telemetry.tracer.tree(max_finished=limit, since=since)


def flight_body(reason: str = "http") -> dict:
    """The ``/flight`` response body: the flight recorder's full
    postmortem payload (ring + metrics + providers) WITHOUT writing a
    dump file — the router pulls this view of an implicated replica into
    a fleet incident bundle."""
    from . import telemetry_ring
    return telemetry_ring.recorder.payload(reason)


def metrics_state_body() -> dict:
    """The ``/metrics.json`` response body: the registry's mergeable
    export (per-label counter/gauge values + raw histogram reservoirs),
    the feed behind the router's federated ``/metrics``."""
    from . import telemetry
    return telemetry.registry.export_state()


def slo_body() -> dict:
    """The ``/slo`` response body.  Reads the tracker only when the
    serving plane is already in ``sys.modules`` — a metrics exporter
    must never be the thing that imports torch/engine code."""
    slo = sys.modules.get("incubator_mxnet_tpu_torch.serving.slo")
    if slo is None:
        return {"objectives": {}, "models": {}}
    return slo.tracker.snapshot()


_server: Optional[ThreadingHTTPServer] = None
_t_start: Optional[float] = None
_lock = threading.Lock()


class _Handler(BaseJSONHandler):
    server_version = "mxtpu-telemetry/1.0"

    def do_GET(self):  # noqa: N802 (http.server API)
        self.guard(self._route)

    def _route(self):
        from urllib.parse import parse_qs, urlsplit
        from . import telemetry
        split = urlsplit(self.path)
        params = parse_qs(split.query)
        path = split.path.rstrip("/") or "/"
        if path in ("/metrics", "/"):
            self._send(200, telemetry.render_prometheus(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/metrics.json":
            self._send(200,
                       json.dumps(metrics_state_body(), default=str)
                       + "\n", "application/json")
        elif path == "/flight":
            self._send(200,
                       json.dumps(flight_body(), default=str) + "\n",
                       "application/json")
        elif path == "/healthz":
            self._send(200, json.dumps({
                "status": "ok",
                "collecting": telemetry.enabled(),
                "tracing": telemetry.tracer.active,
                "uptime_s": None if _t_start is None
                else round(time.time() - _t_start, 3),
            }) + "\n", "application/json")
        elif path == "/trace":
            self._send(200,
                       json.dumps(trace_body(params), indent=2,
                                  default=str) + "\n",
                       "application/json")
        elif path == "/slo":
            self._send(200,
                       json.dumps(slo_body(), default=str) + "\n",
                       "application/json")
        else:
            self._send(404, "not found: try /metrics /metrics.json "
                            "/healthz /trace /slo /flight\n",
                       "text/plain; charset=utf-8")


def start_server(port: int, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Start (or return the already running) exporter on ``host:port`` in
    a daemon thread.  Raises ``OSError`` if the port cannot be bound."""
    global _server, _t_start
    with _lock:
        if _server is not None:
            return _server
        srv = start_http_server(_Handler, port, host,
                                name="mxtpu-telemetry-http")
        _server, _t_start = srv, time.time()
        return srv


def stop_server() -> None:
    """Shut the exporter down and release the port (a no-op when idle)."""
    global _server, _t_start
    with _lock:
        srv = _server
        _server = _t_start = None
    stop_http_server(srv)


def server() -> Optional[ThreadingHTTPServer]:
    """The running exporter (``server_address[1]`` is the bound port), or
    None."""
    return _server
