"""The telemetry HTTP bodies of the port (the body builders of
``incubator_mxnet_tpu/telemetry_http.py``), served by the model
server's routes:

* ``/trace`` — :func:`trace_body`: the span tree, bounded: ``?limit=N``
  caps finished roots (default 32, max 256), ``?since=S`` keeps roots of
  the last S seconds, ``?request_id=RID`` looks up one request's spans;
* ``/flight`` — :func:`flight_body`: the flight recorder's postmortem
  payload, without writing a dump file;
* ``/metrics.json`` — :func:`metrics_state_body`: the registry's
  mergeable export;
* ``/slo`` — :func:`slo_body`: per-model SLO state once the serving
  plane is loaded (``{"objectives": {}, "models": {}}`` before)."""
from __future__ import annotations

import sys
from typing import Optional

__all__ = ["trace_body", "slo_body", "flight_body", "metrics_state_body"]

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
