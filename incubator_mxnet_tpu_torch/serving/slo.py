"""Per-model SLO accounting — rolling-window SLIs, error budget, and
burn rate for the serving plane (a copy of
``incubator_mxnet_tpu/serving/slo.py``).

Counters say how many requests failed; an operator paging decision
needs *rates against an objective*.  This module keeps, per model, a
bounded rolling window of request outcomes (ok/failed + end-to-end
latency, recorded by ``DynamicBatcher.submit``) and derives the two
SLIs the serving plane promises:

* **availability** — fraction of requests in the window that returned
  a result (anything raised — 429 backpressure, 503 breaker/abort,
  504 deadline, 500 dispatch errors — counts against it; 4xx client
  errors never reach the batcher, so they never burn budget).
* **latency** — the window's p99 versus the objective
  ``MXNET_SERVE_SLO_P99_MS``.
* **token latency** (generation models) — p99 of per-token emission
  gaps versus ``MXNET_SERVE_SLO_TOKEN_P99_MS``.  End-to-end latency is
  the wrong SLI for a streamed response: a 200-token request that
  stalls 5 s mid-stream can still post a fine total.  The continuous
  batcher records every inter-token gap here, so decode-loop stalls
  (slot contention, a wedged dispatch riding retry) burn budget even
  when requests eventually finish.

Each SLI yields a **burn rate** — how fast the error budget is being
spent, where 1.0 means "exactly consuming the budget the objective
allows" (the Google SRE workbook convention):

* availability burn = (bad/total) / (1 − availability_objective)
* latency burn = fraction of requests slower than the p99 objective
  / 0.01 (an SLO of "p99 under X" budgets 1% of requests over X)

``burn_rate`` is the worst of the applicable burns;
``error_budget_remaining = clamp(1 − burn_rate, 0, 1)``; the budget is
*exhausted* once burn ≥ 1 with at least ``MXNET_SERVE_SLO_MIN_REQUESTS``
requests observed (a floor so one failed canary request cannot flip
``/readyz``).  Exhaustion shows up as a ``slo:<model>`` blocker in
``ModelServer.readiness()`` → ``/readyz`` 503, taking the replica out
of the balancer rotation until the window recovers.

Exported: ``mxtpu_slo_availability``, ``mxtpu_slo_p99_seconds``,
``mxtpu_slo_burn_rate``, ``mxtpu_slo_error_budget_remaining`` gauges
(per model) plus the ``mxtpu_slo_bad_requests`` counter; the full
JSON view is ``GET /slo`` and ``mxtpu-stats --slo``.

Knobs (docs/env_var.md): ``MXNET_SERVE_SLO_AVAILABILITY`` (objective,
default 0.999), ``MXNET_SERVE_SLO_P99_MS`` (latency objective in ms,
default 0 → latency SLO off), ``MXNET_SERVE_SLO_TOKEN_P99_MS``
(per-token gap objective in ms, default 0 → token SLO off),
``MXNET_SERVE_SLO_WINDOW`` (window size in requests, default 512),
``MXNET_SERVE_SLO_MIN_REQUESTS`` (readiness floor, default 10).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

from ..base import getenv, getenv_int
from . import metrics as _m

__all__ = ["ModelSLO", "SLOTracker", "tracker", "merge_snapshots",
           "objective_availability", "objective_p99_ms",
           "objective_token_p99_ms", "default_window", "min_requests"]


def objective_availability() -> float:
    """``MXNET_SERVE_SLO_AVAILABILITY``: availability objective in
    [0, 1) — e.g. 0.999 budgets 0.1% failed requests."""
    return float(getenv("MXNET_SERVE_SLO_AVAILABILITY", 0.999))


def objective_p99_ms() -> float:
    """``MXNET_SERVE_SLO_P99_MS``: p99 latency objective in
    milliseconds; 0 disables the latency SLI."""
    return float(getenv("MXNET_SERVE_SLO_P99_MS", 0.0))


def objective_token_p99_ms() -> float:
    """``MXNET_SERVE_SLO_TOKEN_P99_MS``: p99 inter-token gap objective
    in milliseconds for generation models; 0 disables the token SLI."""
    return float(getenv("MXNET_SERVE_SLO_TOKEN_P99_MS", 0.0))


def default_window() -> int:
    """``MXNET_SERVE_SLO_WINDOW``: rolling window size in requests."""
    return getenv_int("MXNET_SERVE_SLO_WINDOW", 512)


def min_requests() -> int:
    """``MXNET_SERVE_SLO_MIN_REQUESTS``: observations required before
    an exhausted budget may block readiness."""
    return getenv_int("MXNET_SERVE_SLO_MIN_REQUESTS", 10)


class ModelSLO:
    """Rolling window of (ok, latency) outcomes for one model."""

    def __init__(self, model: str, window: Optional[int] = None):
        self.model = str(model)
        size = max(1, int(window or default_window()))
        self._window = deque(maxlen=size)
        # inter-token emission gaps (generation models); one request
        # contributes many samples, so give gaps their own window
        # rather than crowding request outcomes out of the budget math
        self._token_window = deque(maxlen=size)
        self._lock = threading.Lock()

    def record_token(self, gap_seconds: float) -> None:
        """Fold one inter-token emission gap into the token window
        (recorded by ``ContinuousBatcher`` per emitted token).  Gauges
        refresh on the next :meth:`record` — per-token gauge updates
        would cost a sort per decode step per slot.

        Under speculative decoding tokens arrive in bursts of 1..k+1
        per verify dispatch: the first token of a burst carries the
        whole step's latency and the rest land with near-zero gaps.
        That is exactly what a streaming client observes, so the
        token-latency SLI keeps the raw gaps — a p99 over them rewards
        high accept rates instead of hiding them."""
        with self._lock:
            self._token_window.append(float(gap_seconds))

    def record(self, latency_seconds: float, ok: bool) -> None:
        """Fold one request outcome into the window and refresh the
        ``mxtpu_slo_*`` gauges (a sort of ≤ window samples — cheap next
        to a batched dispatch)."""
        with self._lock:
            self._window.append((bool(ok), float(latency_seconds)))
        if not ok:
            _m.SLO_BAD.inc(model=self.model)
        snap = self.snapshot()
        _m.SLO_AVAILABILITY.set(snap["availability"], model=self.model)
        if snap["p99_seconds"] is not None:
            _m.SLO_P99.set(snap["p99_seconds"], model=self.model)
        _m.SLO_BURN.set(snap["burn_rate"], model=self.model)
        _m.SLO_BUDGET.set(snap["error_budget_remaining"], model=self.model)

    def snapshot(self) -> dict:
        """JSON-ready SLI/burn/budget view of the current window."""
        with self._lock:
            window = list(self._window)
            token_window = list(self._token_window)
        total = len(window)
        bad = sum(1 for ok, _ in window if not ok)
        avail_obj = min(1.0, max(0.0, objective_availability()))
        p99_obj_s = max(0.0, objective_p99_ms()) / 1000.0
        tok_obj_s = max(0.0, objective_token_p99_ms()) / 1000.0
        out = {
            "model": self.model,
            "window": total,
            "bad": bad,
            "availability": 1.0 if total == 0 else (total - bad) / total,
            "availability_objective": avail_obj,
            "p99_seconds": None,
            "p99_objective_seconds": p99_obj_s or None,
            # absolute over-objective counts ride along so a federator
            # can recompute fleet burn from summed windows instead of
            # averaging per-replica rates (which over-weights idle
            # replicas)
            "slow": None,
            "token_window": len(token_window),
            "token_p99_seconds": None,
            "token_p99_objective_seconds": tok_obj_s or None,
            "token_slow": None,
            "burn_rate": 0.0,
            "error_budget_remaining": 1.0,
            "exhausted": False,
        }

        def _p99(samples):
            # same nearest-rank convention as telemetry.Histogram.stats()
            n = len(samples)
            return samples[min(n - 1, max(0, int(round(0.99 * (n - 1)))))]

        burns = []
        if token_window:
            gaps = sorted(token_window)
            out["token_p99_seconds"] = _p99(gaps)
            if tok_obj_s > 0.0:
                slow = sum(1 for g in token_window if g > tok_obj_s)
                out["token_slow"] = slow
                burns.append((slow / len(token_window)) / 0.01)
        if total == 0:
            # token-gap burn alone can spend budget, but readiness only
            # flips once enough whole requests have been observed
            out["burn_rate"] = max(burns) if burns else 0.0
            out["error_budget_remaining"] = \
                min(1.0, max(0.0, 1.0 - out["burn_rate"]))
            return out
        out["p99_seconds"] = _p99(sorted(lat for _, lat in window))
        if avail_obj < 1.0:
            burns.append((bad / total) / (1.0 - avail_obj))
        if p99_obj_s > 0.0:
            slow = sum(1 for _, lat in window if lat > p99_obj_s)
            out["slow"] = slow
            burns.append((slow / total) / 0.01)
        burn = max(burns) if burns else 0.0
        out["burn_rate"] = burn
        out["error_budget_remaining"] = min(1.0, max(0.0, 1.0 - burn))
        out["exhausted"] = burn >= 1.0 and total >= min_requests()
        return out


class SLOTracker:
    """Registry of :class:`ModelSLO` windows (one process-wide
    instance: :data:`tracker`)."""

    def __init__(self):
        self._models: Dict[str, ModelSLO] = {}
        self._lock = threading.Lock()

    def model(self, name: str) -> ModelSLO:
        name = str(name)
        m = self._models.get(name)
        if m is None:
            with self._lock:
                m = self._models.setdefault(name, ModelSLO(name))
        return m

    def record(self, name: str, latency_seconds: float, ok: bool) -> None:
        self.model(name).record(latency_seconds, ok)

    def record_token(self, name: str, gap_seconds: float) -> None:
        self.model(name).record_token(gap_seconds)

    def snapshot(self) -> dict:
        """``GET /slo`` body: every model's SLI/burn/budget view plus
        the shared objectives."""
        with self._lock:
            models = dict(self._models)
        return {
            "objectives": {
                "availability": objective_availability(),
                "p99_ms": objective_p99_ms() or None,
                "token_p99_ms": objective_token_p99_ms() or None,
                "window": default_window(),
                "min_requests": min_requests(),
            },
            "models": {name: m.snapshot() for name, m in models.items()},
        }

    def exhausted(self) -> Dict[str, dict]:
        """Models whose error budget is exhausted (→ readiness
        blockers)."""
        with self._lock:
            models = dict(self._models)
        out = {}
        for name, m in models.items():
            snap = m.snapshot()
            if snap["exhausted"]:
                out[name] = snap
        return out

    def reset(self) -> None:
        """Drop every window (test hygiene)."""
        with self._lock:
            self._models.clear()


tracker = SLOTracker()


def merge_snapshots(snapshots: Dict[str, Optional[dict]]) -> dict:
    """Fold per-replica ``tracker.snapshot()`` bodies (keyed by replica
    id) into the FLEET ``/slo`` view — the burn a user sees through the
    router.  Windows merge by summing absolute counts (window/bad/slow),
    so fleet burn is ``(Σbad/Σtotal)/(1−objective)`` rather than an
    average of per-replica burns: one replica failing 100% of its 10
    requests in a 1000-request fleet burns the fleet at 1%, not 50%.
    Fleet p99 is reported as the worst replica's p99 (windows don't
    carry raw latencies; the merged-histogram quantile lives on the
    federated ``/metrics``)."""
    per_model: Dict[str, Dict[str, dict]] = {}
    objectives: dict = {}
    for rid, snap in snapshots.items():
        if not snap:
            continue
        objectives = snap.get("objectives") or objectives
        for name, ms in (snap.get("models") or {}).items():
            per_model.setdefault(name, {})[rid] = ms

    def _sum(parts, key):
        vals = [p.get(key) for p in parts if p.get(key) is not None]
        return sum(vals) if vals else None

    models = {}
    for name, by_rep in per_model.items():
        parts = list(by_rep.values())
        total = int(_sum(parts, "window") or 0)
        bad = int(_sum(parts, "bad") or 0)
        slow = _sum(parts, "slow")
        tok_total = int(_sum(parts, "token_window") or 0)
        tok_slow = _sum(parts, "token_slow")
        avail_obj = next((p["availability_objective"] for p in parts
                          if p.get("availability_objective") is not None),
                         min(1.0, max(0.0, objective_availability())))
        burns = []
        if total and avail_obj < 1.0:
            burns.append((bad / total) / (1.0 - avail_obj))
        if total and slow is not None:
            burns.append((slow / total) / 0.01)
        if tok_total and tok_slow is not None:
            burns.append((tok_slow / tok_total) / 0.01)
        burn = max(burns) if burns else 0.0
        p99s = [p.get("p99_seconds") for p in parts
                if p.get("p99_seconds") is not None]
        tok_p99s = [p.get("token_p99_seconds") for p in parts
                    if p.get("token_p99_seconds") is not None]
        models[name] = {
            "model": name,
            "window": total,
            "bad": bad,
            "slow": slow,
            "availability": 1.0 if total == 0 else (total - bad) / total,
            "availability_objective": avail_obj,
            "p99_seconds_worst_replica": max(p99s) if p99s else None,
            "token_window": tok_total,
            "token_slow": tok_slow,
            "token_p99_seconds_worst_replica":
                max(tok_p99s) if tok_p99s else None,
            "burn_rate": burn,
            "error_budget_remaining": min(1.0, max(0.0, 1.0 - burn)),
            "exhausted": burn >= 1.0 and total >= min_requests(),
            "per_replica": {rid: {"window": p.get("window"),
                                  "bad": p.get("bad"),
                                  "burn_rate": p.get("burn_rate")}
                            for rid, p in sorted(by_rep.items())},
        }
    return {"fleet": True,
            "replicas": sorted(r for r, s in snapshots.items() if s),
            "objectives": objectives,
            "models": models}
