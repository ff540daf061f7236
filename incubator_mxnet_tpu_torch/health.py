"""The health plane of the port, serving part (counterpart of
``incubator_mxnet_tpu/health.py``).

* :func:`decode_health` — per-slot logit max, softmax entropy and a
  finite check of the final-position logits, computed inside the serving
  engine's decode and burst bodies as extra outputs (on the card they are
  part of the captured CUDA graphs).  They read the logits after the
  sampling ops have read them and write tensors of their own, so the
  tokens are the same with the plane on as with it off, bit for bit.
* :func:`serving_anomaly` — the continuous batcher turns a non-finite
  row into a ``nonfinite_generation`` anomaly naming the implicated
  request ids: HEALTH topic, ``mxtpu_health_anomalies`` and a debounced
  FAULT ``event="anomaly"`` (one flight dump per incident).
* :func:`report` — the ``GET /health`` body.

``MXNET_HEALTH_PLANE`` (default off) is read when an engine is built.
The training half (``train_step_health`` and its monitor) is not ported
yet."""
from __future__ import annotations

import threading
import time as _time
from typing import Optional, Sequence

from .base import getenv_bool
from . import telemetry as _telemetry
from . import telemetry_ring as _ring

__all__ = ["enabled", "decode_health", "serving_anomaly", "report",
           "reset"]

#: anomalies of one kind re-fire the FAULT dump trigger at most once per
#: this many seconds (a NaN plateau flags every step: one incident, one
#: artifact)
_FAULT_DEBOUNCE_S = 5.0

_lock = threading.Lock()
_last_anomaly: Optional[dict] = None
_serving_fault: dict = {}


def enabled() -> bool:
    """``MXNET_HEALTH_PLANE``: compute the decode health stats in the
    serving programs (default off)."""
    return getenv_bool("MXNET_HEALTH_PLANE", False)


def _anomalies():
    return _telemetry.counter(
        "mxtpu_health_anomalies",
        "training/decode anomalies the health plane detected, by kind")


def decode_health(logits):
    """Per-row health of last-position logits (S, V): ``(logit_max (S,),
    entropy (S,) in nats, finite (S,) bool)``, in fp32."""
    import torch
    lg = logits.float()
    m = lg.amax(dim=-1)
    z = lg - m[..., None]
    e = torch.exp(z)
    s = e.sum(dim=-1)
    ent = torch.log(s) - (e * z).sum(dim=-1) / s
    fin = torch.isfinite(lg).all(dim=-1)
    return m, ent, fin


def reset() -> None:
    """Forget the last anomaly and the debounce state (test hygiene)."""
    global _last_anomaly
    with _lock:
        _last_anomaly = None
        _serving_fault.clear()


def serving_anomaly(model: str, step: int, request_ids: Sequence[str],
                    detail: str = "") -> None:
    """Record a ``nonfinite_generation`` anomaly: a decode dispatch gave
    non-finite final-position logits for the implicated requests."""
    global _last_anomaly
    kind = "nonfinite_generation"
    info = {"kind": kind, "step": int(step), "src": str(model),
            "leaf": None, "request_ids": [str(r) for r in request_ids],
            "detail": detail or f"non-finite decode logits for "
                                f"{len(request_ids)} request(s)",
            "time_unix": round(_time.time(), 3)}
    with _lock:
        _last_anomaly = info
    _anomalies().inc(kind=kind, src=str(model))
    _telemetry.HEALTH.publish(**info)
    now = _time.monotonic()
    key = f"{model}:{kind}"
    with _lock:
        if now - _serving_fault.get(key, -1e9) < _FAULT_DEBOUNCE_S:
            return
        _serving_fault[key] = now
    _telemetry.FAULT.publish(site=f"health.{model}", event="anomaly",
                             kind=kind, step=int(step),
                             request_ids=list(info["request_ids"]))


def report(last: int = 16) -> dict:
    """JSON-ready health summary: detector status, anomaly counts, the
    last anomaly and the StepHealth ring tail (the reference's keys)."""
    anom = _anomalies().sample()
    if isinstance(anom, dict):
        total = float(anom.get("total", 0.0))
        by = dict(anom.get("by", {}))
    else:
        total = float(anom)
        by = {}
    return {
        "enabled": enabled(),
        "status": "anomalous" if total else "ok",
        "anomaly_total": total,
        "anomalies": by,
        "last_anomaly": _last_anomaly,
        "ring": _telemetry.health_ring.entries(last=last),
        "ring_depth": len(_telemetry.health_ring),
    }


def _flight_provider() -> dict:
    """The ``health`` section of every flight dump."""
    return {
        "last_anomaly": _last_anomaly,
        "ring": _telemetry.health_ring.entries(last=32),
        "dispatch_ledger": _telemetry.dispatch_ledger(),
    }


_ring.recorder.register_provider("health", _flight_provider)
