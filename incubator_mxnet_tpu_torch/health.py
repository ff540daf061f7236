"""The health plane of the port (counterpart of
``incubator_mxnet_tpu/health.py``): device-side training and decode
statistics, surfaced without a host sync on the hot path.

Training half:

* :func:`train_step_health` — per-leaf gradient L2 norms, the per-leaf
  finite mask derived from them, update/weight ratios ||w' - w|| /
  (||w|| + eps) and the global gradient norm and the loss, all fp32.
* :class:`StepStats` — the same statistics as extra outputs of a train
  step written into one static device buffer, one row per inner step, so a
  captured step (or a CompiledLoop chunk of k steps) writes them at every
  replay.  JAX keeps the stats out of the update's arithmetic with
  ``optimization_barrier``; in the port the update is kernel K8, K9 or K10,
  which read the raw gradients and write the weights in place, so
  :meth:`StepStats.before` copies every leaf into a static buffer before
  the update and :meth:`StepStats.after` subtracts the new weights from
  that copy.  The stats only read what the step writes: the weights come
  out bit for bit as with the plane off.
* :class:`HealthMonitor` — the host companion: :meth:`~HealthMonitor.
  submit` copies one dispatch's stat rows to pinned host memory (a
  non-blocking copy behind a recorded CUDA event) and folds whatever has
  already landed (``Event.query()``, the counterpart of JAX's
  ``is_ready()``); :meth:`~HealthMonitor.sync` waits (boundary use).
  Folding fills :data:`telemetry.health_ring`, the ``mxtpu_health_*``
  series and the detectors: loss spike and grad-norm explosion against
  rolling windows (``MXNET_HEALTH_SPIKE_FACTOR``,
  ``MXNET_HEALTH_GRADNORM_FACTOR``, ``MXNET_HEALTH_WINDOW``) and a
  non-finite step naming its first non-finite leaf.  Every anomaly
  publishes the HEALTH topic, bumps ``mxtpu_health_anomalies`` and fires a
  debounced FAULT ``event="anomaly"`` (one flight dump per incident).

Serving half:

* :func:`decode_health` — per-slot logit max, softmax entropy and a
  finite check of the final-position logits, computed inside the serving
  engine's decode and burst bodies as extra outputs (on the card they are
  part of the captured CUDA graphs).  They read the logits after the
  sampling ops have read them and write tensors of their own, so the
  tokens are the same with the plane on as with it off, bit for bit.
* :func:`serving_anomaly` — the continuous batcher turns a non-finite
  row into a ``nonfinite_generation`` anomaly naming the implicated
  request ids.

:func:`report` is the ``GET /health`` body over both halves.
``MXNET_HEALTH_PLANE`` (default off) is read when a trainer or an engine
is built."""
from __future__ import annotations

import threading
import time as _time
import weakref as _weakref
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as _np

from .base import getenv_bool, getenv_float, getenv_int
from . import telemetry as _telemetry
from . import telemetry_ring as _ring

__all__ = ["enabled", "window_size", "spike_factor", "gradnorm_factor",
           "train_step_health", "StepStats", "unpack", "decode_health",
           "HealthMonitor", "serving_anomaly", "sync", "last_anomaly",
           "report", "reset"]

#: anomalies of one kind re-fire the FAULT dump trigger at most once per
#: this many seconds (a NaN plateau flags every step: one incident, one
#: artifact)
_FAULT_DEBOUNCE_S = 5.0

#: spike detection needs this many finite in-window samples first
_MIN_WINDOW = 8

#: the update ratio's denominator guard
_EPS = 1e-12

def enabled() -> bool:
    """``MXNET_HEALTH_PLANE``: compute the health stats in the train steps
    and the serving programs (default off)."""
    return getenv_bool("MXNET_HEALTH_PLANE", False)


def window_size() -> int:
    """``MXNET_HEALTH_WINDOW``: rolling-window length (steps) of the
    loss-spike and grad-explosion baselines."""
    return max(2, getenv_int("MXNET_HEALTH_WINDOW", 32))


def spike_factor() -> float:
    """``MXNET_HEALTH_SPIKE_FACTOR``: loss > factor x window mean flags a
    ``loss_spike`` anomaly."""
    return getenv_float("MXNET_HEALTH_SPIKE_FACTOR", 4.0)


def gradnorm_factor() -> float:
    """``MXNET_HEALTH_GRADNORM_FACTOR``: global grad norm > factor x
    window mean flags a ``grad_norm_explosion`` anomaly."""
    return getenv_float("MXNET_HEALTH_GRADNORM_FACTOR", 10.0)


def _anomalies():
    return _telemetry.counter(
        "mxtpu_health_anomalies",
        "training/decode anomalies the health plane detected, by kind")


# ---------------------------------------------------------------------------
# The stats (device side)
# ---------------------------------------------------------------------------
def _norms(leaves):
    """fp32 L2 norm of every leaf, stacked: (n,)."""
    import torch
    if not leaves:
        return torch.zeros(0, dtype=torch.float32)
    return torch.stack(torch._foreach_norm([x.float() for x in leaves]))


def _global(norms):
    """The global L2 norm from the per-leaf norms."""
    return norms.square().sum().sqrt()


def train_step_health(grads: Sequence, weights: Sequence,
                      new_weights: Sequence, loss=None) -> Dict[str, object]:
    """Per-leaf health stats over aligned leaf lists (tensors), all fp32:

    * ``grad_norms``    (n,) L2 norm of each raw gradient;
    * ``finite``        (n,) derived from the norms: NaN and Inf
      propagate through the sum of squares, so a leaf is flagged iff its
      norm is not finite;
    * ``update_ratios`` (n,) ||w' - w|| / (||w|| + eps): 0 on a skipped
      step, the signature of a frozen leaf;
    * ``grad_norm``     () global L2 norm;
    * ``loss``          () when ``loss`` is given.

    A pure function of its inputs (the reference the in-step
    :class:`StepStats` is held to)."""
    import torch
    norms = _norms(list(grads))
    diffs = [nw.float() - w.float() for w, nw in zip(weights, new_weights)]
    ratios = _norms(diffs) / (_norms(list(weights)) + _EPS)
    out = {"grad_norms": norms, "finite": torch.isfinite(norms),
           "update_ratios": ratios, "grad_norm": _global(norms)}
    if loss is not None:
        out["loss"] = torch.as_tensor(loss).detach().float().reshape(())
    return out


class StepStats:
    """The stats of ``rows`` consecutive steps of one trainer as extra
    outputs of its step, in one static fp32 device buffer (so a dispatch's
    stats reach the host in one copy): per row the gradient norms, the
    finite mask (1.0 or 0.0) and the update ratios (n each), then the
    global norm and the loss.  ``before(row, ws, grads)`` (ahead of the
    update) copies the weights into ``old`` and writes the gradient
    norms; ``after(row, ws, loss)`` (behind it) writes the update ratios
    and the loss.  Inside a captured step the writes are part of the graph
    and repeat at every replay.  Costs one copy of the weights in
    memory, at each leaf's dtype; a step that promotes the weights (a
    cast net's first step under a promoting rule, never captured) takes
    its ratios in fp32 and the next step's copy follows the new
    dtypes."""

    def __init__(self, params: Sequence, rows: int = 1, loss: bool = True):
        import torch
        dev = params[0].device
        n = len(params)
        self.rows, self.n = int(rows), n
        self.shapes = [tuple(p.shape) for p in params]
        self.buffer = torch.zeros((rows, 3 * n + 1 + bool(loss)),
                                  dtype=torch.float32, device=dev)
        self.old = [torch.empty_like(p) for p in params]
        self._wnorm = torch.zeros(n, dtype=torch.float32, device=dev)

    def before(self, row: int, ws, grads) -> None:
        import torch
        n, r = self.n, self.buffer[row]
        if any(o.dtype != w.dtype for o, w in zip(self.old, ws)):
            self.old = [torch.empty_like(w) for w in ws]
        with torch.no_grad():
            norms = _norms(list(grads))
            r[:n].copy_(norms)
            r[n:2 * n].copy_(torch.isfinite(norms))
            r[3 * n].copy_(_global(norms))
            self._wnorm.copy_(_norms(list(ws)))
            torch._foreach_copy_(self.old, list(ws))

    def after(self, row: int, ws, loss=None) -> None:
        import torch
        n, r = self.n, self.buffer[row]
        with torch.no_grad():
            if any(o.dtype != w.dtype for o, w in zip(self.old, ws)):
                # a promoted step: the difference in fp32, as
                # train_step_health takes it
                diffs = [o.float() - w.float() for o, w in zip(self.old, ws)]
            else:
                # old - new: the same magnitudes as new - old, bit for bit
                torch._foreach_sub_(self.old, list(ws))
                diffs = self.old
            r[2 * n:3 * n].copy_(_norms(diffs) / (self._wnorm + _EPS))
            if loss is not None:
                r[3 * n + 1].copy_(loss.detach().float().reshape(()))

    def rows_of(self, k: int) -> Dict[str, object]:
        """The first ``k`` rows, as :meth:`HealthMonitor.submit` takes
        them: ``{"packed": (k, 3n + 2) view}`` (3n + 1 without the
        loss)."""
        return {"packed": self.buffer[:k]}


def unpack(packed, n: int) -> Dict[str, _np.ndarray]:
    """A (k, 3n + 2) packed stat block (3n + 1 without the loss) as
    :func:`train_step_health`'s fields, each with a leading k axis."""
    p = _np.asarray(packed)
    out = {"grad_norms": p[:, :n], "finite": p[:, n:2 * n] > 0.5,
           "update_ratios": p[:, 2 * n:3 * n], "grad_norm": p[:, 3 * n]}
    if p.shape[1] > 3 * n + 1:
        out["loss"] = p[:, 3 * n + 1]
    return out


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


# ---------------------------------------------------------------------------
# Host side: drain, fold, detect
# ---------------------------------------------------------------------------
_lock = threading.Lock()
_monitors: List["_weakref.ref"] = []
_last_anomaly: Optional[dict] = None
_serving_fault: Dict[str, float] = {}


def _register(mon: "HealthMonitor") -> None:
    with _lock:
        _monitors[:] = [r for r in _monitors if r() is not None]
        _monitors.append(_weakref.ref(mon))


def sync() -> None:
    """Wait until every live monitor's pending stats are folded: the ring
    exact, the detectors caught up.  For checkpoint and eval boundaries;
    the training loop never needs it."""
    with _lock:
        refs = list(_monitors)
    for r in refs:
        mon = r()
        if mon is not None:
            mon.sync()


def last_anomaly() -> Optional[dict]:
    """The most recent anomaly (any monitor, or serving), or None."""
    return _last_anomaly


def reset() -> None:
    """Forget the last anomaly and every debounce state (test hygiene;
    live monitors and the ring survive: clear the ring with
    ``telemetry.health_ring.clear()``)."""
    global _last_anomaly
    with _lock:
        refs = list(_monitors)
        _last_anomaly = None
        _serving_fault.clear()
    for r in refs:
        mon = r()
        if mon is not None:
            mon._last_fault.clear()


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


class HealthMonitor:
    """Per-trainer host companion of the in-step stats.

    ``submit(step0, k, stats)`` queues one dispatch's stat rows (``k``
    inner steps, the first being step ``step0 + 1``) and folds whatever
    has already landed; it never waits.  ``sync()`` waits (boundary use).
    Folding a record updates the StepHealth ring, the ``mxtpu_health_*``
    series and the anomaly detectors."""

    def __init__(self, leaf_names: Sequence[str], src: str = "trainer"):
        self.names = [str(n) for n in leaf_names]
        self.src = str(src)
        self._pending: List[tuple] = []
        n = window_size()
        self._loss_win: deque = deque(maxlen=n)
        self._gnorm_win: deque = deque(maxlen=n)
        self._last_fault: Dict[str, float] = {}
        _register(self)

    # -- drain ----------------------------------------------------------
    def submit(self, step0: int, k: int, stats: Dict[str, object]) -> None:
        from .cuda_graphs import HostCopy
        names = list(stats)
        self._pending.append((int(step0), int(k), names,
                              HostCopy(*(stats[n] for n in names))))
        self.drain(block=False)

    def drain(self, block: bool = False) -> None:
        rest = []
        for step0, k, names, copy in self._pending:
            if block or copy.ready():
                self._fold(step0, k, {n: t.numpy() for n, t in
                                      zip(names, copy.wait())})
            else:
                rest.append((step0, k, names, copy))
        self._pending = rest

    def sync(self) -> None:
        self.drain(block=True)

    # -- folding and detection (off the hot path) ---------------------
    def _fold(self, step0: int, k: int, host: Dict[str, _np.ndarray]):
        n = len(self.names)
        if "packed" in host:
            host = unpack(_np.asarray(host["packed"]).reshape(k, -1), n)
        fins = _np.asarray(host["finite"]).reshape(k, n)
        upds = _np.asarray(host["update_ratios"]).reshape(k, n)
        gnorm = _np.asarray(host["grad_norm"]).reshape(k)
        loss = _np.asarray(host["loss"]).reshape(k) if "loss" in host \
            else None
        for i in range(k):
            step = step0 + 1 + i
            fin_row = fins[i]
            all_fin = bool(fin_row.all())
            rec = {
                "step": step,
                "src": self.src,
                "loss": float(loss[i]) if loss is not None else None,
                "grad_norm": float(gnorm[i]),
                "max_update_ratio": float(upds[i].max()) if n else 0.0,
                "finite": all_fin,
            }
            if not all_fin:
                rec["nonfinite_leaf"] = self.names[int(_np.argmin(fin_row))]
            _telemetry.health_ring.record(rec)
            self._publish_metrics(rec)
            self._detect(rec)

    def _publish_metrics(self, rec: dict) -> None:
        _telemetry.counter(
            "mxtpu_health_steps",
            "train steps folded into the StepHealth ring "
            "(health plane on)").inc(src=self.src)
        _telemetry.gauge(
            "mxtpu_health_grad_norm",
            "global gradient L2 norm of the most recent drained "
            "step").set(rec["grad_norm"], src=self.src)
        _telemetry.gauge(
            "mxtpu_health_update_ratio_max",
            "largest per-leaf ||dw||/||w|| of the most recent drained "
            "step (0 = guard-skipped or frozen)").set(
            rec["max_update_ratio"], src=self.src)
        if rec["loss"] is not None:
            _telemetry.gauge(
                "mxtpu_health_loss",
                "training loss of the most recent drained step").set(
                rec["loss"], src=self.src)

    def _detect(self, rec: dict) -> None:
        step = rec["step"]
        if not rec["finite"]:
            leaf = rec.get("nonfinite_leaf")
            self._anomaly("nonfinite", step, rec, leaf=leaf,
                          detail=f"first non-finite gradient leaf "
                                 f"{leaf!r} at step {step}")
            # a non-finite step must not poison the rolling baselines
            return
        loss, gnorm = rec["loss"], rec["grad_norm"]
        if loss is not None and _np.isfinite(loss) \
                and len(self._loss_win) >= _MIN_WINDOW:
            mean = sum(self._loss_win) / len(self._loss_win)
            if mean > 0 and loss > spike_factor() * mean:
                self._anomaly(
                    "loss_spike", step, rec,
                    detail=f"loss {loss:.4g} > {spike_factor():g}x "
                           f"rolling mean {mean:.4g}")
        if _np.isfinite(gnorm) and len(self._gnorm_win) >= _MIN_WINDOW:
            mean = sum(self._gnorm_win) / len(self._gnorm_win)
            if mean > 0 and gnorm > gradnorm_factor() * mean:
                self._anomaly(
                    "grad_norm_explosion", step, rec,
                    detail=f"grad norm {gnorm:.4g} > "
                           f"{gradnorm_factor():g}x rolling mean "
                           f"{mean:.4g}")
        if loss is not None and _np.isfinite(loss):
            self._loss_win.append(float(loss))
        if _np.isfinite(gnorm):
            self._gnorm_win.append(float(gnorm))

    def _anomaly(self, kind: str, step: int, rec: dict,
                 leaf: Optional[str] = None, detail: str = "") -> None:
        global _last_anomaly
        info = {"kind": kind, "step": step, "src": self.src,
                "leaf": leaf, "detail": detail, "record": dict(rec),
                "time_unix": round(_time.time(), 3)}
        with _lock:
            _last_anomaly = info
        _anomalies().inc(kind=kind, src=self.src)
        _telemetry.HEALTH.publish(**info)
        now = _time.monotonic()
        if now - self._last_fault.get(kind, -1e9) < _FAULT_DEBOUNCE_S:
            return
        self._last_fault[kind] = now
        # the flight recorder maps event="anomaly" to one debounced
        # training_anomaly dump; its "health" provider carries the leaf
        # and step attribution and the ring tail
        _telemetry.FAULT.publish(site=f"health.{self.src}",
                                 event="anomaly", kind=kind, step=step,
                                 leaf=leaf)


# ---------------------------------------------------------------------------
# Reporting (GET /health, mxtpu-stats-torch --health, flight dumps)
# ---------------------------------------------------------------------------
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
    """The ``health`` section of every flight dump: for a
    ``training_anomaly`` dump the forensics (the offending leaf and step,
    the last StepHealth records, the dispatch ledger)."""
    return {
        "last_anomaly": _last_anomaly,
        "ring": _telemetry.health_ring.entries(last=32),
        "dispatch_ledger": _telemetry.dispatch_ledger(),
    }


_ring.recorder.register_provider("health", _flight_provider)
