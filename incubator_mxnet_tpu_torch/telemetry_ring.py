"""Black-box flight recorder — the ring that remembers what the
process was doing in the seconds before an incident (a copy of
``incubator_mxnet_tpu/telemetry_ring.py``).

Counters tell an operator *that* something tripped
(``mxtpu_serve_watchdog_restarts`` went to 1); they never say what the
process was doing at the time.  This module keeps a lock-cheap bounded
ring of recent runtime activity — FAULT events, finished root spans,
metric deltas — continuously, whether or not anyone is watching, and
automatically writes a postmortem JSON ("flight dump") the moment one
of the incident triggers fires:

===================  =======================================
trigger              FAULT event that fires it
===================  =======================================
watchdog restart     ``event="watchdog"`` (dead/hung worker)
breaker trip         ``event="breaker", kind="OPEN"``
non-finite skip      ``event="skipped_step"``
SIGTERM drain        ``event="shutdown"``
worker crash         ``event="crash"``
device OOM           ``event="oom"`` (RESOURCE_EXHAUSTED dispatch)
training anomaly     ``event="anomaly"`` (health plane, health.py)
===================  =======================================

A dump is the ring contents plus a full metrics snapshot plus whatever
the registered *providers* contribute — the ``ModelServer`` registers
one reporting per-model lifecycle states and the request ids currently
queued/in-flight, so a hung request can be found in the artifact by the
same ``x-request-id`` the client holds (docs/observability.md).

The recorder is reference-counted: ``telemetry.start()`` and
``ModelServer.start()`` each hold one reference, so serving gets
postmortems even when nobody turned full telemetry on.  Recording costs
one deque append under a tiny lock per event; dumps run on a daemon
thread (triggers can fire while arbitrary locks are held) and are
budgeted per process so a flapping breaker cannot fill a disk.

Knobs (docs/env_var.md): ``MXNET_FLIGHT_RING`` (ring size, default 512;
0 disables the recorder), ``MXNET_FLIGHT_DUMP_DIR`` (default
``<tmpdir>/mxtpu_flight``), ``MXNET_FLIGHT_MAX_DUMPS`` (auto-dump
budget per process, default 8).
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .base import getenv, getenv_int
from . import telemetry as _telemetry

__all__ = ["FlightRecorder", "recorder", "default_ring_size",
           "default_dump_dir", "default_max_dumps"]


def default_ring_size() -> int:
    """``MXNET_FLIGHT_RING``: ring capacity in entries (0 disables)."""
    return getenv_int("MXNET_FLIGHT_RING", 512)


def default_dump_dir() -> str:
    """``MXNET_FLIGHT_DUMP_DIR``: where auto-dumps land."""
    return getenv("MXNET_FLIGHT_DUMP_DIR") \
        or os.path.join(tempfile.gettempdir(), "mxtpu_flight")


def default_max_dumps() -> int:
    """``MXNET_FLIGHT_MAX_DUMPS``: auto-dump budget per process."""
    return getenv_int("MXNET_FLIGHT_MAX_DUMPS", 8)


#: FAULT-event → dump-reason trigger matrix (see module docstring)
_TRIGGERS = {
    "watchdog": "watchdog_restart",
    "skipped_step": "nonfinite_skip",
    "shutdown": "sigterm_drain",
    "crash": "worker_crash",
    "oom": "resource_exhausted",
    "anomaly": "training_anomaly",
}


class FlightRecorder:
    """The bounded ring + dump machinery (one process-wide instance:
    :data:`recorder`)."""

    def __init__(self, size: Optional[int] = None):
        self._size = size
        self._ring: deque = deque(maxlen=size or default_ring_size() or 1)
        self._lock = threading.Lock()
        self._refs = 0
        self._providers: Dict[str, Callable[[], object]] = {}
        self._last_counters: Dict[str, float] = {}
        self._last_metrics_t = 0.0
        self._last_auto: Dict[str, float] = {}
        self._dump_seq = 0
        self._auto_dumps = 0
        self.last_dump_path: Optional[str] = None

    # -- lifecycle (refcounted: telemetry.start + ModelServer.start) ----
    def start(self) -> "FlightRecorder":
        """Attach to the FAULT and SPAN topics (idempotent per holder).
        A ring size of 0 (``MXNET_FLIGHT_RING=0``) disables recording
        entirely."""
        with self._lock:
            self._refs += 1
            if self._refs > 1:
                return self
            size = self._size if self._size is not None \
                else default_ring_size()
            if size <= 0:
                return self
            if self._ring.maxlen != size:
                self._ring = deque(self._ring, maxlen=size)
        _telemetry.FAULT.subscribe(self._on_fault, passive=True)
        _telemetry.SPAN.subscribe(self._on_span, passive=True)
        return self

    def stop(self) -> None:
        with self._lock:
            self._refs = max(0, self._refs - 1)
            if self._refs:
                return
        _telemetry.FAULT.unsubscribe(self._on_fault)
        _telemetry.SPAN.unsubscribe(self._on_span)

    @property
    def active(self) -> bool:
        return self._refs > 0

    def reset(self) -> None:
        """Drop the ring and restore the auto-dump budget (test
        hygiene; providers and subscriptions survive)."""
        with self._lock:
            self._ring.clear()
            self._last_counters = {}
            self._last_metrics_t = 0.0
            self._last_auto.clear()
            self._auto_dumps = 0
            self.last_dump_path = None

    # -- recording ------------------------------------------------------
    def _record(self, entry_type: str, **fields) -> None:
        # entry key is "type" — "kind" stays free for the fault kind
        entry = {"t": round(time.time(), 3), "type": entry_type}
        entry.update(fields)
        with self._lock:
            self._ring.append(entry)

    def _on_fault(self, site="?", event="?", kind=None, **kw) -> None:
        fields = {"site": site, "event": event}
        if kind is not None:
            fields["kind"] = kind
        for k, v in kw.items():
            if isinstance(v, (str, int, float, bool, list, tuple)) \
                    or v is None:
                fields[k] = v
        self._record("fault", **fields)
        reason = _TRIGGERS.get(event)
        if reason is None and event == "breaker" and kind == "OPEN":
            reason = "breaker_trip"
        if reason is not None:
            self._auto_dump(reason)

    def _on_span(self, span) -> None:
        # roots only (that is what the SPAN topic publishes) — the ring
        # keeps the headline, not the subtree; full trees stay on /trace
        fields = {"name": span.name, "cat": span.cat, "id": span.sid,
                  "seconds": span.seconds,
                  "children": len(span.children)}
        if span.attrs:
            fields["attrs"] = dict(span.attrs)
        self._record("span", **fields)

    def note_metrics(self, force: bool = False) -> None:
        """Fold the counter/gauge deltas since the last note into the
        ring (rate-limited to 1/s — the serving watchdog calls this on
        every sweep, so the ring carries a coarse metrics timeline)."""
        if not self.active:
            return
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_metrics_t < 1.0:
                return
            self._last_metrics_t = now
            last = self._last_counters
        try:
            flat = _telemetry.counters_flat()
        except Exception:
            return
        delta = {k: round(v - last.get(k, 0.0), 6)
                 for k, v in flat.items() if v != last.get(k, 0.0)}
        with self._lock:
            self._last_counters = flat
        if delta:
            self._record("metrics", delta=delta)

    # -- providers (extra state woven into every dump) ------------------
    def register_provider(self, name: str,
                          fn: Callable[[], object]) -> None:
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    def entries(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    # -- dumping --------------------------------------------------------
    def _auto_dump(self, reason: str) -> None:
        """Budgeted, debounced, async trigger path: a storm of breaker
        flaps costs at most one dump per second and
        ``MXNET_FLIGHT_MAX_DUMPS`` per process.  The debounce is
        per-reason: one incident often fires coupled triggers back to
        back (a watchdog restart trips the breaker in the same
        millisecond) and each deserves its artifact.  The write happens
        on a daemon thread because triggers fire from inside publish()
        — under breaker/batcher locks the providers will want."""
        now = time.monotonic()
        with self._lock:
            if not self._refs:
                return
            if self._auto_dumps >= default_max_dumps():
                return
            if now - self._last_auto.get(reason, -1e9) < 1.0:
                return
            self._last_auto[reason] = now
            self._auto_dumps += 1
        threading.Thread(target=self._dump_guarded, args=(reason,),
                         name="mxtpu-flight-dump", daemon=True).start()

    def _dump_guarded(self, reason: str) -> None:
        try:
            self.dump(reason)
        except Exception:               # the recorder must never take
            pass                        # the recorded program down

    def payload(self, reason: str) -> dict:
        """The postmortem document :meth:`dump` writes, as a dict: ring
        entries, a metrics snapshot, and every registered provider's
        state.  Served on replica ``GET /flight`` so a router can pull
        the implicated replica's view into a fleet incident bundle
        without touching the replica's disk."""
        self.note_metrics(force=True)
        payload = {
            "reason": reason,
            "time_unix": round(time.time(), 3),
            "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "pid": os.getpid(),
            "ring": self.entries(),
        }
        try:
            payload["metrics"] = _telemetry.snapshot(include_memory=False)
        except Exception as e:
            payload["metrics"] = {"error": repr(e)}
        with self._lock:
            providers = dict(self._providers)
        for name, fn in providers.items():
            try:
                payload[name] = fn()
            except Exception as e:      # a sick provider is itself data
                payload[name] = {"error": repr(e)}
        return payload

    def dump(self, reason: str, path: Optional[str] = None) -> str:
        """Write the postmortem JSON and return its path.  ``path=None``
        picks ``<dump_dir>/flight_<pid>_<seq>_<reason>.json``."""
        payload = self.payload(reason)
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        if path is None:
            d = default_dump_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight_{os.getpid()}_{seq:03d}_{reason}.json")
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, default=str)
            f.write("\n")
        os.replace(tmp, path)           # readers never see a torn dump
        self.last_dump_path = path
        return path


recorder = FlightRecorder()
