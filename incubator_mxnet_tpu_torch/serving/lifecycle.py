"""Serving fault domains of the port (a copy of
``incubator_mxnet_tpu/serving/lifecycle.py``): the request errors, each
of which maps to one HTTP status, and the pieces that keep a replica
answering when a model misbehaves.

* **deadlines** — a request may carry an end-to-end budget
  (``timeout_ms``; env default ``MXNET_SERVE_TIMEOUT_MS``); crossing it at
  admission, in the queue or mid-decode raises :class:`DeadlineExceeded`
  (HTTP 504).
* **circuit breaker** — :class:`CircuitBreaker` per model: consecutive
  dispatch failures trip CLOSED -> OPEN, admission then fast-fails with
  :class:`BreakerOpen` (HTTP 503 + ``Retry-After``) until a half-open
  probe succeeds.
* **watchdog** — :class:`Watchdog` sweeps every batcher's worker: a dead
  one, or one stuck in a dispatch past ``MXNET_SERVE_HANG_SECONDS``, gets
  its riders failed (:class:`RequestAborted`, HTTP 503) and is replaced
  by a new worker generation.
* **readiness** — per-model states (:data:`SERVING`, :data:`STARTING`,
  :data:`DEGRADED`, :data:`UNHEALTHY`, :data:`DRAINING`) that
  ``GET /readyz`` aggregates.
* **SIGTERM-safe shutdown** — :func:`run_until_shutdown` parks the main
  thread until SIGTERM/SIGINT, then drains the server within
  ``MXNET_DRAIN_SECONDS``.
"""
from __future__ import annotations

import signal
import sys
import threading
import time
from typing import Callable, Iterable, Optional

from ..base import MXNetError, getenv
from .. import telemetry as _telemetry
from .. import telemetry_ring as _ring
from . import metrics as _m

__all__ = [
    # states
    "STARTING", "SERVING", "DEGRADED", "UNHEALTHY", "DRAINING",
    # errors
    "DeadlineExceeded", "BreakerOpen", "Draining", "RequestAborted",
    "Cancelled",
    # pieces
    "CircuitBreaker", "Watchdog",
    # deadline helpers
    "default_timeout_ms", "deadline_from_ms",
    # shutdown plumbing
    "install_signal_handler", "on_shutdown", "shutdown_requested",
    "request_shutdown", "reset_shutdown_state", "run_until_shutdown",
]

# -- model states -----------------------------------------------------------
STARTING = "STARTING"       # registered, warmup still compiling buckets
SERVING = "SERVING"         # healthy, taking traffic
DEGRADED = "DEGRADED"       # recovering (watchdog restart / half-open
#                             breaker) — still takes traffic, still ready
UNHEALTHY = "UNHEALTHY"     # breaker OPEN or worker dead — not ready
DRAINING = "DRAINING"       # shutting down — not ready, sheds new work

#: numeric encoding for the ``mxtpu_serve_model_state`` gauge
STATE_CODE = {SERVING: 0, STARTING: 1, DEGRADED: 2, UNHEALTHY: 3,
              DRAINING: 4}


# -- errors (each maps to one HTTP status in serving/server.py) -------------
class DeadlineExceeded(MXNetError):
    """The request's end-to-end deadline expired (HTTP 504)."""


class BreakerOpen(MXNetError):
    """The model's circuit breaker is OPEN — fast-fail instead of
    queueing onto a broken model (HTTP 503 + ``Retry-After``)."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = max(0.0, float(retry_after))


class Draining(MXNetError):
    """The server is draining: in-flight work finishes, new work is
    refused (HTTP 503 + ``Retry-After``)."""

    retry_after = 1.0


class RequestAborted(MXNetError):
    """The request was failed by the watchdog (dead/hung worker) or by
    a drain timeout — the server, not the request, was at fault, so the
    client should retry elsewhere (HTTP 503)."""

    retry_after = 1.0


class Cancelled(MXNetError):
    """The request was cancelled by its own client (streaming disconnect
    or explicit ``cancel()``) mid-generation — the slot frees on the
    next decode-step boundary.  Never surfaces as an HTTP error: the
    client that would receive it is gone."""


# -- deadlines --------------------------------------------------------------
def default_timeout_ms() -> float:
    """Env default for per-request deadlines (``MXNET_SERVE_TIMEOUT_MS``;
    0 disables — the PR-5 block-forever behavior)."""
    return float(getenv("MXNET_SERVE_TIMEOUT_MS", 0.0))


def deadline_from_ms(timeout_ms: Optional[float],
                     now: Optional[float] = None) -> Optional[float]:
    """Absolute ``time.monotonic`` deadline for a request budget, or
    None when the budget is absent/zero (deadline-free)."""
    if timeout_ms is None:
        timeout_ms = default_timeout_ms()
    timeout_ms = float(timeout_ms)
    if timeout_ms <= 0:
        return None
    return (time.monotonic() if now is None else now) + timeout_ms / 1000.0


# -- circuit breaker --------------------------------------------------------
CLOSED, HALF_OPEN, OPEN = "CLOSED", "HALF_OPEN", "OPEN"
_BREAKER_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Per-model CLOSED → OPEN → HALF_OPEN → CLOSED breaker.

    ``record_failure`` counts *consecutive* dispatch-after-retry
    failures (the batcher's single-request fallback path); reaching
    ``threshold`` of them — or an explicit :meth:`trip` from the
    watchdog — opens the breaker.  While OPEN, :meth:`allow` raises
    :class:`BreakerOpen` so admission fast-fails; after
    ``cooldown_seconds`` exactly ONE request is admitted as a probe
    (HALF_OPEN).  The probe's success re-closes the breaker; its failure
    re-opens it for another cooldown.

    Knobs: ``MXNET_SERVE_BREAKER_THRESHOLD`` (default 5 consecutive
    failures) and ``MXNET_SERVE_BREAKER_COOLDOWN_SECONDS`` (default 2).
    """

    def __init__(self, name: str, threshold: Optional[int] = None,
                 cooldown_seconds: Optional[float] = None):
        self.name = str(name)
        if threshold is None:
            threshold = int(float(getenv("MXNET_SERVE_BREAKER_THRESHOLD",
                                         5)))
        if cooldown_seconds is None:
            cooldown_seconds = float(
                getenv("MXNET_SERVE_BREAKER_COOLDOWN_SECONDS", 2.0))
        self.threshold = max(1, int(threshold))
        self.cooldown_seconds = max(0.0, float(cooldown_seconds))
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        _m.BREAKER_STATE.set(0, model=self.name)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def retry_after(self) -> float:
        """Seconds until the next probe will be admitted."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self._opened_at + self.cooldown_seconds
                       - time.monotonic())

    # -- transitions (callers hold no lock) -----------------------------
    def _to(self, state: str, reason: str) -> None:
        # _lock held by caller
        if state == self._state:
            return
        self._state = state
        _m.BREAKER_STATE.set(_BREAKER_CODE[state], model=self.name)
        _telemetry.FAULT.publish(site="serving.breaker", event="breaker",
                                 kind=state, model=self.name,
                                 reason=reason)

    def allow(self) -> None:
        """Admission gate: no-op when CLOSED; raises
        :class:`BreakerOpen` while OPEN (before the cooldown) and for
        every HALF_OPEN request beyond the single probe."""
        with self._lock:
            if self._state == CLOSED:
                return
            now = time.monotonic()
            if self._state == OPEN:
                if now - self._opened_at < self.cooldown_seconds:
                    raise BreakerOpen(
                        f"{self.name}: circuit breaker is OPEN",
                        retry_after=self._opened_at
                        + self.cooldown_seconds - now)
                self._to(HALF_OPEN, "cooldown elapsed")
                self._probing = False
            if self._probing:       # one probe at a time
                raise BreakerOpen(
                    f"{self.name}: circuit breaker is HALF_OPEN "
                    "(probe in flight)", retry_after=1.0)
            self._probing = True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._to(CLOSED, "probe succeeded")

    def record_failure(self, reason: str = "dispatch failed") -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == HALF_OPEN or self._failures >= self.threshold:
                self._open(reason)

    def trip(self, reason: str = "forced") -> None:
        """Force OPEN immediately (the watchdog's reaction to a hung or
        dead worker — no point counting to the threshold)."""
        with self._lock:
            self._open(reason)

    def _open(self, reason: str) -> None:
        # _lock held by caller
        self._opened_at = time.monotonic()
        self._failures = 0
        self._probing = False
        if self._state != OPEN:
            _m.BREAKER_TRIPS.inc(model=self.name)
        self._to(OPEN, reason)

    def __repr__(self):
        return (f"<CircuitBreaker {self.name!r}: {self.state}, "
                f"threshold={self.threshold}, "
                f"cooldown={self.cooldown_seconds}s>")


# -- watchdog ---------------------------------------------------------------
def default_hang_seconds() -> float:
    """``MXNET_SERVE_HANG_SECONDS`` (default 30; <= 0 disables hang
    detection — dead-worker detection stays on)."""
    return float(getenv("MXNET_SERVE_HANG_SECONDS", 30.0))


class Watchdog:
    """Background sweep over a set of batchers: each tick calls every
    batcher's ``check_worker(hang_seconds)``, which detects a dead or
    hung worker, fails that group's riders, restarts the worker and
    trips the breaker (see ``DynamicBatcher.check_worker``).

    Targets come from an explicit :meth:`watch` list and/or a
    ``supplier`` callable returning the current batchers — the
    ``ModelServer`` passes its live registry so models loaded after the
    watchdog started are covered without registration bookkeeping."""

    def __init__(self, supplier: Optional[Callable[[], Iterable]] = None,
                 hang_seconds: Optional[float] = None,
                 interval: Optional[float] = None):
        self.hang_seconds = default_hang_seconds() \
            if hang_seconds is None else float(hang_seconds)
        if interval is None:
            interval = min(1.0, max(0.05, self.hang_seconds / 4.0)) \
                if self.hang_seconds > 0 else 1.0
        self.interval = float(interval)
        self._supplier = supplier
        self._watched: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def watch(self, batcher) -> None:
        with self._lock:
            if batcher not in self._watched:
                self._watched.append(batcher)

    def unwatch(self, batcher) -> None:
        with self._lock:
            if batcher in self._watched:
                self._watched.remove(batcher)

    def _targets(self):
        with self._lock:
            targets = list(self._watched)
        if self._supplier is not None:
            try:
                for b in self._supplier():
                    if b not in targets:
                        targets.append(b)
            except Exception:
                pass
        return targets

    def start(self) -> "Watchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="mxtpu-serve-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    def sweep(self) -> list:
        """One synchronous pass; returns ``(batcher, reason)`` pairs for
        every restart performed (tests drive this directly)."""
        hits = []
        for b in self._targets():
            try:
                reason = b.check_worker(self.hang_seconds)
            except Exception:       # a broken batcher must not kill the
                continue            # sweep for the healthy ones
            if reason:
                hits.append((b, reason))
        return hits

    def _run(self):
        while not self._stop.wait(self.interval):
            self.sweep()
            # the watchdog tick doubles as the flight recorder's metrics
            # sampler: the ring gets a coarse counter-delta timeline
            # (rate-limited inside note_metrics) for free
            _ring.recorder.note_metrics()


# -- SIGTERM-safe shutdown plumbing -----------------------------------------
_shutdown_event = threading.Event()
_shutdown_lock = threading.Lock()
_shutdown_callbacks: list = []
_installed_signals: dict = {}


def default_drain_seconds() -> float:
    """``MXNET_DRAIN_SECONDS`` (default 10): the budget between the
    shutdown signal and the port closing."""
    return float(getenv("MXNET_DRAIN_SECONDS", 10.0))


def on_shutdown(fn: Callable[[], None]) -> Callable[[], None]:
    """Register ``fn`` to run (on the main thread, inside the signal
    handler) when a shutdown signal arrives.  Keep callbacks
    signal-safe: set events, flip flags — a training loop should poll
    :func:`shutdown_requested` at its step boundary and checkpoint
    there, never snapshot mid-step state from the handler itself."""
    with _shutdown_lock:
        _shutdown_callbacks.append(fn)
    return fn


def shutdown_requested() -> bool:
    """True once a shutdown signal (or :func:`request_shutdown`) fired."""
    return _shutdown_event.is_set()


def request_shutdown(signum: Optional[int] = None,
                     frame=None) -> None:
    """Flip the shutdown flag and run the registered callbacks.  Also
    the installed signal handler."""
    first = not _shutdown_event.is_set()
    _shutdown_event.set()
    if not first:
        return
    _telemetry.FAULT.publish(site="serving.lifecycle", event="shutdown",
                             kind="signal" if signum else "requested",
                             signum=signum)
    with _shutdown_lock:
        callbacks = list(_shutdown_callbacks)
    for fn in callbacks:
        try:
            fn()
        except SystemExit:
            raise
        except Exception:           # one bad callback must not eat the
            pass                    # drain for the rest


def install_signal_handler(signals=(signal.SIGTERM,
                                    signal.SIGINT)) -> None:
    """Install :func:`request_shutdown` for ``signals`` (idempotent;
    main thread only — the ``signal`` module's own constraint)."""
    for s in signals:
        if s in _installed_signals:
            continue
        _installed_signals[s] = signal.signal(s, request_shutdown)


def reset_shutdown_state() -> None:
    """Clear the flag/callbacks and restore the previous signal
    handlers (test hygiene)."""
    _shutdown_event.clear()
    with _shutdown_lock:
        _shutdown_callbacks.clear()
    for s, prev in list(_installed_signals.items()):
        try:
            signal.signal(s, prev)
        except (ValueError, TypeError, OSError):
            pass
        del _installed_signals[s]


def run_until_shutdown(server, drain_seconds: Optional[float] = None,
                       poll_seconds: float = 0.5) -> int:
    """Park the calling (main) thread until SIGTERM/SIGINT, then drain
    ``server`` gracefully: new work gets 503, ``/readyz`` flips before
    the port closes, in-flight requests finish within
    ``MXNET_DRAIN_SECONDS``.  Returns 0 (the process exit code)."""
    install_signal_handler()
    try:
        while not _shutdown_event.wait(poll_seconds):
            pass
    except KeyboardInterrupt:       # SIGINT delivered around the wait
        pass
    sys.stderr.write("mxtpu-serve-torch: shutdown signal — draining...\n")
    server.shutdown(drain_seconds=drain_seconds)
    sys.stderr.write("mxtpu-serve-torch: drained, exiting\n")
    return 0
