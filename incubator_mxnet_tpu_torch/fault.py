"""Deterministic fault injection and retry with jittered exponential
backoff (a copy of ``incubator_mxnet_tpu/fault.py``; the port keeps its
own so that it never imports the JAX package).

* **Fault plan** — a schedule of injected faults at named sites
  (``MXNET_FAULT_PLAN``, or :func:`install_plan`).  The serving sites are
  ``serving.queue`` (polled at submit) and ``serving.infer`` (polled
  before every engine dispatch).  Kinds: ``ioerror`` (raise a transient
  :class:`FaultInjected`), ``latency`` (sleep), ``nonfinite`` (a
  numeric-site kind: no serving site consumes it), ``hang`` (a long stall, default
  3600 s: the serving watchdog's drill) and ``crash`` (``os._exit`` with
  a configurable code).  Each site keeps a call counter and a rule names
  the 1-based calls it fires on::

      rule  := site ":" kind [":" arg] ["@" calls]
      calls := N | N-M | "every=" K          (default: 1)

      MXNET_FAULT_PLAN="serving.infer:ioerror@2;serving.queue:latency:0.05@1-3"

* **Retry** — :func:`retry_call` absorbs transient failures with backoff
  under a wall-clock deadline (:class:`RetryPolicy`; ``MXNET_RETRY_MAX``,
  ``MXNET_RETRY_BASE_SECONDS``, ``MXNET_RETRY_DEADLINE_SECONDS``).

Every injection, retry and give-up is published on the telemetry
``FAULT`` topic (``mxtpu_faults_injected`` / ``mxtpu_retries`` /
``mxtpu_giveups`` while the collector runs)."""
from __future__ import annotations

import random as _pyrandom
import threading
import time as _time
from typing import Dict, List, Optional

from .base import MXNetError, getenv
from . import telemetry as _telemetry

__all__ = [
    "FaultInjected", "FaultRule", "FaultPlan", "RetryPolicy",
    "install_plan", "clear_plan", "current_plan", "active",
    "inject", "site_calls", "retry_call",
    "TRANSIENT",
]

KINDS = ("ioerror", "latency", "nonfinite", "hang", "crash")

#: Exit code an injected ``crash`` dies with unless the rule names one —
#: distinctive on purpose so a supervisor log line or waitpid status is
#: attributable to the plan rather than to a real SIGKILL/OOM.
CRASH_EXIT_CODE = 86


class FaultInjected(IOError):
    """Raised by an injected ``ioerror`` fault.  An :class:`IOError`
    subclass so the retry layer (and any caller handling real transient
    storage/transport failures) treats it identically."""

    def __init__(self, site: str, rule: "FaultRule"):
        msg = rule.message or f"injected fault at {site} ({rule})"
        super().__init__(msg)
        self.site = site


class FaultRule:
    """One parsed plan rule: which ``kind`` fires at ``site`` on which
    1-based call indices."""

    __slots__ = ("site", "kind", "seconds", "message", "exit_code",
                 "every", "lo", "hi")

    def __init__(self, site: str, kind: str, arg: Optional[str],
                 calls: str):
        if kind not in KINDS:
            raise MXNetError(
                f"fault rule {site!r}: unknown kind {kind!r} "
                f"(expected one of {KINDS})")
        self.site = site
        self.kind = kind
        self.seconds = None
        self.message = None
        self.exit_code = None
        if kind in ("latency", "hang"):
            try:
                self.seconds = float(arg) if arg \
                    else (3600.0 if kind == "hang" else 0.05)
            except ValueError:
                raise MXNetError(
                    f"fault rule {site!r}: {kind} arg {arg!r} is not a "
                    f"number of seconds")
        elif kind == "ioerror":
            self.message = arg
        elif kind == "crash":
            try:
                self.exit_code = int(arg) if arg else CRASH_EXIT_CODE
            except ValueError:
                raise MXNetError(
                    f"fault rule {site!r}: crash arg {arg!r} is not an "
                    f"integer exit code")
        self.every = None
        self.lo = self.hi = None
        try:
            if calls.startswith("every="):
                self.every = int(calls[len("every="):])
                if self.every <= 0:
                    raise ValueError
            elif "-" in calls:
                lo, hi = calls.split("-", 1)
                self.lo, self.hi = int(lo), int(hi)
            else:
                self.lo = self.hi = int(calls)
        except ValueError:
            raise MXNetError(
                f"fault rule {site!r}: bad call spec {calls!r} "
                f"(expected N, N-M, or every=K)")

    def fires(self, n: int) -> bool:
        if self.every is not None:
            return n % self.every == 0
        return self.lo <= n <= self.hi

    def __repr__(self):
        calls = f"every={self.every}" if self.every is not None else (
            str(self.lo) if self.lo == self.hi else f"{self.lo}-{self.hi}")
        if self.seconds is not None:
            arg = f":{self.seconds}"
        elif self.exit_code is not None:
            arg = f":{self.exit_code}"
        else:
            arg = ""
        return f"{self.site}:{self.kind}{arg}@{calls}"


class FaultPlan:
    """Rules grouped by site + thread-safe deterministic call counters."""

    def __init__(self, rules: List[FaultRule]):
        self.rules: Dict[str, List[FaultRule]] = {}
        for r in rules:
            self.rules.setdefault(r.site, []).append(r)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def fire(self, site: str) -> List[FaultRule]:
        """Count one call at ``site``; return the rules that fire on it."""
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
        return [r for r in self.rules.get(site, ()) if r.fires(n)]

    def calls(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def __repr__(self):
        return "FaultPlan(%s)" % "; ".join(
            repr(r) for rs in self.rules.values() for r in rs)


def _parse_plan(spec: str) -> FaultPlan:
    rules = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        body, _, calls = chunk.partition("@")
        parts = body.split(":")
        if len(parts) < 2 or not parts[0].strip():
            raise MXNetError(
                f"fault rule {chunk!r}: expected site:kind[:arg][@calls]")
        site = parts[0].strip()
        kind = parts[1].strip().lower()
        arg = ":".join(parts[2:]).strip() or None
        rules.append(FaultRule(site, kind, arg, calls.strip() or "1"))
    return FaultPlan(rules)


_plan: Optional[FaultPlan] = None


def install_plan(spec) -> FaultPlan:
    """Install a fault plan (a spec string or a :class:`FaultPlan`);
    replaces any current plan and resets call counters."""
    global _plan
    _plan = spec if isinstance(spec, FaultPlan) else _parse_plan(spec)
    return _plan


def clear_plan() -> None:
    global _plan
    _plan = None


def current_plan() -> Optional[FaultPlan]:
    return _plan


def active() -> bool:
    return _plan is not None


def site_calls(site: str) -> int:
    """How many times ``site`` has been polled (0 without a plan)."""
    plan = _plan
    return plan.calls(site) if plan is not None else 0


def inject(site: str, **ctx) -> None:
    """Poll ``site`` against the plan: sleep for ``latency`` rules, raise
    :class:`FaultInjected` for ``ioerror`` rules, die hard
    (``os._exit``) for ``crash`` rules.  A single attribute check when
    no plan is installed — safe on hot paths.  Extra ``ctx`` kwargs
    (``model=``, ``request_id=``, ...) ride along on the FAULT event so
    an injected failure is attributable to the request that hit it
    (docs/observability.md)."""
    plan = _plan
    if plan is None:
        return
    for r in plan.fire(site):
        if r.kind in ("latency", "hang"):
            _telemetry.FAULT.publish(site=site, event="injected",
                                     kind=r.kind, **ctx)
            _time.sleep(r.seconds)
        elif r.kind == "ioerror":
            _telemetry.FAULT.publish(site=site, event="injected",
                                     kind=r.kind, **ctx)
            raise FaultInjected(site, r)
        elif r.kind == "crash":
            # Process death must be ungraceful by design: no atexit, no
            # finally blocks, no flushing of higher layers — exactly what
            # a preempted host looks like to a supervisor.  The FAULT
            # event is published best-effort first so a same-process
            # subscriber (e.g. the flight recorder) can see it before
            # the lights go out.
            _telemetry.FAULT.publish(site=site, event="injected",
                                     kind=r.kind, exit_code=r.exit_code,
                                     **ctx)
            import os as _os
            import sys as _sys
            try:
                _sys.stderr.write(
                    f"fault: injected crash at {site} "
                    f"(exit {r.exit_code})\n")
                _sys.stderr.flush()
            except Exception:
                pass
            _os._exit(r.exit_code)
        # 'nonfinite' rules belong to numeric sites, which the port's
        # serving path does not have


# ---------------------------------------------------------------------------
# Retry with jittered exponential backoff + deadline
# ---------------------------------------------------------------------------
# What counts as transient: OS/storage/transport errors (FaultInjected is
# an IOError == OSError).  Framework errors (MXNetError) are NOT retried —
# a missing kvstore key will not fix itself.
TRANSIENT = (OSError, TimeoutError)


class RetryPolicy:
    """Backoff schedule: delay(attempt) = min(max_delay, base *
    multiplier^(attempt-1)), jittered DOWNWARD by up to ``jitter`` so
    synchronized workers de-correlate.  Jitter draws from a seeded
    generator — deterministic per policy instance, reproducible in CI."""

    def __init__(self, max_retries: Optional[int] = None,
                 base_seconds: Optional[float] = None,
                 multiplier: float = 2.0,
                 max_delay_seconds: float = 2.0,
                 deadline_seconds: Optional[float] = None,
                 jitter: float = 0.5, seed: int = 0x5EED):
        self.max_retries = int(getenv("MXNET_RETRY_MAX", 4)) \
            if max_retries is None else int(max_retries)
        self.base_seconds = float(getenv("MXNET_RETRY_BASE_SECONDS", 0.05)) \
            if base_seconds is None else float(base_seconds)
        self.multiplier = float(multiplier)
        self.max_delay_seconds = float(max_delay_seconds)
        self.deadline_seconds = float(
            getenv("MXNET_RETRY_DEADLINE_SECONDS", 30.0)) \
            if deadline_seconds is None else float(deadline_seconds)
        self.jitter = float(jitter)
        self._rng = _pyrandom.Random(seed)

    def delay(self, attempt: int) -> float:
        d = min(self.max_delay_seconds,
                self.base_seconds * (self.multiplier ** (attempt - 1)))
        return d * (1.0 - self.jitter * self._rng.random())


def retry_call(fn, *args, site: str = "?",
               policy: Optional[RetryPolicy] = None,
               retry_on=TRANSIENT, retry_after_hint=None, **kwargs):
    """Call ``fn(*args, **kwargs)``, absorbing up to
    ``policy.max_retries`` transient failures with backoff, under a
    wall-clock deadline.  Each retry publishes a ``FAULT`` ``retry``
    event (→ ``mxtpu_retries``); exhaustion publishes ``giveup``
    (→ ``mxtpu_giveups``) and re-raises the last error.  The success
    path costs one try/except frame — no policy object is built unless
    something actually fails.

    ``retry_after_hint`` is an optional ``error -> Optional[float]``
    extractor for server-provided backoff: when it yields a delay for
    the caught error, that delay replaces the exponential schedule for
    the next attempt (capped at the policy's ``max_delay_seconds`` so a
    hostile upstream cannot park the caller, still counted against the
    retry budget and the wall-clock deadline).  Pass
    an extractor of the ``retry_after`` attribute to honor the serving
    transport errors' convention."""
    try:
        return fn(*args, **kwargs)
    except retry_on as e:
        err = e
    if policy is None:
        policy = RetryPolicy()
    deadline = _time.monotonic() + policy.deadline_seconds
    attempt = 0
    while True:
        attempt += 1
        delay = policy.delay(attempt)
        hinted = retry_after_hint(err) if retry_after_hint else None
        if hinted is not None:
            delay = min(hinted, policy.max_delay_seconds)
        if attempt > policy.max_retries \
                or _time.monotonic() + delay > deadline:
            _telemetry.FAULT.publish(site=site, event="giveup",
                                     kind=type(err).__name__)
            raise err
        _telemetry.FAULT.publish(site=site, event="retry",
                                 kind=type(err).__name__,
                                 attempt=attempt, seconds=delay,
                                 hinted=hinted is not None)
        _time.sleep(delay)
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            err = e


# env-configured plan (reference-style config plane; docs/env_var.md)
_spec = getenv("MXNET_FAULT_PLAN")
if _spec:
    try:
        install_plan(_spec)
    except MXNetError as _e:
        import warnings
        warnings.warn(f"MXNET_FAULT_PLAN ignored: {_e}")
del _spec
