"""Self-healing serve fleet: process supervision and autoscaling over the
router's own signals (``mxtpu-supervise-torch``; the port's copy of
``incubator_mxnet_tpu/serving/supervisor.py``, same states, metric names
and ``MXNET_SUPERVISE_*``/``MXNET_AUTOSCALE_*`` knobs).

* **Lifecycle supervision** — spawn replica processes, each in its own
  session (a port allocated per slot and kept across restarts, so the
  router-side identity is stable), gate each on ``/readyz`` before
  registering it with the router, detect crash (process exit) and hang
  (``hang_failures`` consecutive ``/healthz`` failures within
  ``MXNET_SUPERVISE_HEALTH_TIMEOUT_SECONDS``), and restart with
  exponential backoff.  A slot that restarts more than
  ``MXNET_SUPERVISE_MAX_RESTARTS`` times within
  ``MXNET_SUPERVISE_RESTART_WINDOW_SECONDS`` is quarantined: removed from
  the router, left dead, and a flight-recorder dump carries the slot
  table.
* **Autoscaling** — the pure :func:`scale_decision` evaluated every
  ``MXNET_AUTOSCALE_INTERVAL_SECONDS`` over the router's federated
  signals (worst-model SLO burn, fleet queue depth, worst-replica KV
  utilization) with hysteresis, a cooldown and min/max clamps.
  Scale-up spawns a slot; scale-down always drains through the router.

The supervisor and its router run no model and never create a CUDA
context: the replicas own the card.  A replica's kernels are built once
per checkout into ``build/kernels/`` (keyed by a content hash, written
with an atomic rename), so every replica and every restart shares them;
its CUDA graphs are captured in its own process at warm-up.

Every transition is published on the FAULT topic (``supervisor.replica``,
``supervisor.autoscale``) and counted in the ``mxtpu_supervise_*`` /
``mxtpu_autoscale_*`` series, rendered once on the router's
``/metrics``.
"""
from __future__ import annotations

import http.client
import os
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..base import MXNetError, getenv_float, getenv_int
from .. import telemetry as _telemetry
from .. import telemetry_ring as _ring
from . import metrics as _m
from .router import Router

__all__ = [
    "Supervisor", "AutoscalePolicy", "ScaleSignals", "ScaleAction",
    "scale_decision", "FlapBreaker",
    "default_autoscale_interval", "default_supervise_interval",
]

# event sites: every slot transition and executed
# scale action is attributable on the FAULT topic / flight ring
REPLICA_SITE = "supervisor.replica"
AUTOSCALE_SITE = "supervisor.autoscale"

# slot states
STARTING = "STARTING"          # spawned, waiting for /readyz
RUNNING = "RUNNING"            # ready and registered with the router
BACKOFF = "BACKOFF"            # died; respawn scheduled
QUARANTINED = "QUARANTINED"    # flap breaker fired; left dead
STOPPED = "STOPPED"            # deliberately scaled down / shut down

_ACTIVE_STATES = (STARTING, RUNNING, BACKOFF)


def default_supervise_interval() -> float:
    """``MXNET_SUPERVISE_INTERVAL_SECONDS``: watch-loop cadence."""
    return getenv_float("MXNET_SUPERVISE_INTERVAL_SECONDS", 0.5)


def default_autoscale_interval() -> float:
    """``MXNET_AUTOSCALE_INTERVAL_SECONDS``: policy evaluation cadence."""
    return getenv_float("MXNET_AUTOSCALE_INTERVAL_SECONDS", 10.0)


class FlapBreaker:
    """Pure restart-rate breaker for one replica slot.

    :meth:`record` logs one restart attempt at time ``now`` and returns
    True when the slot should be QUARANTINED instead of restarted:
    i.e. when this attempt would exceed ``max_restarts`` restarts
    within the trailing ``window_seconds``.  Time is injected, never
    read, so the policy is a pure function of its inputs and the table
    tests enumerate it exactly."""

    def __init__(self, max_restarts: Optional[int] = None,
                 window_seconds: Optional[float] = None):
        self.max_restarts = getenv_int("MXNET_SUPERVISE_MAX_RESTARTS", 3) \
            if max_restarts is None else int(max_restarts)
        self.window_seconds = getenv_float(
            "MXNET_SUPERVISE_RESTART_WINDOW_SECONDS", 60.0) \
            if window_seconds is None else float(window_seconds)
        self._events: List[float] = []

    def _prune(self, now: float) -> None:
        horizon = now - self.window_seconds
        self._events = [t for t in self._events if t > horizon]

    def record(self, now: float) -> bool:
        """Count one restart attempt; True → quarantine (budget blown)."""
        self._prune(now)
        self._events.append(now)
        return len(self._events) > self.max_restarts

    def count(self, now: float) -> int:
        """Restart attempts inside the trailing window."""
        self._prune(now)
        return len(self._events)


class AutoscalePolicy:
    """Thresholds for :func:`scale_decision`.  Constructor args override
    the ``MXNET_AUTOSCALE_*`` env defaults.

    Hysteresis is structural: the up thresholds (``burn_up``,
    ``queue_up``, ``kv_up``) and the down thresholds (``burn_down``,
    ``queue_down``) are separate, and only a fleet calm on EVERY signal
    scales down — so a load level sitting between the bands holds
    steady instead of oscillating."""

    def __init__(self, min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 burn_up: Optional[float] = None,
                 burn_down: Optional[float] = None,
                 queue_up: Optional[float] = None,
                 queue_down: Optional[float] = None,
                 kv_up: Optional[float] = None,
                 cooldown_seconds: Optional[float] = None):
        self.min_replicas = getenv_int("MXNET_AUTOSCALE_MIN_REPLICAS", 1) \
            if min_replicas is None else int(min_replicas)
        self.max_replicas = getenv_int("MXNET_AUTOSCALE_MAX_REPLICAS", 4) \
            if max_replicas is None else int(max_replicas)
        self.burn_up = getenv_float("MXNET_AUTOSCALE_BURN_UP", 1.0) \
            if burn_up is None else float(burn_up)
        self.burn_down = getenv_float("MXNET_AUTOSCALE_BURN_DOWN", 0.25) \
            if burn_down is None else float(burn_down)
        self.queue_up = getenv_float("MXNET_AUTOSCALE_QUEUE_UP", 8.0) \
            if queue_up is None else float(queue_up)
        self.queue_down = getenv_float("MXNET_AUTOSCALE_QUEUE_DOWN", 1.0) \
            if queue_down is None else float(queue_down)
        self.kv_up = getenv_float("MXNET_AUTOSCALE_KV_UP", 0.85) \
            if kv_up is None else float(kv_up)
        self.cooldown_seconds = getenv_float(
            "MXNET_AUTOSCALE_COOLDOWN_SECONDS", 30.0) \
            if cooldown_seconds is None else float(cooldown_seconds)
        if self.min_replicas < 1:
            raise MXNetError("AutoscalePolicy: min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise MXNetError("AutoscalePolicy: max_replicas "
                             f"{self.max_replicas} < min_replicas "
                             f"{self.min_replicas}")

    def snapshot(self) -> dict:
        return {"min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "burn_up": self.burn_up, "burn_down": self.burn_down,
                "queue_up": self.queue_up, "queue_down": self.queue_down,
                "kv_up": self.kv_up,
                "cooldown_seconds": self.cooldown_seconds}


class ScaleSignals:
    """One policy evaluation's inputs — all injected, nothing read from
    ambient state, so :func:`scale_decision` is a pure function."""

    __slots__ = ("replicas", "burn_rate", "queue_depth",
                 "kv_utilization", "now", "last_scale_time")

    def __init__(self, replicas: int, burn_rate: float = 0.0,
                 queue_depth: float = 0.0, kv_utilization: float = 0.0,
                 now: float = 0.0, last_scale_time: float = -1e9):
        self.replicas = int(replicas)
        self.burn_rate = float(burn_rate)
        self.queue_depth = float(queue_depth)
        self.kv_utilization = float(kv_utilization)
        self.now = float(now)
        self.last_scale_time = float(last_scale_time)

    def snapshot(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class ScaleAction:
    """The decision: ``action`` in ``("up", "down", "hold")``,
    ``target`` fleet size, and the human-readable ``reason``."""

    __slots__ = ("action", "target", "reason")

    def __init__(self, action: str, target: int, reason: str):
        self.action = action
        self.target = int(target)
        self.reason = reason

    def __repr__(self):
        return f"ScaleAction({self.action!r}, target={self.target}, " \
               f"reason={self.reason!r})"


def scale_decision(signals: ScaleSignals,
                   policy: Optional[AutoscalePolicy] = None) -> ScaleAction:
    """The autoscaling policy as a pure function of its inputs.

    Precedence (each clause documented by a table test):

    1. **Below-min repair** beats everything, cooldown included — a
       quarantine that shrank the fleet under ``min_replicas`` is a
       capacity hole, not a scaling opinion.
    2. **Cooldown**: within ``cooldown_seconds`` of the last executed
       action the verdict is ``hold`` — restarts settle before the next
       opinion.
    3. **Up-pressure** (checked in precedence order burn → queue → kv;
       the reason names the winning signal): SLO burn at/over
       ``burn_up``, per-replica queue depth at/over ``queue_up``, or KV
       utilization at/over ``kv_up``.  At ``max_replicas`` the verdict
       degrades to ``hold("at_max")``.
    4. **Scale-down** only when EVERY signal is calm (burn at/under
       ``burn_down``, per-replica queue at/under ``queue_down``, kv
       under ``kv_up``) and the fleet is above ``min_replicas``.
    5. Otherwise ``hold("steady")`` — the hysteresis dead band.

    One step at a time in either direction: the executor only ever has
    to spawn or drain a single replica per action."""
    p = policy if policy is not None else AutoscalePolicy()
    n = signals.replicas
    if n < p.min_replicas:
        return ScaleAction("up", n + 1, "below_min")
    if signals.now - signals.last_scale_time < p.cooldown_seconds:
        return ScaleAction("hold", n, "cooldown")
    per_replica_queue = signals.queue_depth / max(1, n)
    pressure = None
    if signals.burn_rate >= p.burn_up:
        pressure = "burn"
    elif per_replica_queue >= p.queue_up:
        pressure = "queue"
    elif signals.kv_utilization >= p.kv_up:
        pressure = "kv"
    if pressure is not None:
        if n >= p.max_replicas:
            return ScaleAction("hold", n, "at_max")
        return ScaleAction("up", n + 1, pressure)
    if (n > p.min_replicas
            and signals.burn_rate <= p.burn_down
            and per_replica_queue <= p.queue_down
            and signals.kv_utilization < p.kv_up):
        return ScaleAction("down", n - 1, "idle")
    return ScaleAction("hold", n, "steady")


# ---------------------------------------------------------------------------
# federated-signal extraction helpers (pure; unit-tested)
# ---------------------------------------------------------------------------
def _fleet_gauge_sum(state: dict, name: str) -> float:
    """Sum a gauge family's fleet-level series (the merged label sets —
    per-replica ``replica=``-tagged duplicates are excluded so nothing
    double-counts)."""
    fam = (state or {}).get("gauges", {}).get(name) or {}
    return sum(float(v) for labels, v in (fam.get("values") or {}).items()
               if "replica=" not in labels)


def _kv_utilization(state: dict) -> float:
    """Worst per-replica KV utilization from the federated gauge pair
    ``mxtpu_kv_blocks_in_use`` / ``mxtpu_kv_blocks_total``."""
    gauges = (state or {}).get("gauges", {})
    in_use = (gauges.get("mxtpu_kv_blocks_in_use") or {}).get("values") or {}
    totals = (gauges.get("mxtpu_kv_blocks_total") or {}).get("values") or {}
    worst = 0.0
    for labels, total in totals.items():
        if "replica=" not in labels:
            continue
        try:
            total = float(total)
        except (TypeError, ValueError):
            continue
        if total <= 0:
            continue
        worst = max(worst, float(in_use.get(labels, 0.0)) / total)
    return worst


def _fleet_burn(slo_body: dict) -> float:
    """Worst-model burn rate from the router's merged ``/slo`` body."""
    models = (slo_body or {}).get("models") or {}
    burns = [float(m.get("burn_rate") or 0.0)
             for m in models.values() if isinstance(m, dict)]
    return max(burns) if burns else 0.0


class _Slot:
    """One supervised replica slot.  The port — and therefore the
    router-side replica id — is allocated once and survives restarts,
    so a bounce shows up as DOWN→READY on the same member instead of a
    membership change."""

    def __init__(self, index: int, host: str, port: int,
                 breaker: FlapBreaker):
        self.index = index
        self.host = host
        self.port = port
        self.id = f"{host}:{port}"
        self.breaker = breaker
        self.proc: Optional[subprocess.Popen] = None
        self.log = None                 # open log file handle
        self.log_path: Optional[str] = None
        self.state = STOPPED
        self.spawns = 0
        self.restarts = 0
        self.backoff_until = 0.0
        self.start_deadline = 0.0
        self.healthz_failures = 0
        self.last_exit: Optional[int] = None
        self.last_event = ""

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def snapshot(self) -> dict:
        return {"index": self.index, "id": self.id, "state": self.state,
                "pid": self.pid, "spawns": self.spawns,
                "restarts": self.restarts,
                "last_exit": self.last_exit,
                "last_event": self.last_event,
                "log": self.log_path}


class Supervisor:
    """Fleet controller: owns replica processes AND the router fronting
    them.  Programmatic use (the ``mxtpu-supervise-torch`` CLI wraps
    this)::

        sup = Supervisor([sys.executable, "-c", ..., "--port", "{port}"],
                         replicas=2, policy=AutoscalePolicy(max_replicas=4))
        sup.start()            # spawns, health-gates, starts the router
        ... traffic against sup.router.port ...
        sup.stop()

    ``command`` is the replica argv; every element has ``{port}``
    substituted with the slot's allocated port.  ``child_env`` overlays
    the inherited environment.
    ``autoscale=False`` supervises a fixed-size fleet.  Pass
    ``router=`` to adopt an externally-owned router (it will NOT be
    stopped on :meth:`stop`)."""

    def __init__(self, command: Sequence[str], *,
                 replicas: int = 1,
                 policy: Optional[AutoscalePolicy] = None,
                 autoscale: bool = True,
                 router: Optional[Router] = None,
                 router_port: int = 0,
                 host: str = "127.0.0.1",
                 child_env: Optional[Dict[str, str]] = None,
                 log_dir: Optional[str] = None,
                 interval_seconds: Optional[float] = None,
                 autoscale_interval_seconds: Optional[float] = None,
                 ready_timeout: Optional[float] = None,
                 health_timeout: Optional[float] = None,
                 hang_failures: Optional[int] = None,
                 backoff_base: Optional[float] = None,
                 backoff_max: Optional[float] = None,
                 max_restarts: Optional[int] = None,
                 restart_window_seconds: Optional[float] = None,
                 port_allocator: Optional[Callable[[], int]] = None):
        command = [str(c) for c in command]
        if not any("{port}" in c for c in command):
            raise MXNetError(
                "Supervisor command must carry a '{port}' placeholder "
                "(the supervisor allocates each slot's port)")
        self.command = command
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.autoscale = bool(autoscale)
        self.host = host
        self.child_env = dict(child_env or {})
        self.log_dir = log_dir
        self.interval = default_supervise_interval() \
            if interval_seconds is None else float(interval_seconds)
        self.autoscale_interval = default_autoscale_interval() \
            if autoscale_interval_seconds is None \
            else float(autoscale_interval_seconds)
        self.ready_timeout = getenv_float(
            "MXNET_SUPERVISE_READY_TIMEOUT_SECONDS", 120.0) \
            if ready_timeout is None else float(ready_timeout)
        self.health_timeout = getenv_float(
            "MXNET_SUPERVISE_HEALTH_TIMEOUT_SECONDS", 5.0) \
            if health_timeout is None else float(health_timeout)
        self.hang_failures = getenv_int(
            "MXNET_SUPERVISE_HANG_FAILURES", 3) \
            if hang_failures is None else int(hang_failures)
        self.backoff_base = getenv_float(
            "MXNET_SUPERVISE_BACKOFF_SECONDS", 0.5) \
            if backoff_base is None else float(backoff_base)
        self.backoff_max = getenv_float(
            "MXNET_SUPERVISE_BACKOFF_MAX_SECONDS", 10.0) \
            if backoff_max is None else float(backoff_max)
        self._max_restarts = max_restarts
        self._restart_window = restart_window_seconds
        self._initial = max(int(replicas), self.policy.min_replicas)
        if self._initial > self.policy.max_replicas:
            raise MXNetError(
                f"Supervisor: replicas {self._initial} > policy "
                f"max_replicas {self.policy.max_replicas}")
        self._router = router
        self._owns_router = router is None
        self._router_port = int(router_port)
        self._alloc = port_allocator if port_allocator is not None \
            else self._free_port
        self._slots: List[_Slot] = []
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._scale_thread: Optional[threading.Thread] = None
        self._recorder: Optional[_ring.FlightRecorder] = None
        self._last_scale = -1e9
        self._last_decision: Optional[dict] = None
        self._next_index = 0

    # -- plumbing -------------------------------------------------------
    @property
    def router(self) -> Optional[Router]:
        return self._router

    def _free_port(self) -> int:
        import socket
        s = socket.socket()
        s.bind((self.host, 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def slots(self) -> List[_Slot]:
        with self._lock:
            return list(self._slots)

    def alive_count(self) -> int:
        return sum(1 for s in self.slots() if s.state == RUNNING)

    def active_count(self) -> int:
        """Fleet size the policy reasons about: slots that are serving,
        starting, or between restarts — everything not deliberately
        stopped or quarantined."""
        return sum(1 for s in self.slots() if s.state in _ACTIVE_STATES)

    def state(self) -> dict:
        """The flight-recorder provider payload: the whole slot table
        plus the last autoscale evaluation."""
        return {"slots": [s.snapshot() for s in self.slots()],
                "active": self.active_count(),
                "alive": self.alive_count(),
                "policy": self.policy.snapshot(),
                "autoscale": self.autoscale,
                "last_decision": self._last_decision}

    # -- probes ---------------------------------------------------------
    def _http_get(self, slot: _Slot, path: str,
                  timeout: float) -> Optional[int]:
        conn = http.client.HTTPConnection(slot.host, slot.port,
                                          timeout=timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            resp.read()
            return resp.status
        finally:
            conn.close()

    def _ready(self, slot: _Slot, timeout: float) -> bool:
        try:
            return self._http_get(slot, "/readyz", timeout) == 200
        except OSError:
            return False

    def _healthy(self, slot: _Slot) -> bool:
        try:
            return self._http_get(slot, "/healthz",
                                  self.health_timeout) is not None
        except OSError:
            return False

    # -- spawning -------------------------------------------------------
    def _spawn(self, slot: _Slot) -> None:
        argv = [c.replace("{port}", str(slot.port)) for c in self.command]
        env = dict(os.environ)
        env.update(self.child_env)
        if slot.log is None and self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            slot.log_path = os.path.join(
                self.log_dir, f"replica-{slot.port}.log")
            slot.log = open(slot.log_path, "ab")
        out = slot.log if slot.log is not None else subprocess.DEVNULL
        # own session: a Ctrl-C aimed at the supervisor must reach the
        # replicas as an orderly drain (our stop()), not a shared SIGINT
        slot.proc = subprocess.Popen(argv, stdout=out, stderr=out,
                                     env=env, start_new_session=True)
        restart = slot.spawns > 0
        slot.spawns += 1
        if restart:
            slot.restarts += 1
            _m.SUPERVISE_RESTARTS.inc(replica=slot.id)
        _m.SUPERVISE_SPAWNS.inc()
        slot.state = STARTING
        slot.healthz_failures = 0
        slot.start_deadline = time.monotonic() + self.ready_timeout
        slot.last_event = "restart" if restart else "spawn"
        _telemetry.FAULT.publish(site=REPLICA_SITE, event="spawn",
                                 kind="restart" if restart else "initial",
                                 replica=slot.id, pid=slot.proc.pid)

    def _new_slot(self) -> _Slot:
        with self._lock:
            breaker = FlapBreaker(self._max_restarts,
                                  self._restart_window)
            slot = _Slot(self._next_index, self.host, int(self._alloc()),
                         breaker)
            self._next_index += 1
            self._slots.append(slot)
        return slot

    def _kill(self, slot: _Slot, grace: float = 3.0) -> None:
        proc = slot.proc
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            proc.kill()
            try:
                proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                pass

    # -- slot transitions ----------------------------------------------
    def _on_ready(self, slot: _Slot) -> None:
        slot.state = RUNNING
        slot.healthz_failures = 0
        slot.last_event = "ready"
        _telemetry.FAULT.publish(site=REPLICA_SITE, event="ready",
                                 kind="gate", replica=slot.id)
        # health-gated registration: the router only ever learns about
        # a replica that has already answered /readyz.  Idempotent, so
        # a restarted slot (same port → same id) is a no-op re-add.
        if self._router is None:
            self._router = Router([slot.id], port=self._router_port,
                                  host="0.0.0.0")
            self._router.start()
        else:
            self._router.add_replica(slot.id)
        _m.SUPERVISE_REPLICAS.set(self.alive_count())

    def _on_death(self, slot: _Slot, kind: str) -> None:
        if slot.state == STOPPED or self._stop.is_set():
            return                      # deliberate kill, not a crash
        slot.last_exit = slot.proc.returncode if slot.proc is not None \
            else None
        slot.last_event = kind
        now = time.monotonic()
        _telemetry.FAULT.publish(site=REPLICA_SITE, event="died",
                                 kind=kind, replica=slot.id,
                                 exit_code=slot.last_exit)
        _m.SUPERVISE_REPLICAS.set(self.alive_count())
        if slot.breaker.record(now):
            self._quarantine(slot)
            return
        attempt = slot.breaker.count(now)
        delay = min(self.backoff_max,
                    self.backoff_base * (2.0 ** max(0, attempt - 1)))
        slot.state = BACKOFF
        slot.backoff_until = now + delay
        _telemetry.FAULT.publish(site=REPLICA_SITE, event="backoff",
                                 kind=kind, replica=slot.id,
                                 seconds=round(delay, 3), attempt=attempt)

    def _quarantine(self, slot: _Slot) -> None:
        slot.state = QUARANTINED
        slot.last_event = "quarantine"
        _m.SUPERVISE_QUARANTINES.inc(replica=slot.id)
        _telemetry.FAULT.publish(site=REPLICA_SITE, event="quarantined",
                                 kind="flap", replica=slot.id,
                                 restarts=slot.restarts)
        if self._router is not None:
            try:
                # the corpse has nothing left to drain
                self._router.remove_replica(slot.id, drain=False)
            except KeyError:
                pass
        rec = self._recorder
        if rec is not None:
            try:
                rec.dump("replica_quarantined")
            except OSError:
                pass

    # -- watch loop -----------------------------------------------------
    def poll_once(self) -> None:
        """One synchronous supervision sweep (tests drive this directly;
        the background loop calls it on ``interval_seconds``)."""
        now = time.monotonic()
        for slot in self.slots():
            if slot.state == STARTING:
                if not slot.alive():
                    self._on_death(slot, "exit")
                elif self._ready(slot, min(1.0, self.health_timeout)):
                    self._on_ready(slot)
                elif now > slot.start_deadline:
                    self._kill(slot)
                    self._on_death(slot, "start_timeout")
            elif slot.state == RUNNING:
                if not slot.alive():
                    self._on_death(slot, "exit")
                elif self._healthy(slot):
                    slot.healthz_failures = 0
                else:
                    slot.healthz_failures += 1
                    if slot.healthz_failures >= self.hang_failures:
                        self._kill(slot)
                        self._on_death(slot, "hang")
            elif slot.state == BACKOFF:
                if now >= slot.backoff_until:
                    self._spawn(slot)

    def _watch_run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.poll_once()
            except Exception:          # the watch loop must survive
                pass                   # anything one replica throws

    # -- autoscaling ----------------------------------------------------
    def collect_signals(self) -> ScaleSignals:
        """Pull one :class:`ScaleSignals` sample off the router's
        federated views (merged ``/slo`` burn, fleet queue depth,
        worst-replica KV utilization)."""
        burn = queue = kv = 0.0
        if self._router is not None:
            try:
                burn = _fleet_burn(self._router.fleet_slo())
            except Exception:
                pass
            try:
                state = self._router.fleet_metrics_state()
                queue = _fleet_gauge_sum(state, "mxtpu_serve_queue_depth")
                kv = _kv_utilization(state)
            except Exception:
                pass
        return ScaleSignals(replicas=self.active_count(),
                            burn_rate=burn, queue_depth=queue,
                            kv_utilization=kv, now=time.monotonic(),
                            last_scale_time=self._last_scale)

    def autoscale_once(self) -> ScaleAction:
        """One policy evaluation + execution (tests and the loop share
        this path)."""
        signals = self.collect_signals()
        _m.AUTOSCALE_BURN.set(signals.burn_rate)
        _m.AUTOSCALE_QUEUE.set(signals.queue_depth)
        _m.AUTOSCALE_KV.set(signals.kv_utilization)
        act = scale_decision(signals, self.policy)
        _m.AUTOSCALE_DECISIONS.inc(action=act.action)
        _m.AUTOSCALE_TARGET.set(act.target)
        self._last_decision = {"action": act.action,
                               "target": act.target,
                               "reason": act.reason,
                               "signals": signals.snapshot()}
        if act.action == "up":
            self._scale_up(act)
        elif act.action == "down":
            self._scale_down(act)
        return act

    def _scale_up(self, act: ScaleAction) -> None:
        slot = self._new_slot()
        self._spawn(slot)
        self._last_scale = time.monotonic()
        _m.AUTOSCALE_EVENTS.inc(action="up")
        _telemetry.FAULT.publish(site=AUTOSCALE_SITE, event="scale",
                                 kind="up", reason=act.reason,
                                 target=act.target, replica=slot.id)

    def _scale_down(self, act: ScaleAction) -> None:
        victims = [s for s in self.slots() if s.state == RUNNING]
        if len(victims) <= self.policy.min_replicas:
            return                      # nothing safely removable
        slot = victims[-1]              # newest first: LIFO shrink
        slot.state = STOPPED            # watch loop hands it off NOW
        self._last_scale = time.monotonic()
        if self._router is not None:
            try:
                # zero-downtime by construction: drain routes the
                # member's traffic away before the process dies
                self._router.remove_replica(slot.id, drain=True)
            except KeyError:
                pass
        self._kill(slot)
        slot.last_event = "scale_down"
        _m.SUPERVISE_REPLICAS.set(self.alive_count())
        _m.AUTOSCALE_EVENTS.inc(action="down")
        _telemetry.FAULT.publish(site=AUTOSCALE_SITE, event="scale",
                                 kind="down", reason=act.reason,
                                 target=act.target, replica=slot.id)

    def _scale_run(self) -> None:
        while not self._stop.wait(self.autoscale_interval):
            try:
                self.autoscale_once()
            except Exception:          # policy loop must survive too
                pass

    # -- lifecycle ------------------------------------------------------
    def start(self, ready_deadline: Optional[float] = None) -> "Supervisor":
        """Spawn the initial fleet, health-gate it, bring up the router,
        then hand off to the background watch + autoscale loops.
        Blocks until at least one replica is RUNNING (the fleet can
        serve) or ``ready_deadline`` (default ``ready_timeout``)
        expires — then tears down and raises."""
        if self._watch_thread is not None:
            return self
        self._stop.clear()
        self._recorder = _ring.recorder
        self._recorder.start()
        self._recorder.register_provider("supervisor", self.state)
        for _ in range(self._initial):
            self._spawn(self._new_slot())
        deadline = time.monotonic() + (self.ready_timeout
                                       if ready_deadline is None
                                       else float(ready_deadline))
        while self.alive_count() == 0:
            if time.monotonic() > deadline or all(
                    s.state == QUARANTINED for s in self.slots()):
                self.stop()
                raise MXNetError(
                    "Supervisor: no replica became ready within "
                    f"{self.ready_timeout}s — see replica logs"
                    + (f" under {self.log_dir}" if self.log_dir else ""))
            time.sleep(min(0.05, self.interval))
            self.poll_once()
        self._watch_thread = threading.Thread(
            target=self._watch_run, name="mxtpu-supervise-watch",
            daemon=True)
        self._watch_thread.start()
        if self.autoscale:
            self._scale_thread = threading.Thread(
                target=self._scale_run, name="mxtpu-supervise-scale",
                daemon=True)
            self._scale_thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the loops, drain + stop the owned router, terminate
        every replica process."""
        self._stop.set()
        for th in (self._watch_thread, self._scale_thread):
            if th is not None:
                th.join(timeout=timeout)
        self._watch_thread = self._scale_thread = None
        router, owned = self._router, self._owns_router
        if router is not None and owned:
            self._router = None
            router.stop()
        for slot in self.slots():
            if slot.state in _ACTIVE_STATES:
                slot.state = STOPPED
            self._kill(slot)
            if slot.log is not None:
                try:
                    slot.log.close()
                except OSError:
                    pass
                slot.log = None
        _m.SUPERVISE_REPLICAS.set(0)
        rec, self._recorder = self._recorder, None
        if rec is not None:
            rec.unregister_provider("supervisor")
            rec.stop()

    def shutdown(self, drain_seconds: Optional[float] = None) -> None:
        """The SIGTERM sequence (``lifecycle.run_until_shutdown``): let
        the router drain client traffic, then stop everything."""
        router = self._router
        if router is not None and self._owns_router:
            self._router = None
            router.shutdown(drain_seconds=drain_seconds)
        self.stop()

    def __enter__(self) -> "Supervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
