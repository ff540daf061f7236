"""The serving batchers (counterpart of
``incubator_mxnet_tpu/serving/batcher.py``): :class:`DynamicBatcher`
coalesces concurrent one-shot requests into one bucketed dispatch of an
:class:`~.engine.InferenceEngine` (described on its class), and
:class:`ContinuousBatcher` runs continuous batching over one
:class:`~.engine.GenerationEngine`, with the same operational tiers; the
rest of this docstring is the continuous batcher's.

A worker thread runs step boundaries: free the slots of cancelled and
expired requests, admit queued requests into free slots (one ``prefill``
each, emitting the first token), then advance every live slot with one
``decode`` — or with one ``decode_burst`` of up to ``engine.scan_steps``
tokens when the boundary sees steady state (nothing queued, nothing
cancelled, no deadline inside the burst), or, with a draft attached, one
speculative step of 1 to ``spec_k + 1`` tokens per slot.  Tokens stream
back per request as they are produced.

The request features ride on the same programs: per-token top-N
logprobs, stop sequences (trimmed at the emit boundary, a burst's
over-generated tail included), ``n > 1`` candidates (one child request
per slot with derived seeds) and JSON mode (a
:class:`~.sampling.JsonMaskMachine` whose mask is the slot's logit-bias
row; a constrained slot keeps the batch on per-step decode).

Operational behaviour, wired into the port's planes as the reference
wires it:

* **backpressure** — a full queue raises :class:`QueueFullError` with a
  ``retry_after`` hint (HTTP 429 + ``Retry-After``); the admitted queue
  length is also bounded by how many requests of this footprint the KV
  cache sustains.
* **deadlines** — ``timeout_ms`` (env default ``MXNET_SERVE_TIMEOUT_MS``)
  is enforced in the queue, at every step boundary (mid-decode) and at the
  caller's wait: ``lifecycle.DeadlineExceeded`` (HTTP 504).
* **circuit breaker** — a dispatch that fails after retries counts one
  failure on the model's ``lifecycle.CircuitBreaker``; while it is OPEN,
  admission raises ``lifecycle.BreakerOpen`` (HTTP 503).
* **watchdog** — the worker heartbeats; :meth:`ContinuousBatcher.
  check_worker` (driven by ``lifecycle.Watchdog``) replaces a dead or hung
  worker with a new generation, fails its riders with
  ``lifecycle.RequestAborted`` and trips the breaker.  A replaced worker
  finds its generation stale before its next dispatch; the engine's
  dispatch lock keeps the new worker's ``reset`` from running under the
  old one's replay.
* **faults** — ``serving.queue`` is polled at submit and ``serving.infer``
  before every dispatch, outside the engine's lock (so a ``hang`` wedges
  the worker, not the engine); a failed dispatch retries under
  ``fault.retry_call``, and re-stages every operand from host state.
* **telemetry** — ``serve.request`` / ``serve.batch`` / ``slot.join`` /
  ``slot.leave`` spans, the ``mxtpu_serve_*`` / ``mxtpu_generate_*``
  series, the health plane's decode stats, and per-model SLO records
  (request outcomes and every inter-token gap)."""
from __future__ import annotations

import contextlib
import os
import queue as _pyqueue
import threading
import time
from collections import deque
from dataclasses import replace
from typing import List, Optional, Sequence

import numpy as _np
import torch

from ..base import MXNetError, getenv_float, getenv_int
from .. import fault as _fault
from .. import health as _health
from .. import telemetry as _telemetry
from .. import telemetry_device as _tdev
from . import lifecycle as _lc
from . import metrics as _m
from . import slo as _slo
from .engine import _as_tensor
from .lifecycle import Cancelled, RequestAborted
from .sampling import (JsonMaskMachine, SamplingParams,
                       derive_candidate_seed, stop_trim)

__all__ = ["DynamicBatcher", "ContinuousBatcher", "QueueFullError",
           "Cancelled", "RequestAborted"]


class QueueFullError(MXNetError):
    """The batcher's queue is full — backpressure, not failure.
    ``retry_after`` (seconds) becomes the HTTP ``Retry-After`` header."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = float(retry_after)


# ===========================================================================
# DynamicBatcher — one-shot requests coalesced into one bucketed dispatch
# ===========================================================================

def _dtype_name(a) -> str:
    """A request array's dtype by its numpy name (``float32``) for numpy
    arrays, NDArrays and tensors alike, so that they coalesce."""
    return str(getattr(a, "dtype", "?")).replace("torch.", "")


class _Request:
    """One submitted batch: arrays and a latch the caller waits on."""

    __slots__ = ("arrays", "n", "sig", "event", "outputs", "error",
                 "t_submit", "deadline", "model", "request_id",
                 "trace_ctx")

    def __init__(self, arrays, n, sig, deadline=None, model="?",
                 request_id=None, trace_ctx=None):
        self.arrays = arrays
        self.n = n
        self.sig = sig
        self.event = threading.Event()
        self.outputs = None
        self.error = None
        self.t_submit = time.monotonic()
        self.deadline = deadline        # absolute monotonic, or None
        self.model = model
        self.request_id = request_id or _telemetry.new_request_id()
        self.trace_ctx = trace_ctx      # the submitter's span

    def fail(self, err: Exception) -> None:
        """Finish this request with ``err`` (idempotent): the one way the
        worker, the watchdog and the drain fail a request."""
        if self.event.is_set():
            return
        self.error = err
        self.event.set()

    def result(self, timeout: Optional[float] = None) -> List:
        """Block for the scattered outputs; re-raises a dispatch error.
        The wait is also bounded by the request's own deadline: crossing
        it raises ``lifecycle.DeadlineExceeded`` (HTTP 504), a
        caller-supplied ``timeout`` alone ``TimeoutError``."""
        wait = timeout
        if self.deadline is not None:
            remaining = max(0.0, self.deadline - time.monotonic())
            wait = remaining if timeout is None else min(timeout, remaining)
        if not self.event.wait(wait):
            if self.deadline is not None \
                    and time.monotonic() >= self.deadline:
                _m.DEADLINE_EXCEEDED.inc(model=self.model, stage="wait")
                _telemetry.FAULT.publish(
                    site="serving.deadline", event="deadline", kind="wait",
                    model=self.model, request_id=self.request_id)
                raise _lc.DeadlineExceeded(
                    f"{self.model}: request {self.request_id} deadline "
                    f"exceeded after "
                    f"{time.monotonic() - self.t_submit:.3f}s")
            raise TimeoutError("inference request timed out")
        if self.error is not None:
            raise self.error
        return self.outputs


class DynamicBatcher:
    """Batch-coalescing front over one :class:`~.engine.InferenceEngine`
    (counterpart of the JAX batcher of the same name).

    Requests land in a bounded FIFO queue; one worker thread pops the
    head and gathers the requests behind it that share its per-example
    shapes and dtypes (never reordering past an incompatible head) until
    the group reaches ``max_batch_size`` rows or the head's
    ``max_delay_ms`` window closes.  The group is concatenated, run as
    ONE ``engine.predict`` (one bucket's graph on the card) and each
    caller gets its own rows.  The tiers are the reference's:
    backpressure (:class:`QueueFullError`), deadlines at admission, in
    the queue and at the caller's wait (``lifecycle.DeadlineExceeded``),
    the ``serving.queue`` and ``serving.infer`` fault sites with retries
    and then one dispatch per request (``mxtpu_serve_fallbacks``), the
    circuit breaker, the generation-counted watchdog
    (:meth:`check_worker`), drain on :meth:`close`, ``serve.request`` /
    ``serve.batch`` spans whose ``links`` name every rider, and SLO
    records.

    Defaults come from ``MXNET_SERVE_MAX_BATCH`` (32, capped by the
    engine's largest bucket), ``MXNET_SERVE_MAX_DELAY_MS`` (5.0),
    ``MXNET_SERVE_QUEUE`` (128) and ``MXNET_SERVE_TIMEOUT_MS`` (0: no
    deadline)."""

    def __init__(self, engine, *, max_batch_size: Optional[int] = None,
                 max_delay_ms: Optional[float] = None,
                 queue_size: Optional[int] = None,
                 name: Optional[str] = None, retry_policy=None,
                 breaker: Optional[_lc.CircuitBreaker] = None,
                 default_timeout_ms: Optional[float] = None):
        self.engine = engine
        self.name = str(name or engine.name)
        if max_batch_size is None:
            max_batch_size = getenv_int("MXNET_SERVE_MAX_BATCH", 32)
        if engine.max_batch_size:
            max_batch_size = min(int(max_batch_size),
                                 int(engine.max_batch_size))
        self.max_batch_size = max(1, int(max_batch_size))
        if max_delay_ms is None:
            max_delay_ms = getenv_float("MXNET_SERVE_MAX_DELAY_MS", 5.0)
        self.max_delay = max(0.0, float(max_delay_ms)) / 1000.0
        if queue_size is None:
            queue_size = getenv_int("MXNET_SERVE_QUEUE", 128)
        self.queue_size = max(1, int(queue_size))
        if default_timeout_ms is None:
            default_timeout_ms = _lc.default_timeout_ms()
        self.default_timeout_ms = float(default_timeout_ms)
        self.retry_policy = retry_policy
        self.breaker = breaker if breaker is not None \
            else _lc.CircuitBreaker(self.name)
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        # worker health (guarded by _cv): a watchdog restart bumps the
        # generation; the old thread exits when it next looks
        self._worker_gen = 0
        self._heartbeat = time.monotonic()
        self._busy_since: Optional[float] = None
        self._inflight: Optional[list] = None
        self._restarts = 0
        self._degraded = False
        self._avg_batch_seconds = 0.0
        self._thread = self._start_worker()

    def _start_worker(self) -> threading.Thread:
        t = threading.Thread(
            target=self._worker, args=(self._worker_gen,),
            name=f"mxtorch-serve-{self.name}-g{self._worker_gen}",
            daemon=True)
        t.start()
        return t

    # -- submit ---------------------------------------------------------
    @staticmethod
    def _signature(arrays):
        return tuple((tuple(a.shape[1:]), _dtype_name(a)) for a in arrays)

    def _estimate_wait_locked(self) -> float:
        """Queue-wait estimate for a newly admitted request from the rows
        queued and the EWMA batch time (``_cv`` held); 0 until a batch has
        been measured, so admission sheds only on evidence."""
        if self._avg_batch_seconds <= 0.0:
            return 0.0
        rows = sum(r.n for r in self._queue)
        batches_ahead = rows // self.max_batch_size
        if self._busy_since is not None:    # current dispatch first
            batches_ahead += 1
        return batches_ahead * self._avg_batch_seconds

    def submit_async(self, arrays: Sequence,
                     timeout_ms: Optional[float] = None,
                     request_id: Optional[str] = None) -> _Request:
        """Enqueue one request batch; returns a latch whose ``result()``
        blocks for the outputs.  Raises :class:`QueueFullError` under
        backpressure, ``lifecycle.BreakerOpen`` while the breaker is
        OPEN, ``lifecycle.DeadlineExceeded`` when the queue-wait estimate
        already busts the request's budget, and ``MXNetError`` after
        :meth:`close`."""
        if request_id is None:
            request_id = _telemetry.new_request_id()
        _fault.inject("serving.queue", model=self.name,
                      request_id=request_id)
        self.breaker.allow()
        arrays = list(arrays)
        n = int(arrays[0].shape[0])
        if timeout_ms is None:
            timeout_ms = self.default_timeout_ms
        req = _Request(arrays, n, self._signature(arrays),
                       deadline=_lc.deadline_from_ms(timeout_ms),
                       model=self.name, request_id=request_id,
                       trace_ctx=_telemetry.tracer.current())
        with self._cv:
            if self._closed:
                raise MXNetError(f"batcher {self.name!r} is closed")
            if len(self._queue) >= self.queue_size:
                _m.REJECTED.inc(model=self.name)
                raise QueueFullError(
                    f"{self.name}: queue full ({self.queue_size} "
                    "pending) — backpressure")
            if req.deadline is not None:
                est = self._estimate_wait_locked()
                if time.monotonic() + est > req.deadline:
                    _m.DEADLINE_EXCEEDED.inc(model=self.name,
                                             stage="admission")
                    _telemetry.FAULT.publish(
                        site="serving.deadline", event="deadline",
                        kind="admission", model=self.name,
                        request_id=req.request_id)
                    raise _lc.DeadlineExceeded(
                        f"{self.name}: estimated queue wait {est:.3f}s "
                        "already exceeds the deadline of request "
                        f"{req.request_id}")
            self._queue.append(req)
            _m.QUEUE_DEPTH.set(len(self._queue), model=self.name)
            self._cv.notify_all()
        _m.REQUESTS.inc(model=self.name)
        return req

    def submit(self, arrays: Sequence,
               timeout: Optional[float] = None,
               timeout_ms: Optional[float] = None,
               request_id: Optional[str] = None) -> List:
        """Synchronous request: enqueue, wait, return this request's rows
        of every output.  ``timeout_ms`` is the end-to-end deadline
        (default ``MXNET_SERVE_TIMEOUT_MS``); ``timeout`` bounds only the
        wait.  Every outcome lands in the model's SLO window."""
        if request_id is None:
            request_id = _telemetry.new_request_id()
        t0 = time.monotonic()
        with _telemetry.trace_span("serve.request", cat="serving",
                                   model=self.name,
                                   request_id=request_id):
            try:
                out = self.submit_async(
                    arrays, timeout_ms=timeout_ms,
                    request_id=request_id).result(timeout)
            except Exception:
                _slo.tracker.record(self.name,
                                    time.monotonic() - t0, ok=False)
                raise
            _slo.tracker.record(self.name, time.monotonic() - t0, ok=True)
            return out

    # -- worker ---------------------------------------------------------
    def _current_gen(self) -> int:
        with self._cv:
            return self._worker_gen

    def _worker(self, gen: int):
        while True:
            if self._current_gen() != gen:
                return                  # replaced by the watchdog
            group = self._gather(gen)
            if group is None:
                return
            with self._cv:
                if gen == self._worker_gen:
                    self._busy_since = time.monotonic()
                    self._inflight = group
            self._run_group(group)
            with self._cv:
                if gen == self._worker_gen:
                    self._busy_since = None
                    self._inflight = None

    def _expire_locked(self, req: _Request) -> None:
        """Shed one request that expired while queued (``_cv`` held)."""
        _m.DEADLINE_EXCEEDED.inc(model=self.name, stage="queue")
        _telemetry.FAULT.publish(site="serving.deadline", event="deadline",
                                 kind="queue", model=self.name,
                                 request_id=req.request_id)
        req.fail(_lc.DeadlineExceeded(
            f"{self.name}: request {req.request_id} expired in queue "
            f"after {time.monotonic() - req.t_submit:.3f}s"))

    def _gather(self, gen: int):
        """Block for the head request, then coalesce until the batch is
        full, the head's delay window closes or the next request is
        shape-incompatible (FIFO kept).  Expired requests are shed here,
        never dispatched.  None when closed and drained or when this
        worker generation was replaced."""
        with self._cv:
            while True:
                self._heartbeat = time.monotonic()
                while self._queue and self._queue[0].deadline is not None \
                        and self._queue[0].deadline <= self._heartbeat:
                    self._expire_locked(self._queue.popleft())
                if self._queue:
                    break
                if self._closed:
                    return None
                if gen != self._worker_gen:
                    return None
                self._cv.wait(0.05)
            head = self._queue.popleft()
            group, total = [head], head.n
            deadline = time.monotonic() + self.max_delay
            while total < self.max_batch_size:
                if self._queue:
                    nxt = self._queue[0]
                    if nxt.deadline is not None \
                            and nxt.deadline <= time.monotonic():
                        self._expire_locked(self._queue.popleft())
                        continue
                    if nxt.sig != head.sig \
                            or total + nxt.n > self.max_batch_size:
                        break
                    group.append(self._queue.popleft())
                    total += nxt.n
                    continue
                if self._closed:        # drain fast: no delay window
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            _m.QUEUE_DEPTH.set(len(self._queue), model=self.name)
        return group

    def _run_group(self, group):
        t0 = time.monotonic()
        for r in group:
            _m.QUEUE_WAIT.observe(t0 - r.t_submit)
        total = sum(r.n for r in group)
        _m.BATCH_SIZE.observe(total)
        _m.BATCHES.inc(model=self.name)
        rids = [r.request_id for r in group]
        # the batch span nests under the head rider's request span and
        # links every rider's id
        head_ctx = group[0].trace_ctx
        attach = _telemetry.tracer.attach(head_ctx) \
            if head_ctx is not None else contextlib.nullcontext()
        with attach, \
                _telemetry.trace_span("serve.batch", cat="serving",
                                      model=self.name,
                                      requests=len(group), rows=total,
                                      links=rids):
            try:
                if len(group) == 1:
                    ins = group[0].arrays
                else:
                    dev = self.engine.device
                    ins = [torch.cat([_as_tensor(r.arrays[i]).to(dev)
                                      for r in group])
                           for i in range(len(group[0].arrays))]

                def run():
                    _fault.inject("serving.infer", model=self.name,
                                  request_ids=rids)
                    return self.engine.predict(ins)

                try:
                    outs = _fault.retry_call(run, site="serving.infer",
                                             policy=self.retry_policy)
                except Exception as e:
                    self._fallback(group, e)
                    return
                off = 0
                for r in group:
                    r.outputs = [o[off:off + r.n] for o in outs]
                    off += r.n
                dt = time.monotonic() - t0
                self._avg_batch_seconds = dt \
                    if self._avg_batch_seconds <= 0.0 \
                    else 0.8 * self._avg_batch_seconds + 0.2 * dt
                self._degraded = False
                self.breaker.record_success()
            except Exception as e:      # the worker survives anything
                _telemetry.FAULT.publish(
                    site="serving.worker", event="crash",
                    kind=type(e).__name__, model=self.name,
                    request_ids=rids)
                for r in group:
                    r.error = e
            finally:
                done = time.monotonic()
                for r in group:
                    # the watchdog may already have failed this rider
                    if not r.event.is_set():
                        _m.LATENCY.observe(done - r.t_submit)
                        r.event.set()

    def _fallback(self, group, err):
        """The batched dispatch failed after retries: run each request on
        its own, so one poisoned batch cannot fail every rider (the
        ``serving.infer`` site already fired on the batch attempts).
        Counts one failure on the breaker."""
        _telemetry.FAULT.publish(site="serving.infer", event="fallback",
                                 kind=type(err).__name__,
                                 requests=len(group), model=self.name,
                                 request_ids=[r.request_id
                                              for r in group])
        _m.FALLBACKS.inc(model=self.name)
        self.breaker.record_failure(f"batch dispatch failed: "
                                    f"{type(err).__name__}")
        for r in group:
            try:
                r.outputs = self.engine.predict(r.arrays)
            except Exception as e:
                r.error = e

    # -- watchdog plane -------------------------------------------------
    def check_worker(self, hang_seconds: Optional[float] = None):
        """Detect a dead or hung worker (driven by ``lifecycle.Watchdog``).
        On detection: fail the in-flight group's riders with
        ``RequestAborted``, start a worker of a new generation, trip the
        breaker and mark the model DEGRADED.  Returns ``"died"`` /
        ``"hung"`` when a restart happened, else None;
        ``hang_seconds <= 0`` disables hang detection."""
        if hang_seconds is None:
            hang_seconds = _lc.default_hang_seconds()
        now = time.monotonic()
        with self._cv:
            if self._closed:
                return None
            if not self._thread.is_alive():
                reason = "died"
            elif hang_seconds > 0 and self._busy_since is not None \
                    and now - self._busy_since > float(hang_seconds):
                reason = "hung"
            else:
                return None
            failed = self._inflight or []
            self._inflight = None
            self._busy_since = None
            self._worker_gen += 1
            self._restarts += 1
            self._degraded = True
            self._thread = self._start_worker()
            self._cv.notify_all()
        for r in failed:
            r.fail(RequestAborted(
                f"{self.name}: batcher worker {reason}; request "
                f"{r.request_id} failed by the watchdog — retry on "
                "another replica"))
        # the watchdog event goes out before the breaker trip: the
        # flight recorder dumps on both, and the restart is the incident
        _m.WATCHDOG_RESTARTS.inc(model=self.name)
        _telemetry.FAULT.publish(site="serving.worker", event="watchdog",
                                 kind=reason, model=self.name,
                                 riders=len(failed),
                                 request_ids=[r.request_id for r in failed])
        self.breaker.trip(f"worker {reason}")
        return reason

    @property
    def state(self) -> str:
        """This model's serving state (``lifecycle.SERVING`` /
        ``DEGRADED`` / ``UNHEALTHY`` / ``DRAINING``)."""
        with self._cv:
            if self._closed:
                return _lc.DRAINING
            worker_dead = not self._thread.is_alive()
        bs = self.breaker.state
        if worker_dead or bs == _lc.OPEN:
            return _lc.UNHEALTHY
        if self._degraded or bs == _lc.HALF_OPEN:
            return _lc.DEGRADED
        return _lc.SERVING

    @property
    def restarts(self) -> int:
        with self._cv:
            return self._restarts

    # -- lifecycle ------------------------------------------------------
    @property
    def pending(self) -> int:
        """Requests queued or riding the in-flight dispatch."""
        with self._cv:
            return len(self._queue) + len(self._inflight or ())

    @property
    def idle(self) -> bool:
        with self._cv:
            return not self._queue and self._busy_since is None

    def active_request_ids(self) -> dict:
        """Request ids queued and riding the in-flight dispatch (the
        flight recorder's serving section)."""
        with self._cv:
            return {"queued": [r.request_id for r in self._queue],
                    "inflight": [r.request_id
                                 for r in (self._inflight or ())]}

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop intake.  ``drain=True`` lets the worker finish everything
        queued (coalescing without waiting out the delay window);
        ``drain=False`` fails queued requests at once.  Requests still
        pending when the worker cannot finish inside ``timeout`` seconds
        are failed and that worker generation is retired.  Idempotent."""
        with self._cv:
            self._closed = True
            dropped = []
            if not drain:
                dropped = list(self._queue)
                self._queue.clear()
            self._cv.notify_all()
        for r in dropped:
            r.fail(MXNetError(f"batcher {self.name!r} closed"))
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            with self._cv:
                self._worker_gen += 1
                stranded = list(self._queue)
                self._queue.clear()
                stranded.extend(self._inflight or ())
                self._inflight = None
                self._busy_since = None
            for r in stranded:
                r.fail(RequestAborted(
                    f"batcher {self.name!r}: drain timed out after "
                    f"{timeout}s; request {r.request_id} abandoned"))
        with self._cv:
            _m.QUEUE_DEPTH.set(0, model=self.name)

    @property
    def closed(self) -> bool:
        return self._closed

    def stats(self) -> dict:
        """The reference's key set."""
        with self._cv:
            depth = len(self._queue)
            restarts = self._restarts
        return {"model": self.name, "queue_depth": depth,
                "queue_size": self.queue_size,
                "max_batch_size": self.max_batch_size,
                "max_delay_ms": self.max_delay * 1000.0,
                "default_timeout_ms": self.default_timeout_ms,
                "closed": self._closed,
                "state": self.state,
                "breaker": self.breaker.state,
                "watchdog_restarts": restarts,
                "buckets": list(self.engine.buckets),
                "compiled_programs": self.engine.compiled_programs()}


class _GenRequest:
    """One generation request: a prompt, a token budget, and a stream of
    emitted tokens.  Tokens arrive on ``_q`` and accumulate in
    ``tokens_out``; ``event`` fires once, at finish.  ``logprobs_out[i]``
    is the top-N logprobs record of ``tokens_out[i]``, appended before the
    token is queued."""

    def __init__(self, tokens, budget, eos_id=None, deadline=None,
                 model="?", request_id=None, trace_ctx=None,
                 sampling=None):
        self.tokens = tokens            # prompt, np int32 1-D
        self.n = int(tokens.shape[0])
        self.budget = int(budget)       # max tokens to emit
        self.eos_id = eos_id
        self.sampling = sampling
        self.seed = sampling.seed if sampling is not None else None
        self.logprobs_n = int(sampling.logprobs) if sampling else 0
        self.logprobs_out: List[dict] = []
        self.stops = tuple(sampling.stop) if sampling else ()
        self._machine: Optional[JsonMaskMachine] = None
        self.deadline = deadline        # absolute monotonic, or None
        self.model = model
        self.request_id = request_id or _telemetry.new_request_id()
        self.trace_ctx = trace_ctx      # the submitter's span
        self.event = threading.Event()
        self.error = None
        self.tokens_out: List[int] = []
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_emit = self.t_submit     # time of the last emission
        self.slot: Optional[int] = None
        # speculative decoding: tokens the draft proposed for this request
        # and how many of them the target kept
        self.draft_tokens = 0
        self.accepted_tokens = 0
        self._q = _pyqueue.Queue()
        self._cancelled = False

    # -- producer side (worker thread) ----------------------------------
    def _emit(self, toks) -> float:
        """Append ``toks`` (one token, or a burst's) and queue them;
        returns the gap since the last emission per token (a burst's gap
        is spread evenly over its tokens)."""
        now = time.monotonic()
        if self.t_first is None:
            self.t_first = now
        gap = (now - self.t_emit) / max(1, len(toks))
        for _ in toks:
            _m.TOKEN_LATENCY.observe(gap)
        self.t_emit = now
        self.tokens_out.extend(toks)
        for t in toks:
            self._q.put(("tok", t))
        return gap

    def _finish(self, error=None) -> None:
        if self.event.is_set():
            return
        self.error = error
        self.event.set()
        self._q.put(("end", error))

    def fail(self, err: Exception) -> None:
        self._finish(err)

    # -- consumer side --------------------------------------------------
    def cancel(self) -> None:
        """Free this request's slot at the next step boundary."""
        self._cancelled = True

    @property
    def done(self) -> bool:
        return self.event.is_set()

    def _bounded_wait(self, timeout):
        wait = timeout
        if self.deadline is not None:
            # a small grace so the worker's own boundary check (which
            # frees the slot, stage "decode") wins the race
            remaining = max(0.0, self.deadline - time.monotonic()) + 0.25
            wait = remaining if timeout is None else min(timeout, remaining)
        return wait

    def _expired(self) -> bool:
        return self.deadline is not None \
            and time.monotonic() >= self.deadline

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until generation finishes; return ALL emitted tokens.
        Re-raises worker-side errors; crossing the deadline raises
        ``DeadlineExceeded``, a bare ``timeout`` ``TimeoutError``."""
        if not self.event.wait(self._bounded_wait(timeout)):
            if self._expired():
                raise _lc.DeadlineExceeded(
                    f"{self.model}: generation request {self.request_id} "
                    "deadline exceeded")
            raise TimeoutError("generation request timed out")
        if self.error is not None:
            raise self.error
        return list(self.tokens_out)

    def stream(self, timeout: Optional[float] = None):
        """Yield tokens as the worker emits them.  Closing the generator
        early cancels the request; ``Cancelled`` is swallowed."""
        try:
            while True:
                try:
                    kind, val = self._q.get(
                        timeout=self._bounded_wait(timeout))
                except _pyqueue.Empty:
                    if self._expired():
                        raise _lc.DeadlineExceeded(
                            f"{self.model}: generation request "
                            f"{self.request_id} deadline exceeded")
                    raise TimeoutError("generation stream timed out")
                if kind == "tok":
                    yield val
                    continue
                if val is not None and not isinstance(val, Cancelled):
                    raise val
                return
        finally:
            if not self.event.is_set():
                self.cancel()


class _MultiGenRequest:
    """An ``n > 1`` fan-out: one handle over ``n`` child requests, each
    decoding in its own slot under a derived seed (candidate 0 keeps the
    request seed).  ``result()`` returns candidate 0's tokens,
    ``results()`` all of them."""

    def __init__(self, children, request_id: str):
        self.children = list(children)
        self.request_id = request_id

    @property
    def seed(self):
        return self.children[0].seed

    @property
    def request_ids(self):
        return [r.request_id for r in self.children]

    @property
    def accepted_tokens(self) -> int:
        return sum(r.accepted_tokens for r in self.children)

    @property
    def draft_tokens(self) -> int:
        return sum(r.draft_tokens for r in self.children)

    @property
    def logprobs_n(self) -> int:
        return self.children[0].logprobs_n

    @property
    def logprobs_out(self):
        return self.children[0].logprobs_out

    @property
    def done(self) -> bool:
        return all(r.done for r in self.children)

    def cancel(self) -> None:
        for r in self.children:
            r.cancel()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        return self.results(timeout)[0]

    def results(self, timeout: Optional[float] = None) -> List[List[int]]:
        """Block for every candidate; their token lists in candidate
        order.  The first child error re-raises and cancels the rest."""
        out = []
        try:
            for r in self.children:
                out.append(r.result(timeout))
        except Exception:
            self.cancel()
            raise
        return out


class ContinuousBatcher(DynamicBatcher):
    """Continuous-batching front-end over one generation engine; its
    queue, breaker, watchdog generations and worker thread are
    :class:`DynamicBatcher`'s, as in the reference.

    Knobs come from the serving env variables: ``MXNET_SERVE_QUEUE``
    (128; or ``queue_size``) bounds the requests waiting for a slot,
    ``MXNET_SERVE_TIMEOUT_MS`` (0: none) is the default deadline,
    ``MXNET_SERVE_BREAKER_*`` set the breaker, ``MXNET_RETRY_*`` the
    dispatch retries, ``MXNET_SAMPLING_MAX_STOPS`` (4) the stop sequences
    per request, ``MXNET_SERVE_KV_STARVE_SWEEPS`` (3) the watchdog sweeps
    of an exhausted KV pool that flip :attr:`kv_starved`.  The
    constructor takes :class:`DynamicBatcher`'s arguments (a server passes
    its batcher defaults to either kind; ``max_batch_size`` defaults to
    the slot count, ``max_delay_ms`` is kept but unused: slots join at
    step boundaries) and ``token_strs``, JSON mode's token strings
    (default byte-level)."""

    def __init__(self, engine, token_strs=None, **kw):
        kw.setdefault("max_batch_size", engine.max_slots)
        self._token_strs = list(token_strs) if token_strs is not None \
            else None
        self._max_stops = max(1, getenv_int("MXNET_SAMPLING_MAX_STOPS", 4))
        self._slots: List[Optional[_GenRequest]] = \
            [None] * int(engine.max_slots)
        self._step = 0
        self._tokens_emitted = 0
        self._peak_slots = 0
        self._burst_dispatches = 0
        # one step = one target dispatch; tokens are counted per live
        # slot, so per-step decode reads 1.0 and bursts approach 1/k
        self._dpt_dispatches = 0
        self._dpt_tokens = 0.0
        # speculative steps: verify dispatches, and per live slot-step the
        # tokens emitted, drafted and accepted
        self._spec_dispatches = 0
        self._spec_slot_steps = 0
        self._spec_emitted = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._stop_hits = 0
        self._stop_trimmed = 0
        self._kv_starved_sweeps = 0
        self._kv_starve_threshold = max(1, getenv_int(
            "MXNET_SERVE_KV_STARVE_SWEEPS", 3))
        self._decode_health_last: Optional[dict] = None
        self._nonfinite_generations = 0
        super().__init__(engine, **kw)      # starts the worker: last

    # -- submit ---------------------------------------------------------
    def _token_strings(self):
        """Token id -> string for JSON mode's machine: byte-level
        (``chr(id)``), as the JAX batcher's default, made at the first
        constrained request."""
        if self._token_strs is None:
            self._token_strs = [chr(i)
                                for i in range(int(self.engine.vocab_size))]
        return self._token_strs

    def submit_async(self, tokens, max_new_tokens: int = 32,
                     timeout_ms: Optional[float] = None,
                     request_id: Optional[str] = None,
                     eos_id: Optional[int] = None,
                     sampling: Optional[SamplingParams] = None):
        """Enqueue one generation request; returns a handle whose
        ``stream()`` yields tokens as they are produced and whose
        ``result()`` blocks for the full list.  Raises
        :class:`QueueFullError` under backpressure, ``BreakerOpen`` while
        the breaker is OPEN, ``ValueError`` for an unservable prompt,
        budget or sampling parameter.

        ``sampling`` (None: greedy) is validated here and its
        ``logprobs`` clamped to the engine's ``logprobs_topn``; a sampled
        request without a seed gets one, stored on the handle, so the
        response is replayable.  ``sampling.n > 1`` fans out into ``n``
        child requests ``"{id}.{i}"`` over distinct slots with derived
        seeds, admitted all or none, behind one :class:`_MultiGenRequest`
        handle."""
        if request_id is None:
            request_id = _telemetry.new_request_id()
        if sampling is not None:
            sampling = sampling.validate(max_stops=self._max_stops,
                                         max_n=int(self.engine.max_slots))
            cap = int(self.engine.logprobs_topn)
            if sampling.logprobs > cap:
                sampling = replace(sampling, logprobs=cap)
            if sampling.sampled and sampling.seed is None:
                sampling = replace(
                    sampling,
                    seed=int.from_bytes(os.urandom(8), "big") >> 1)
        if sampling is None or sampling.n == 1:
            return self._submit_one(tokens, max_new_tokens, timeout_ms,
                                    request_id, eos_id, sampling)
        base = sampling.seed
        children: List[_GenRequest] = []
        try:
            for i in range(sampling.n):
                child = replace(sampling, n=1,
                                seed=derive_candidate_seed(base, i)
                                if base is not None else None)
                children.append(self._submit_one(
                    tokens, max_new_tokens, timeout_ms,
                    f"{request_id}.{i}", eos_id, child))
        except Exception:
            for c in children:          # no half-admitted fan-outs
                c.cancel()
            raise
        return _MultiGenRequest(children, request_id)

    def _submit_one(self, tokens, max_new_tokens, timeout_ms, request_id,
                    eos_id, sampling) -> _GenRequest:
        _fault.inject("serving.queue", model=self.name,
                      request_id=request_id)
        self.breaker.allow()
        toks = _np.asarray(tokens, _np.int32).reshape(-1)
        n = int(toks.shape[0])
        max_len = int(self.engine.max_len)
        if n < 1:
            raise ValueError(f"{self.name}: empty prompt")
        if n > max_len - 1:
            raise ValueError(
                f"{self.name}: prompt length {n} leaves no room to "
                f"generate (max_len {max_len})")
        budget = min(int(max_new_tokens), max_len - n)
        if budget < 1:
            raise ValueError(f"{self.name}: max_new_tokens must be >= 1")
        if timeout_ms is None:
            timeout_ms = self.default_timeout_ms
        req = _GenRequest(toks, budget, eos_id=eos_id,
                          deadline=_lc.deadline_from_ms(timeout_ms),
                          model=self.name, request_id=request_id,
                          trace_ctx=_telemetry.tracer.current(),
                          sampling=sampling)
        if sampling is not None and sampling.json_mode:
            req._machine = JsonMaskMachine(self._token_strings())
            _m.SAMPLE_CONSTRAINED.inc(model=self.name)
        with self._cv:
            if self._closed:
                raise MXNetError(f"batcher {self.name!r} is closed")
            # capacity-aware backpressure: admit no more queued requests
            # than the KV cache can serve 4 rounds of at this footprint
            streams = max(1, min(int(self.engine.max_slots),
                                 int(self.engine.kv_capacity_tokens())
                                 // (n + budget)))
            allowed = min(self.queue_size, 4 * streams)
            if len(self._queue) >= allowed:
                _m.REJECTED.inc(model=self.name)
                retry = max(1.0, min(30.0,
                                     self._avg_batch_seconds * budget))
                raise QueueFullError(
                    f"{self.name}: queue full ({len(self._queue)} "
                    f"pending, {allowed} admitted for this request "
                    "size) — backpressure", retry_after=retry)
            self._queue.append(req)
            _m.QUEUE_DEPTH.set(len(self._queue), model=self.name)
            self._cv.notify_all()
        _m.REQUESTS.inc(model=self.name)
        _m.SAMPLED_REQUESTS.inc(
            model=self.name,
            mode="sampled" if (sampling is not None and sampling.sampled)
            else "greedy")
        return req

    def submit(self, tokens, max_new_tokens: int = 32,
               timeout: Optional[float] = None,
               timeout_ms: Optional[float] = None,
               request_id: Optional[str] = None,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None) -> List[int]:
        """Synchronous generation: enqueue, wait, return all emitted
        tokens (the outcome's SLO record is made worker-side; admission
        failures are recorded here)."""
        if request_id is None:
            request_id = _telemetry.new_request_id()
        with _telemetry.trace_span("serve.request", cat="serving",
                                   model=self.name, request_id=request_id):
            try:
                req = self.submit_async(
                    tokens, max_new_tokens, timeout_ms=timeout_ms,
                    request_id=request_id, eos_id=eos_id,
                    sampling=sampling)
            except Exception:
                _slo.tracker.record(self.name, 0.0, ok=False)
                raise
            return req.result(timeout)

    # -- worker: the continuous loop ------------------------------------
    def _worker(self, gen: int):
        # a replaced worker's slots are not trusted: start clean.  The
        # reset waits on the engine's dispatch lock while the old worker
        # is inside a replay
        with self._cv:
            stale = [r for r in self._slots if r is not None]
            self._slots = [None] * int(self.engine.max_slots)
        if stale or gen > 0:
            self.engine.reset()
        for r in stale:     # the watchdog already failed inflight riders
            r._finish(RequestAborted(
                f"{self.name}: worker replaced; request {r.request_id} "
                "aborted"))
        while True:
            leavers, joins, live = self._boundary(gen)
            if leavers is None:
                return
            self._run_step(gen, leavers, joins)
            with self._cv:
                if gen == self._worker_gen:
                    self._busy_since = None
                    self._inflight = None

    def _expire_locked(self, req: _GenRequest) -> None:
        """Shed a request that expired in the queue (``_cv`` held)."""
        _m.DEADLINE_EXCEEDED.inc(model=self.name, stage="queue")
        _telemetry.FAULT.publish(site="serving.deadline", event="deadline",
                                 kind="queue", model=self.name,
                                 request_id=req.request_id)
        req.fail(_lc.DeadlineExceeded(
            f"{self.name}: request {req.request_id} expired in queue "
            f"after {time.monotonic() - req.t_submit:.3f}s"))

    def _boundary(self, gen: int):
        """One step boundary, under ``_cv``: collect cancelled and expired
        slots, shed expired queued requests, admit queued requests into
        free slots while the pool can reserve their blocks, and return
        ``(leavers, joins, live)`` once there is work — or three Nones
        when this worker generation is done (closed and drained, or
        replaced)."""
        with self._cv:
            while True:
                if gen != self._worker_gen:
                    return None, None, None
                now = time.monotonic()
                self._heartbeat = now
                leavers = []
                for s, r in enumerate(self._slots):
                    if r is None:
                        continue
                    if r._cancelled:
                        leavers.append((s, r, "cancelled"))
                        self._slots[s] = None
                    elif r.deadline is not None and r.deadline <= now:
                        leavers.append((s, r, "deadline"))
                        self._slots[s] = None
                while self._queue and self._queue[0].deadline is not None \
                        and self._queue[0].deadline <= now:
                    self._expire_locked(self._queue.popleft())
                joins = []
                free = [s for s, r in enumerate(self._slots) if r is None]
                reserved = 0    # blocks promised to earlier admits
                while self._queue and free:
                    req = self._queue[0]
                    if not self.engine.can_admit(
                            req.tokens, req.n + req.budget, reserved):
                        break   # head-of-line waits for blocks to free
                    self._queue.popleft()
                    reserved += self.engine.reserve_estimate(
                        req.n + req.budget)
                    slot = free.pop(0)
                    req.slot = slot
                    self._slots[slot] = req
                    joins.append((slot, req))
                live = [(s, r) for s, r in enumerate(self._slots)
                        if r is not None]
                _m.QUEUE_DEPTH.set(len(self._queue), model=self.name)
                _m.SLOTS_IN_USE.set(len(live), model=self.name)
                self._peak_slots = max(self._peak_slots, len(live))
                if leavers or joins or live:
                    self._busy_since = now
                    self._inflight = [r for _, r in live]
                    return leavers, joins, live
                if self._closed and not self._queue:
                    return None, None, None
                self._cv.wait(0.05)

    def _live(self):
        with self._cv:
            return [(s, r) for s, r in enumerate(self._slots)
                    if r is not None]

    def _run_step(self, gen: int, leavers, joins):
        """Outside the lock: settle leavers, prefill the joins, then ONE
        decode, burst or speculative step for every live slot, under a
        ``serve.batch`` span whose ``links`` carry every live request
        id."""
        self._step += 1
        live = self._live()
        rids = [r.request_id for _, r in live]
        head_ctx = live[0][1].trace_ctx if live else None
        attach = _telemetry.tracer.attach(head_ctx) \
            if head_ctx is not None else contextlib.nullcontext()
        with attach, _telemetry.trace_span(
                "serve.batch", cat="serving", model=self.name,
                step=self._step, slots=len(live), links=rids):
            for slot, req, reason in leavers:
                self._leave(slot, req, reason)
            for slot, req in joins:
                self._join(slot, req)
            live = self._live()
            if not live:
                return
            # a constrained slot's mask changes at every emit: a burst or
            # the (spec_k + 1)-wide verify would sample past a stale mask
            dyn = any(r._machine is not None for _, r in live)
            if not dyn and self.engine.draft is not None:
                self._spec_once(gen, live)
            elif not dyn and self._burst_ready(live):
                self._decode_burst_once(gen, live)
            else:
                self._decode_once(gen, live)

    def _join(self, slot: int, req: _GenRequest):
        """Admit one request mid-flight: its prefill runs between decode
        steps and emits the first token."""
        with _telemetry.trace_span("slot.join", cat="serving",
                                   model=self.name, slot=slot,
                                   request_id=req.request_id,
                                   prompt_tokens=req.n):
            try:
                # the sampling state (and JSON mode's first mask) goes
                # into the slot before the prefill samples its first token
                self.engine.set_slot_sampling(slot, req.sampling)
                if req._machine is not None:
                    self.engine.update_slot_bias(
                        slot, req._machine.mask(budget=req.budget))
                first = self.engine.prefill(
                    req.tokens, slot, reserve_tokens=req.n + req.budget)
            except Exception as e:
                # a failed prefill fails its own request and nobody else's
                with self._cv:
                    if self._slots[slot] is req:
                        self._slots[slot] = None
                self._fail(req, e)
                return
        lp = self.engine.last_prefill_logprobs()
        if lp is not None:
            self._push_logprobs(req, lp[0], lp[1])
        self._emit(req, [first])
        self._advance_machine(slot, req, first)
        if self._finished(req):
            self._free_slot(slot, req, "finished")

    def _dispatch(self, gen: int, live, call):
        """One engine dispatch for ``live`` under the ``serving.infer``
        fault site and retry policy: ``call()`` on success (the host
        seconds folded into the step EWMA, the breaker closed), None after
        :meth:`_decode_failed` when it failed after retries.  The fault
        site fires before the engine's lock is taken, and a superseded
        worker stops here."""
        rids = [r.request_id for _, r in live]
        _m.BATCHES.inc(model=self.name)
        _m.BATCH_SIZE.observe(len(live))

        def run():
            _fault.inject("serving.infer", model=self.name,
                          request_ids=rids)
            if self._current_gen() != gen:
                raise RequestAborted(f"{self.name}: stale worker generation")
            return call()

        t0 = time.monotonic()
        try:
            out = _fault.retry_call(run, site="serving.infer",
                                    policy=self.retry_policy)
        except Exception as e:
            self._decode_failed(gen, live, e)
            return None
        dt = time.monotonic() - t0
        _m.DECODE_STEP.observe(dt)
        self._avg_batch_seconds = dt if self._avg_batch_seconds <= 0.0 \
            else 0.8 * self._avg_batch_seconds + 0.2 * dt
        self._degraded = False
        self.breaker.record_success()
        return out, dt

    def _count_dispatch(self, tokens_per_slot: float) -> None:
        self._dpt_dispatches += 1
        self._dpt_tokens += tokens_per_slot
        _m.DISPATCHES_PER_TOKEN.set(
            self._dpt_dispatches / max(self._dpt_tokens, 1e-9),
            model=self.name)

    def _step_inputs(self, live):
        S = int(self.engine.max_slots)
        last = _np.zeros(S, _np.int32)
        pos = _np.zeros(S, _np.int32)
        for s, r in live:
            last[s] = r.tokens_out[-1]
            pos[s] = r.n + len(r.tokens_out) - 1
        return last, pos

    def _decode_once(self, gen: int, live):
        """ONE decode dispatch for every slot (free slots ride along at
        position 0); emit each live slot's token and free finished
        slots."""
        last, pos = self._step_inputs(live)
        got = self._dispatch(gen, live,
                             lambda: self.engine.decode(last, pos))
        if got is None:
            return
        nxt, _ = got
        self._count_dispatch(1.0)
        self._fold_decode_health(live)
        lp = self.engine.last_logprobs()             # (S, N) pair or None
        for s, r in live:
            if lp is not None:
                self._push_logprobs(r, lp[0][s], lp[1][s])
            tok = int(nxt[s])
            self._emit(r, [tok])
            self._advance_machine(s, r, tok)
            if self._finished(r):
                self._free_slot(s, r, "finished")

    def _burst_ready(self, live) -> bool:
        """Steady-state gate for the burst path: no join, cancel or
        deadline check can land inside a k-step burst, so take it only
        when nothing is queued, no rider has asked to cancel, and every
        live deadline clears k x the per-dispatch EWMA."""
        k = int(self.engine.scan_steps)
        if k < 1:
            return False
        with self._cv:
            if self._queue:
                return False
        horizon = time.monotonic() + k * max(self._avg_batch_seconds, 1e-4)
        return not any(r._cancelled or (r.deadline is not None
                                        and r.deadline <= horizon)
                       for _, r in live)

    def _decode_burst_once(self, gen: int, live):
        """ONE burst advances every live slot by up to ``scan_steps``
        tokens; emit each slot's prefix and free finished slots.  The same
        tokens as that many :meth:`_decode_once` steps."""
        S = int(self.engine.max_slots)
        last, pos = self._step_inputs(live)
        bud = _np.ones(S, _np.int32)
        eos = _np.full(S, -1, _np.int32)
        act = _np.zeros(S, bool)
        for s, r in live:
            bud[s] = r.budget - len(r.tokens_out)
            if r.eos_id is not None:
                eos[s] = int(r.eos_id)
            act[s] = True
        got = self._dispatch(gen, live, lambda: self.engine.decode_burst(
            last, pos, bud, eos, act))
        if got is None:
            return
        (toks, emitted), _ = got
        self._fold_decode_health(live)
        self._burst_dispatches += 1
        lp = self.engine.last_logprobs()             # (k, S, N) pair or None
        total = 0
        for s, r in live:
            n = int(emitted[s])
            if n < 1:
                continue
            new = [int(t) for t in toks[:n, s]]
            stopped = False
            if r.stops:
                # keep through the stop sequence; the burst's tokens past
                # it never reach the stream
                kept, stopped = stop_trim(r.tokens_out, new, r.stops)
                if stopped:
                    self._stop_hits += 1
                    self._stop_trimmed += n - kept
                    _m.SAMPLE_STOP_HITS.inc(model=self.name)
                    _m.SAMPLE_STOP_TRIMMED.inc(n - kept, model=self.name)
                    new, n = new[:kept], kept
            if lp is not None:
                for j in range(n):
                    self._push_logprobs(r, lp[0][j, s], lp[1][j, s])
            self._emit(r, new)
            total += n
            if stopped or self._finished(r):
                self._free_slot(s, r, "finished")
        _m.DECODE_BURST_TOKENS.observe(total)
        self._count_dispatch(total / max(1, len(live)))

    def _fold_decode_health(self, live):
        """Health plane: fold the dispatch's per-slot logit stats
        (``engine.last_decode_health``, already on the host) into the
        ``mxtpu_health_*`` series, and a non-finite row into a
        ``nonfinite_generation`` anomaly naming the implicated requests."""
        hd = self.engine.last_decode_health()
        if hd is None or not live:
            return
        lmax, ent, fin = hd
        slots = [s for s, _ in live]
        self._decode_health_last = {
            "step": self._step,
            "logit_max": float(lmax[slots].max()),
            "entropy_mean": float(ent[slots].mean()),
            "finite": bool(fin[slots].all()),
        }
        _m.HEALTH_LOGIT_MAX.set(self._decode_health_last["logit_max"],
                                model=self.name)
        _m.HEALTH_DECODE_ENTROPY.set(
            self._decode_health_last["entropy_mean"], model=self.name)
        bad = [r.request_id for s, r in live if not bool(fin[s])]
        if bad:
            self._nonfinite_generations += 1
            _m.NONFINITE_GENERATIONS.inc(model=self.name)
            _health.serving_anomaly(
                self.name, self._step, bad,
                detail=f"non-finite decode logits at step {self._step} "
                       f"for request(s) {', '.join(bad)}")

    def _spec_once(self, gen: int, live):
        """ONE speculative step (the draft's proposals, then one verify)
        advances every live slot by 1 to ``spec_k + 1`` tokens, emitted
        one at a time with the finish check after each.  The same tokens
        as that many :meth:`_decode_once` steps; joins and leaves stay at
        step boundaries, so a joining request never sees a neighbour's
        rollback."""
        k = int(self.engine.spec_k)
        last, pos = self._step_inputs(live)
        got = self._dispatch(gen, live,
                             lambda: self.engine.spec_step(last, pos))
        if got is None:
            return
        (out, accepted), dt = got
        _m.SPEC_STEP.observe(dt)
        # free slots ride along at position 0: only live slots count, and
        # a budget or eos cut inside the step caps the accepted count
        lp = self.engine.last_verify_logprobs()   # (S, Q, N) pair or None
        step_emitted = 0
        for s, r in live:
            n_emit = 0
            for j in range(int(accepted[s]) + 1):
                if lp is not None:
                    self._push_logprobs(r, lp[0][s, j], lp[1][s, j])
                self._emit(r, [int(out[s, j])])
                n_emit += 1
                if self._finished(r):
                    self._free_slot(s, r, "finished")
                    break
            r.draft_tokens += k
            r.accepted_tokens += n_emit - 1
            step_emitted += n_emit
        step_accepted = step_emitted - len(live)
        self._spec_dispatches += 1
        self._spec_slot_steps += len(live)
        self._spec_emitted += step_emitted
        self._spec_drafted += len(live) * k
        self._spec_accepted += step_accepted
        _m.SPEC_DISPATCHES.inc(model=self.name)
        _m.SPEC_DRAFT_TOKENS.inc(len(live) * k, model=self.name)
        _m.SPEC_ACCEPTED_TOKENS.inc(step_accepted, model=self.name)
        _m.SPEC_TOKENS_PER_DISPATCH.set(
            self._spec_emitted / self._spec_slot_steps, model=self.name)
        _m.SPEC_ACCEPT_RATE.set(
            self._spec_accepted / max(1, self._spec_drafted),
            model=self.name,
            mode="sampled" if any(
                r.sampling is not None and r.sampling.sampled
                for _, r in live) else "greedy")
        self._count_dispatch(step_emitted / max(1, len(live)))

    # -- step-boundary helpers ------------------------------------------
    def _emit(self, req: _GenRequest, toks) -> None:
        """Emit one token or a burst's: the stream, the counters and one
        token-latency SLO record per token."""
        gap = req._emit(toks)
        n = len(toks)
        self._tokens_emitted += n
        _m.GENERATE_TOKENS.inc(n, model=self.name)
        if n and req.sampling is not None and req.sampling.sampled:
            _m.SAMPLE_TOKENS.inc(n, model=self.name)
        for _ in range(n):
            _slo.tracker.record_token(self.name, gap)

    def _push_logprobs(self, req: _GenRequest, vals, ids) -> None:
        """Append one per-token top-N record (sliced to the request's
        clamp) for the token about to be emitted."""
        n = req.logprobs_n
        if n < 1:
            return
        req.logprobs_out.append({"token_ids": [int(i) for i in ids[:n]],
                                 "logprobs": [float(v) for v in vals[:n]]})

    def _advance_machine(self, slot: int, req: _GenRequest, tok: int):
        """JSON mode's emit boundary: feed the emitted token to the
        request's machine and install the next step's mask."""
        m = req._machine
        if m is None:
            return
        m.advance(int(tok))
        if not m.done:
            self.engine.update_slot_bias(
                slot, m.mask(budget=req.budget - len(req.tokens_out)))

    def _finished(self, req: _GenRequest) -> bool:
        if len(req.tokens_out) >= req.budget:
            return True
        if req.eos_id is not None and req.tokens_out[-1] == int(req.eos_id):
            return True
        if req._machine is not None and req._machine.done:
            return True
        out = req.tokens_out
        for stop in req.stops:
            if len(out) >= len(stop) and tuple(out[-len(stop):]) == stop:
                self._stop_hits += 1
                _m.SAMPLE_STOP_HITS.inc(model=self.name)
                return True
        return False

    def _free_slot(self, slot: int, req: _GenRequest, reason: str):
        with self._cv:
            if self._slots[slot] is req:
                self._slots[slot] = None
            _m.SLOTS_IN_USE.set(
                sum(1 for r in self._slots if r is not None),
                model=self.name)
        self._leave(slot, req, reason)

    def _leave(self, slot: int, req: _GenRequest, reason: str):
        """Return the slot's KV blocks to the pool and settle the request:
        ok when finished, ``Cancelled`` for a consumer that went away,
        ``DeadlineExceeded`` (stage decode) for a budget bust."""
        self.engine.release_slot(slot)
        with _telemetry.trace_span("slot.leave", cat="serving",
                                   model=self.name, slot=slot,
                                   request_id=req.request_id, reason=reason,
                                   tokens=len(req.tokens_out)):
            pass
        dt = time.monotonic() - req.t_submit
        if reason == "finished":
            _m.LATENCY.observe(dt)
            _slo.tracker.record(self.name, dt, ok=True)
            req._finish(None)
        elif reason == "cancelled":
            _m.CANCELLED.inc(model=self.name)
            _telemetry.FAULT.publish(
                site="serving.generate", event="cancelled",
                model=self.name, request_id=req.request_id,
                tokens=len(req.tokens_out))
            # a cancel is the client's choice, not an SLO burn
            req._finish(Cancelled(
                f"{self.name}: request {req.request_id} cancelled after "
                f"{len(req.tokens_out)} tokens"))
        elif reason == "deadline":
            _m.DEADLINE_EXCEEDED.inc(model=self.name, stage="decode")
            _telemetry.FAULT.publish(
                site="serving.deadline", event="deadline", kind="decode",
                model=self.name, request_id=req.request_id,
                tokens=len(req.tokens_out))
            _slo.tracker.record(self.name, dt, ok=False)
            req._finish(_lc.DeadlineExceeded(
                f"{self.name}: request {req.request_id} deadline "
                f"exceeded mid-decode after {len(req.tokens_out)} tokens"))
        else:
            _slo.tracker.record(self.name, dt, ok=False)
            req._finish(RequestAborted(
                f"{self.name}: request {req.request_id} aborted "
                f"({reason})"))

    def _fail(self, req: _GenRequest, err: Exception):
        _slo.tracker.record(self.name, time.monotonic() - req.t_submit,
                            ok=False)
        _telemetry.FAULT.publish(
            site="serving.generate", event="error",
            kind=type(err).__name__, model=self.name,
            request_id=req.request_id)
        req._finish(err)

    def _decode_failed(self, gen: int, live, err: Exception):
        """A dispatch failed after retries.  The cache is shared and was
        being written in place, so fail every rider, free all slots and
        reset the engine (its pool and tables included) so the next
        admission starts clean; a superseded worker leaves the reset to
        its successor."""
        if _tdev.is_oom(err):
            # the engine reported the failure; only the batcher knows the
            # riders
            _tdev.report_oom("serving.infer", err, model=self.name,
                             request_ids=[r.request_id for _, r in live])
        _telemetry.FAULT.publish(
            site="serving.infer", event="fallback",
            kind=type(err).__name__, model=self.name, requests=len(live),
            request_ids=[r.request_id for _, r in live])
        _m.FALLBACKS.inc(model=self.name)
        self.breaker.record_failure(
            f"decode dispatch failed: {type(err).__name__}")
        with self._cv:
            for s, r in live:
                if self._slots[s] is r:
                    self._slots[s] = None
            _m.SLOTS_IN_USE.set(0, model=self.name)
            current = gen == self._worker_gen
        if current:
            self.engine.reset()
        for _, r in live:
            self._fail(r, err)

    # -- watchdog plane -------------------------------------------------
    def check_worker(self, hang_seconds: Optional[float] = None):
        """:meth:`DynamicBatcher.check_worker` (the riders failed are the
        slots' requests), after sampling KV starvation: a paged pool with
        no free block for ``MXNET_SERVE_KV_STARVE_SWEEPS`` consecutive
        sweeps sets :attr:`kv_starved`."""
        pool = self.engine.pool
        if pool is not None:
            if pool.free_blocks == 0:
                self._kv_starved_sweeps += 1
                if self._kv_starved_sweeps == self._kv_starve_threshold:
                    _telemetry.FAULT.publish(
                        site="serving.kv", event="starved",
                        kind="exhausted", model=self.name,
                        sweeps=self._kv_starved_sweeps)
            else:
                self._kv_starved_sweeps = 0
        return super().check_worker(hang_seconds)

    @property
    def kv_starved(self) -> bool:
        """True while the paged pool has been exhausted for
        ``MXNET_SERVE_KV_STARVE_SWEEPS`` consecutive watchdog sweeps."""
        return self._kv_starved_sweeps >= self._kv_starve_threshold

    # -- lifecycle / introspection ---------------------------------------
    @property
    def idle(self) -> bool:
        with self._cv:
            return not self._queue and all(r is None for r in self._slots)

    @property
    def pending(self) -> int:
        """Requests queued or holding a slot."""
        with self._cv:
            return len(self._queue) \
                + sum(1 for r in self._slots if r is not None)

    def active_request_ids(self) -> dict:
        """Request ids queued and holding slots (the flight recorder's
        serving section)."""
        with self._cv:
            return {"queued": [r.request_id for r in self._queue],
                    "inflight": [r.request_id for r in self._slots
                                 if r is not None]}

    def slots_in_use(self) -> int:
        with self._cv:
            return sum(1 for r in self._slots if r is not None)

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop intake.  ``drain=True`` lets the worker finish everything
        queued; ``drain=False`` fails queued requests at once.  Requests
        still pending when the worker cannot finish inside ``timeout``
        seconds are failed, and that worker generation is retired.
        Idempotent."""
        with self._cv:
            self._closed = True
            dropped = []
            if not drain:
                dropped = list(self._queue)
                self._queue.clear()
            self._cv.notify_all()
        for r in dropped:
            r.fail(MXNetError(f"batcher {self.name!r} closed"))
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            with self._cv:
                self._worker_gen += 1
                stranded = list(self._queue) + [
                    r for r in self._slots if r is not None]
                self._queue.clear()
                self._inflight = None
                self._busy_since = None
            for r in stranded:
                r.fail(RequestAborted(
                    f"batcher {self.name!r}: drain timed out after "
                    f"{timeout}s; request {r.request_id} abandoned"))
        with self._cv:
            _m.QUEUE_DEPTH.set(0, model=self.name)

    def stats(self) -> dict:
        """The reference's key set (its ``DynamicBatcher.stats`` keys,
        ``max_delay_ms`` aside, plus the generation keys), then the
        engine's KV statistics."""
        eng = self.engine
        bs = self.breaker.state
        state = self.state
        with self._cv:
            out = {
                "model": self.name,
                "queue_depth": len(self._queue),
                "queue_size": self.queue_size,
                "max_batch_size": self.max_batch_size,
                "default_timeout_ms": self.default_timeout_ms,
                "closed": self._closed,
                "state": state,
                "breaker": bs,
                "watchdog_restarts": self._restarts,
                "buckets": list(eng.buckets),
                "compiled_programs": eng.compiled_programs(),
                "kind": "generation",
                "max_slots": int(eng.max_slots),
                "max_len": int(eng.max_len),
                "slots_in_use": sum(1 for r in self._slots
                                    if r is not None),
                "decode_steps": self._step,
                "decode_scan_steps": int(eng.scan_steps),
                "decode_burst_dispatches": self._burst_dispatches,
                "tokens_emitted": self._tokens_emitted,
                "peak_slots_in_use": self._peak_slots,
                "prefill_buckets": list(eng.prefill_buckets),
                "kv_cache_bytes": int(eng.cache_bytes),
                "kv_starved": self.kv_starved,
                "dispatches_per_token":
                    self._dpt_dispatches / max(self._dpt_tokens, 1e-9)
                    if self._dpt_dispatches else None,
                "logprobs_topn": int(eng.logprobs_topn),
                "stop_hits": self._stop_hits,
                "stop_trimmed_tokens": self._stop_trimmed,
            }
            if eng.draft is not None:
                out.update({
                    "spec_k": int(eng.spec_k),
                    "spec_draft_model": eng.draft.name,
                    "spec_dispatches": self._spec_dispatches,
                    "accepted_tokens_per_dispatch":
                        self._spec_emitted / max(1, self._spec_slot_steps),
                    "spec_accept_rate":
                        self._spec_accepted / max(1, self._spec_drafted),
                })
            out.update(eng.kv_stats())
            if self._decode_health_last is not None:
                out["decode_health"] = dict(self._decode_health_last)
                out["nonfinite_generations"] = self._nonfinite_generations
        return out
