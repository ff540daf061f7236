"""Continuous batching over one :class:`~.engine.GenerationEngine`
(counterpart of the core of ``incubator_mxnet_tpu/serving/batcher.py``'s
``ContinuousBatcher``).

A worker thread runs step boundaries: free the slots of cancelled
requests, admit queued requests into free slots (one ``prefill`` each,
emitting the first token), then advance every live slot with one
``decode`` — or with one ``decode_burst`` of up to ``engine.scan_steps``
tokens when the boundary sees steady state (nothing queued, nothing
cancelled), or, when the engine has a draft attached, with one
speculative step of 1 to ``spec_k + 1`` tokens per slot.  Tokens stream
back per request as they are produced, so a late request emits its first
token while earlier ones are still decoding.

The request features ride on the same engine programs: per-token top-N
logprobs (read from the program outputs after each step), stop
sequences (trimmed at the emit boundary, a burst's over-generated tail
included), ``n > 1`` candidates (one child request per slot with derived
seeds) and JSON mode (a :class:`~.sampling.JsonMaskMachine` whose mask
becomes the slot's logit-bias row before every step; a constrained slot
keeps the whole batch on the per-step decode path)."""
from __future__ import annotations

import os
import queue as _pyqueue
import threading
import time
import uuid
from collections import deque
from dataclasses import replace
from typing import List, Optional

import numpy as _np

from ..base import MXNetError, getenv_int
from .sampling import (JsonMaskMachine, SamplingParams,
                       derive_candidate_seed, stop_trim)

__all__ = ["ContinuousBatcher", "QueueFullError", "Cancelled",
           "RequestAborted"]


class QueueFullError(MXNetError):
    """The batcher's queue is full (backpressure)."""


class Cancelled(MXNetError):
    """The request was cancelled by its consumer."""


class RequestAborted(MXNetError):
    """The request was failed by the server (dispatch error, close)."""


class _GenRequest:
    """One generation request: a prompt, a token budget, and a stream of
    emitted tokens.  Tokens arrive on ``_q`` and accumulate in
    ``tokens_out``; ``event`` fires once, at finish.  ``logprobs_out[i]``
    is the top-N logprobs record of ``tokens_out[i]`` when the request
    asked for logprobs, appended before the token is queued."""

    def __init__(self, tokens, budget, eos_id=None, request_id=None,
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
        self.request_id = request_id or uuid.uuid4().hex[:16]
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
    def _emit(self, toks) -> None:
        now = time.monotonic()
        if self.t_first is None:
            self.t_first = now
        self.t_emit = now
        self.tokens_out.extend(toks)
        for t in toks:
            self._q.put(("tok", t))

    def _finish(self, error=None) -> None:
        if self.event.is_set():
            return
        self.error = error
        self.event.set()
        self._q.put(("end", error))

    # -- consumer side --------------------------------------------------
    def cancel(self) -> None:
        """Free this request's slot at the next step boundary."""
        self._cancelled = True

    @property
    def done(self) -> bool:
        return self.event.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until generation finishes; return ALL emitted tokens.
        Re-raises worker-side errors; a bare ``timeout`` raises
        ``TimeoutError``."""
        if not self.event.wait(timeout):
            raise TimeoutError("generation request timed out")
        if self.error is not None:
            raise self.error
        return list(self.tokens_out)

    def stream(self, timeout: Optional[float] = None):
        """Yield tokens as the worker emits them.  Closing the generator
        early cancels the request."""
        try:
            while True:
                try:
                    kind, val = self._q.get(timeout=timeout)
                except _pyqueue.Empty:
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


class ContinuousBatcher:
    """Continuous-batching front-end over one generation engine.

    ``queue_size`` (default ``MXNET_SERVE_QUEUE`` = 128) bounds the
    requests waiting for a slot; beyond it :meth:`submit_async` raises
    :class:`QueueFullError`."""

    def __init__(self, engine, *, queue_size: Optional[int] = None,
                 name: Optional[str] = None):
        self.engine = engine
        self.name = str(name or engine.name)
        self._token_strs = None
        if queue_size is None:
            queue_size = getenv_int("MXNET_SERVE_QUEUE", 128)
        self.queue_size = max(1, int(queue_size))
        self._slots: List[Optional[_GenRequest]] = \
            [None] * int(engine.max_slots)
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._step = 0
        self._tokens_emitted = 0
        self._peak_slots = 0
        self._burst_dispatches = 0
        # one step = one engine dispatch; tokens are counted per live
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
        # stop sequences: requests finished by one, tokens a burst
        # generated past one
        self._stop_hits = 0
        self._stop_trimmed = 0
        self._thread = threading.Thread(
            target=self._worker, name=f"mxtorch-serve-{self.name}",
            daemon=True)
        self._thread.start()

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
                     request_id: Optional[str] = None,
                     eos_id: Optional[int] = None,
                     sampling: Optional[SamplingParams] = None):
        """Enqueue one generation request; returns a handle whose
        ``stream()`` yields tokens as they are produced and whose
        ``result()`` blocks for the full list.  Raises
        :class:`QueueFullError` under backpressure and ``ValueError`` for
        an unservable prompt, budget or sampling parameter.

        ``sampling`` (None: greedy) is validated here and its
        ``logprobs`` clamped to the engine's ``logprobs_topn``; a sampled
        request without a seed gets one, stored on the handle, so the
        response is replayable.  ``sampling.n > 1`` fans out into ``n``
        child requests ``"{id}.{i}"`` over distinct slots with derived
        seeds, admitted all or none, behind one :class:`_MultiGenRequest`
        handle."""
        if request_id is None:
            request_id = uuid.uuid4().hex[:16]
        if sampling is not None:
            sampling = sampling.validate(max_n=int(self.engine.max_slots))
            cap = int(self.engine.logprobs_topn)
            if sampling.logprobs > cap:
                sampling = replace(sampling, logprobs=cap)
            if sampling.sampled and sampling.seed is None:
                sampling = replace(
                    sampling,
                    seed=int.from_bytes(os.urandom(8), "big") >> 1)
        if sampling is None or sampling.n == 1:
            return self._submit_one(tokens, max_new_tokens, request_id,
                                    eos_id, sampling)
        base = sampling.seed
        children: List[_GenRequest] = []
        try:
            for i in range(sampling.n):
                child = replace(sampling, n=1,
                                seed=derive_candidate_seed(base, i)
                                if base is not None else None)
                children.append(self._submit_one(
                    tokens, max_new_tokens, f"{request_id}.{i}", eos_id,
                    child))
        except Exception:
            for c in children:          # no half-admitted fan-outs
                c.cancel()
            raise
        return _MultiGenRequest(children, request_id)

    def _submit_one(self, tokens, max_new_tokens, request_id, eos_id,
                    sampling) -> _GenRequest:
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
        req = _GenRequest(toks, budget, eos_id=eos_id,
                          request_id=request_id, sampling=sampling)
        if sampling is not None and sampling.json_mode:
            req._machine = JsonMaskMachine(self._token_strings())
        with self._cv:
            if self._closed:
                raise MXNetError(f"batcher {self.name!r} is closed")
            if len(self._queue) >= self.queue_size:
                raise QueueFullError(
                    f"{self.name}: queue full ({len(self._queue)} "
                    "pending) — backpressure")
            self._queue.append(req)
            self._cv.notify_all()
        return req

    def submit(self, tokens, max_new_tokens: int = 32,
               timeout: Optional[float] = None,
               request_id: Optional[str] = None,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None) -> List[int]:
        """Synchronous generation: enqueue, wait, return all emitted
        tokens."""
        return self.submit_async(tokens, max_new_tokens,
                                 request_id=request_id, eos_id=eos_id,
                                 sampling=sampling).result(timeout)

    # -- worker: the continuous loop ------------------------------------
    def _worker(self):
        while True:
            step = self._boundary()
            if step is None:
                return
            self._run_step(*step)

    def _boundary(self):
        """One step boundary, under ``_cv``: collect cancelled slots,
        admit queued requests into free slots while the pool can reserve
        their blocks, and return ``(leavers, joins)`` once there is work
        — or None when the batcher is closed and drained."""
        with self._cv:
            while True:
                leavers = []
                for s, r in enumerate(self._slots):
                    if r is not None and r._cancelled:
                        leavers.append((s, r, "cancelled"))
                        self._slots[s] = None
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
                live = sum(1 for r in self._slots if r is not None)
                self._peak_slots = max(self._peak_slots, live)
                if leavers or joins or live:
                    return leavers, joins
                if self._closed and not self._queue:
                    return None
                self._cv.wait(0.05)

    def _live(self):
        with self._cv:
            return [(s, r) for s, r in enumerate(self._slots)
                    if r is not None]

    def _run_step(self, leavers, joins):
        """Outside the lock: settle leavers, prefill the joins, then ONE
        decode, burst or speculative step for every live slot."""
        self._step += 1
        for slot, req, reason in leavers:
            self._leave(slot, req, reason)
        for slot, req in joins:
            self._join(slot, req)
        live = self._live()
        if not live:
            return
        # a constrained slot's mask changes at every emit: a burst or the
        # (spec_k + 1)-wide verify would sample past a stale mask
        dyn = any(r._machine is not None for _, r in live)
        if not dyn and self.engine.draft is not None:
            self._spec_once(live)
        elif not dyn and self._burst_ready(live):
            self._decode_burst_once(live)
        else:
            self._decode_once(live)

    def _join(self, slot: int, req: _GenRequest):
        """Admit one request mid-flight: its prefill runs between decode
        steps and emits the first token."""
        try:
            # the sampling state (and JSON mode's first mask) goes into
            # the slot before the prefill samples its first token
            self.engine.set_slot_sampling(slot, req.sampling)
            if req._machine is not None:
                self.engine.update_slot_bias(
                    slot, req._machine.mask(budget=req.budget))
            first = self.engine.prefill(req.tokens, slot,
                                        reserve_tokens=req.n + req.budget)
        except Exception as e:
            # a failed prefill fails its own request and nobody else's
            with self._cv:
                if self._slots[slot] is req:
                    self._slots[slot] = None
            req._finish(e)
            return
        lp = self.engine.last_prefill_logprobs()
        if lp is not None:
            self._push_logprobs(req, lp[0], lp[1])
        self._emit(req, [first])
        self._advance_machine(slot, req, first)
        if self._finished(req):
            self._free_slot(slot, req, "finished")

    def _decode_once(self, live):
        """ONE decode dispatch for every slot (free slots ride along at
        position 0); emit each live slot's token and free finished
        slots."""
        S = int(self.engine.max_slots)
        last = _np.zeros(S, _np.int32)
        pos = _np.zeros(S, _np.int32)
        for s, r in live:
            last[s] = r.tokens_out[-1]
            pos[s] = r.n + len(r.tokens_out) - 1
        try:
            nxt = self.engine.decode(last, pos)
        except Exception as e:
            self._decode_failed(live, e)
            return
        self._dpt_dispatches += 1
        self._dpt_tokens += 1.0
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
        """Steady-state gate for the burst path: no join can land and no
        cancel can be seen inside a k-step burst, so take it only when
        nothing is queued and no rider has asked to cancel."""
        if int(self.engine.scan_steps) < 1:
            return False
        with self._cv:
            if self._queue:
                return False
        return not any(r._cancelled for _, r in live)

    def _decode_burst_once(self, live):
        """ONE burst advances every live slot by up to ``scan_steps``
        tokens; emit each slot's prefix and free finished slots.  The same
        tokens as that many :meth:`_decode_once` steps."""
        S = int(self.engine.max_slots)
        last = _np.zeros(S, _np.int32)
        pos = _np.zeros(S, _np.int32)
        bud = _np.ones(S, _np.int32)
        eos = _np.full(S, -1, _np.int32)
        act = _np.zeros(S, bool)
        for s, r in live:
            last[s] = r.tokens_out[-1]
            pos[s] = r.n + len(r.tokens_out) - 1
            bud[s] = r.budget - len(r.tokens_out)
            if r.eos_id is not None:
                eos[s] = int(r.eos_id)
            act[s] = True
        try:
            toks, emitted = self.engine.decode_burst(last, pos, bud, eos,
                                                     act)
        except Exception as e:
            self._decode_failed(live, e)
            return
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
                    new, n = new[:kept], kept
            if lp is not None:
                for j in range(n):
                    self._push_logprobs(r, lp[0][j, s], lp[1][j, s])
            self._emit(r, new)
            total += n
            if stopped or self._finished(r):
                self._free_slot(s, r, "finished")
        self._dpt_dispatches += 1
        self._dpt_tokens += total / max(1, len(live))

    def _spec_once(self, live):
        """ONE speculative step (the draft's proposals, then one verify)
        advances every live slot by 1 to ``spec_k + 1`` tokens, emitted
        one at a time with the finish check after each.  The same tokens
        as that many :meth:`_decode_once` steps; joins and leaves stay at
        step boundaries, so a joining request never sees a neighbour's
        rollback."""
        S = int(self.engine.max_slots)
        k = int(self.engine.spec_k)
        last = _np.zeros(S, _np.int32)
        pos = _np.zeros(S, _np.int32)
        for s, r in live:
            last[s] = r.tokens_out[-1]
            pos[s] = r.n + len(r.tokens_out) - 1
        try:
            out, accepted = self.engine.spec_step(last, pos)
        except Exception as e:
            self._decode_failed(live, e)
            return
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
        self._spec_dispatches += 1
        self._spec_slot_steps += len(live)
        self._spec_emitted += step_emitted
        self._spec_drafted += len(live) * k
        self._spec_accepted += step_emitted - len(live)
        self._dpt_dispatches += 1
        self._dpt_tokens += step_emitted / max(1, len(live))

    # -- step-boundary helpers ------------------------------------------
    def _emit(self, req: _GenRequest, toks) -> None:
        req._emit(toks)
        self._tokens_emitted += len(toks)

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
                return True
        return False

    def _free_slot(self, slot: int, req: _GenRequest, reason: str):
        with self._cv:
            if self._slots[slot] is req:
                self._slots[slot] = None
        self._leave(slot, req, reason)

    def _leave(self, slot: int, req: _GenRequest, reason: str):
        """Return the slot's KV blocks to the pool and settle the
        request: ok when finished, :class:`Cancelled` for a consumer that
        went away."""
        self.engine.release_slot(slot)
        if reason == "finished":
            req._finish(None)
        elif reason == "cancelled":
            req._finish(Cancelled(
                f"{self.name}: request {req.request_id} cancelled after "
                f"{len(req.tokens_out)} tokens"))
        else:
            req._finish(RequestAborted(
                f"{self.name}: request {req.request_id} aborted "
                f"({reason})"))

    def _decode_failed(self, live, err: Exception):
        """A decode dispatch failed.  The cache is shared and was being
        updated in place, so fail every rider, free all slots and reset
        the engine so the next admission starts clean."""
        with self._cv:
            for s, r in live:
                if self._slots[s] is r:
                    self._slots[s] = None
        self.engine.reset()
        for _, r in live:
            r._finish(err)

    # -- lifecycle / introspection ---------------------------------------
    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop intake.  ``drain=True`` lets the worker finish everything
        queued; ``drain=False`` fails queued requests at once.  Requests
        still pending when the worker cannot finish inside ``timeout``
        seconds are failed.  Idempotent."""
        with self._cv:
            self._closed = True
            dropped = []
            if not drain:
                dropped = list(self._queue)
                self._queue.clear()
            self._cv.notify_all()
        for r in dropped:
            r._finish(RequestAborted(f"batcher {self.name!r} closed"))
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            with self._cv:
                stranded = list(self._queue) + [
                    r for r in self._slots if r is not None]
                self._queue.clear()
            for r in stranded:
                r._finish(RequestAborted(
                    f"batcher {self.name!r}: drain timed out after "
                    f"{timeout}s; request {r.request_id} abandoned"))

    def stats(self) -> dict:
        with self._cv:
            out = {
                "model": self.name,
                "kind": "generation",
                "queue_depth": len(self._queue),
                "queue_size": self.queue_size,
                "closed": self._closed,
                "max_slots": int(self.engine.max_slots),
                "max_len": int(self.engine.max_len),
                "slots_in_use": sum(1 for r in self._slots
                                    if r is not None),
                "decode_steps": self._step,
                "decode_scan_steps": int(self.engine.scan_steps),
                "decode_burst_dispatches": self._burst_dispatches,
                "tokens_emitted": self._tokens_emitted,
                "peak_slots_in_use": self._peak_slots,
                "prefill_buckets": list(self.engine.prefill_buckets),
                "kv_cache_bytes": int(self.engine.cache_bytes),
                "logprobs_topn": int(self.engine.logprobs_topn),
                "stop_hits": self._stop_hits,
                "stop_trimmed_tokens": self._stop_trimmed,
                "dispatches_per_token":
                    self._dpt_dispatches / max(self._dpt_tokens, 1e-9)
                    if self._dpt_dispatches else None,
            }
            if self.engine.draft is not None:
                out.update({
                    "spec_k": int(self.engine.spec_k),
                    "spec_draft_model": self.engine.draft.name,
                    "spec_dispatches": self._spec_dispatches,
                    "accepted_tokens_per_dispatch":
                        self._spec_emitted / max(1, self._spec_slot_steps),
                    "spec_accept_rate":
                        self._spec_accepted / max(1, self._spec_drafted),
                })
        out.update(self.engine.kv_stats())
        return out
