"""ModelServer — the HTTP front of the port's serving plane (counterpart
of ``incubator_mxnet_tpu/serving/server.py``, generation models only).

A stdlib ``ThreadingHTTPServer`` (one handler thread per connection: the
threads are the concurrent clients the batcher coalesces) over a
registry of generation models, each a :class:`GenerationEngine` behind a
:class:`ContinuousBatcher`.  The wire protocol is the reference's where
it is deterministic — routes, status codes, headers (``X-Request-Id``,
``Retry-After``, ``X-Trace-Id``), JSON keys and SSE frames — so the
reference's router can front a port replica.

Routes:

* ``POST /v1/models/<name>:generate`` — ``{"tokens": [...],
  "max_new_tokens": 32, "timeout_ms": ..., "eos_id": ..., "stream":
  false}`` plus the sampling fields (``temperature``, ``top_k``,
  ``top_p``, ``seed``, ``logprobs``, ``stop``, ``n``, ``logit_bias``,
  ``json_mode``).  Non-streaming answers ``{"tokens", "count",
  "accepted_tokens", "draft_tokens", "request_id"}`` (``seed``,
  ``logprobs``, ``candidates`` where they apply); ``"stream": true``
  answers chunked SSE: ``event: token`` per token, then ``event: done``
  or a terminal ``event: error``.  Errors: 429 + ``Retry-After`` under
  backpressure, 404 for an unknown model, 400 for a malformed body, 504
  past the deadline, 503 (+ ``Retry-After``) while the breaker is open,
  after a watchdog abort, or while draining.  A client that disconnects
  mid-stream cancels its request; the slot frees at the next step.
* ``POST /v1/models/<name>:unload`` — drain and remove.  ``:predict`` and
  ``:load`` (one-shot models from exported artifacts) answer 400: the
  port serves generation models only so far.
* ``GET /v1/models``, ``/healthz`` (liveness), ``/readyz`` (200 only when
  every model is SERVING or DEGRADED, no ``slo:<model>`` or
  ``kv:<model>`` blocker stands and the server is not draining),
  ``/slo``, ``/health`` (health plane), ``/trace``, ``/flight``,
  ``/programs`` (dispatch ledger and every engine's expected-against-
  captured programs), ``/memory`` (per-device and per-owner bytes),
  ``/metrics`` (Prometheus text), ``/metrics.json``.
* ``POST /admin/drain`` / ``/admin/undrain`` — the rolling-update pair.

``shutdown()`` is the SIGTERM-safe teardown (DRAINING: 503 on new work
and on ``/readyz``; in-flight work finishes within ``MXNET_DRAIN_SECONDS``;
then the port closes); ``stop()`` the immediate one."""
from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Dict, Optional
from urllib.parse import parse_qs, urlsplit

from ..base import MXNetError, getenv_int
from ..http_util import (BaseJSONHandler, HTTPServerBase,
                         start_http_server, stop_http_server)
from .. import health as _health
from .. import telemetry as _telemetry
from .. import telemetry_device as _tdev
from .. import telemetry_http as _thttp
from .. import telemetry_ring as _ring
from .batcher import ContinuousBatcher, QueueFullError
from .engine import GenerationEngine
from .sampling import SamplingParams
from . import lifecycle as _lc
from . import metrics as _m
from . import slo as _slo

__all__ = ["ModelServer"]

#: what a verb of the one-shot inference path answers until it is ported
_NOT_PORTED = ("the PyTorch port serves generation models only; one-shot "
               "models (:predict, :load, --model) are ROADMAP Queue A "
               "item 9")


def _retry_after_header(seconds: float) -> dict:
    return {"Retry-After": str(max(1, int(math.ceil(seconds))))}


class _ServingHTTPServer(HTTPServerBase):
    model_server: "ModelServer" = None


class _Handler(BaseJSONHandler):
    server_version = "mxtpu-serve/1.0"

    def do_GET(self):  # noqa: N802 (http.server API)
        self.guard(self._get)

    def do_POST(self):  # noqa: N802
        self.guard(self._post)

    def _get(self):
        ms = self.server.model_server
        split = urlsplit(self.path)
        params = parse_qs(split.query)
        path = split.path.rstrip("/") or "/"
        if path == "/healthz":
            self.send_json(200, {"status": "ok",
                                 "models": sorted(ms.models())})
        elif path == "/readyz":
            ready, body = ms.readiness()
            self.send_json(200 if ready else 503, body,
                           headers=None if ready
                           else _retry_after_header(1.0))
        elif path == "/v1/models":
            self.send_json(200, {"models": ms.model_stats()})
        elif path == "/slo":
            self.send_json(200, _slo.tracker.snapshot())
        elif path == "/health":
            self.send_json(200, ms.health_report())
        elif path == "/trace":
            self.send_json(200, _thttp.trace_body(params))
        elif path == "/flight":
            self.send_json(200, _thttp.flight_body())
        elif path == "/programs":
            self.send_json(200, ms.program_report())
        elif path == "/memory":
            self.send_json(200, _tdev.sample())
        elif path == "/metrics.json":
            self.send_json(200, _thttp.metrics_state_body())
        elif path in ("/metrics", "/"):
            _m.refresh_kernel_launches()
            self._send(200, _telemetry.render_prometheus(),
                       "text/plain; version=0.0.4; charset=utf-8")
        else:
            self.send_text(404, "not found: try /v1/models /healthz "
                                "/readyz /metrics /metrics.json /slo "
                                "/health /trace /flight /programs "
                                "/memory\n")

    def _remote_trace(self):
        """Adopt the router's ``X-Trace-Id`` hop as the remote parent of
        the spans this request opens (a no-op without the header)."""
        tp = self.trace_parent()
        if tp is None:
            return contextlib.nullcontext()
        return _telemetry.tracer.remote(*tp)

    def _post(self):
        ms = self.server.model_server
        path = self.path.split("?", 1)[0]
        if path == "/admin/drain":
            ms.begin_drain()
            self.send_json(200, {"draining": True,
                                 "inflight": ms.inflight_http})
            return
        if path == "/admin/undrain":
            ms.end_drain()
            self.send_json(200, {"draining": False})
            return
        if not path.startswith("/v1/models/") or ":" not in path:
            self.send_text(404,
                           "not found: POST /v1/models/<name>:predict\n")
            return
        name, _, verb = path[len("/v1/models/"):].rpartition(":")
        rid = self.request_id()

        def err(code, body, headers=None):
            body["request_id"] = rid
            self.send_json(code, body, headers=headers)

        try:
            payload = self.read_json()
        except ValueError as e:
            err(400, {"error": str(e)})
            return
        try:
            if verb == "generate":
                ms._http_enter()
                try:
                    with self._remote_trace():
                        self._generate(ms, name, payload, rid)
                finally:
                    ms._http_exit()
            elif verb in ("predict", "load"):
                raise MXNetError(f":{verb}: {_NOT_PORTED}")
            elif verb == "unload":
                ms.remove_model(name)
                self.send_json(200, {"unloaded": name})
            else:
                err(404, {"error": f"unknown verb {verb!r}; "
                          "try :predict :generate :load :unload"})
        except KeyError:
            err(404, {"error": f"model {name!r} is not "
                      "loaded", "models": sorted(ms.models())})
        except QueueFullError as e:
            retry = getattr(e, "retry_after", 1.0)
            err(429, {"error": str(e), "retry_after": retry},
                headers=_retry_after_header(retry))
        except _lc.DeadlineExceeded as e:
            err(504, {"error": str(e)})
        except TimeoutError as e:
            err(504, {"error": str(e) or "inference request timed out"})
        except _lc.BreakerOpen as e:
            err(503, {"error": str(e), "retry_after": e.retry_after},
                headers=_retry_after_header(e.retry_after))
        except (_lc.Draining, _lc.RequestAborted) as e:
            err(503, {"error": str(e)},
                headers=_retry_after_header(e.retry_after))
        except (ValueError, TypeError, MXNetError) as e:
            err(400, {"error": str(e)})

    def _generate(self, ms, name, payload, rid):
        """The ``:generate`` body.  Admission errors raise into
        ``_post``'s error ladder (no status line sent yet); once the
        stream is open, worker-side failures become a terminal SSE
        ``error`` event and a broken pipe cancels the request.  The whole
        lifetime runs under a ``serve.request`` span."""
        stream = bool(payload.get("stream", False)) \
            if isinstance(payload, dict) else False
        with _telemetry.trace_span("serve.request", cat="serving",
                                   model=name, request_id=rid,
                                   stream=stream):
            req = ms.generate_request(name, payload, request_id=rid)
            if not stream:
                toks = req.result()
                body = {"tokens": toks, "count": len(toks),
                        "accepted_tokens": int(req.accepted_tokens),
                        "draft_tokens": int(req.draft_tokens),
                        "request_id": req.request_id}
                # a sampled response always echoes its effective seed
                if req.seed is not None:
                    body["seed"] = int(req.seed)
                if req.logprobs_n:
                    body["logprobs"] = list(req.logprobs_out)
                children = getattr(req, "children", None)
                if children is not None:
                    body["candidates"] = [
                        {"tokens": list(c.tokens_out),
                         "seed": None if c.seed is None else int(c.seed),
                         "request_id": c.request_id,
                         **({"logprobs": list(c.logprobs_out)}
                            if c.logprobs_n else {})}
                        for c in children]
                self.send_json(200, body)
                return
            self.start_stream(200)
            try:
                lp_n = int(req.logprobs_n or 0)
                for i, tok in enumerate(req.stream()):
                    ev = {"token": int(tok), "index": i}
                    if lp_n and i < len(req.logprobs_out):
                        ev["logprobs"] = req.logprobs_out[i]
                    self.send_event(ev, event="token")
                done_ev = {"tokens": list(req.tokens_out),
                           "count": len(req.tokens_out),
                           "accepted_tokens": int(req.accepted_tokens),
                           "draft_tokens": int(req.draft_tokens),
                           "request_id": req.request_id}
                if req.seed is not None:
                    done_ev["seed"] = int(req.seed)
                self.send_event(done_ev, event="done")
            except (BrokenPipeError, ConnectionError, OSError):
                req.cancel()            # the client went away mid-stream
                return
            except Exception as e:
                try:
                    self.send_event({"error": str(e),
                                     "request_id": req.request_id},
                                    event="error")
                except OSError:
                    req.cancel()
                    return
            try:
                self.end_stream()
            except OSError:
                pass


class ModelServer:
    """Multi-model generation server.  Programmatic use::

        srv = ModelServer(port=0)
        srv.add_model("gpt", engine, warmup=True)
        srv.start()
        ... requests against srv.port ...
        srv.stop()                   # immediate teardown
        # or srv.shutdown() — the SIGTERM drain sequence

    Batcher knobs passed here or to :meth:`add_model` override the env
    defaults (``MXNET_SERVE_QUEUE``, ``MXNET_SERVE_TIMEOUT_MS``); the port
    default is ``MXNET_SERVE_PORT`` (8080)."""

    def __init__(self, port: Optional[int] = None, host: str = "0.0.0.0",
                 **batcher_defaults):
        self._port = getenv_int("MXNET_SERVE_PORT", 8080) \
            if port is None else int(port)
        self._host = host
        self._batcher_defaults = dict(batcher_defaults)
        self._models: Dict[str, ContinuousBatcher] = {}
        self._lock = threading.Lock()
        self._http: Optional[_ServingHTTPServer] = None
        self._watchdog: Optional[_lc.Watchdog] = None
        self._draining = False
        self._warm_pending: set = set()
        self._warm_errors: Dict[str, BaseException] = {}
        self._inflight_http = 0
        self._last_http = time.monotonic()

    # -- registry -------------------------------------------------------
    def add_model(self, name: str, engine: GenerationEngine,
                  warmup: bool = False, async_warmup: bool = False,
                  **batcher_kw) -> ContinuousBatcher:
        """Register ``engine`` under ``name`` behind a fresh
        :class:`ContinuousBatcher`.  ``warmup=True`` captures the engine's
        closed program set before the model takes traffic;
        ``async_warmup=True`` does so on a background thread: the model
        registers at once as STARTING and ``/readyz`` stays 503 until its
        programs exist.  On the card an engine that was never warmed
        cannot serve (no eager path)."""
        if not isinstance(engine, GenerationEngine):
            raise MXNetError(f"add_model({name!r}): {_NOT_PORTED}; got "
                             f"{type(engine).__name__}")
        if self._draining:
            raise _lc.Draining(
                f"server is draining; refusing to load {name!r}")
        if warmup and not async_warmup:
            engine.warmup()
        kw = dict(self._batcher_defaults)
        kw.update(batcher_kw)
        batcher = ContinuousBatcher(engine, name=name, **kw)
        with self._lock:
            if name in self._models:
                batcher.close(drain=False)
                raise MXNetError(f"model {name!r} is already loaded")
            self._models[name] = batcher
            self._warm_errors.pop(name, None)
            if warmup and async_warmup:
                self._warm_pending.add(name)
            _m.MODELS_LOADED.set(len(self._models))
        if warmup and async_warmup:
            threading.Thread(target=self._warm_async, args=(name, engine),
                             name=f"mxtorch-serve-warmup-{name}",
                             daemon=True).start()
        return batcher

    def _warm_async(self, name: str, engine: GenerationEngine) -> None:
        try:
            engine.warmup()
        except Exception as e:          # readiness shows the model
            with self._lock:            # UNHEALTHY instead of wedging
                self._warm_errors[name] = e
        finally:
            with self._lock:
                self._warm_pending.discard(name)

    def remove_model(self, name: str) -> None:
        """Drain the model's batcher and drop it from the registry."""
        with self._lock:
            batcher = self._models.pop(name)   # KeyError -> HTTP 404
            self._warm_pending.discard(name)
            self._warm_errors.pop(name, None)
            _m.MODELS_LOADED.set(len(self._models))
        batcher.close(drain=True)

    def get_model(self, name: str) -> ContinuousBatcher:
        with self._lock:
            return self._models[name]

    def models(self):
        with self._lock:
            return list(self._models)

    def model_stats(self) -> dict:
        with self._lock:
            items = sorted(self._models.items())
        out = {}
        for n, b in items:
            st = b.stats()
            try:        # program accounting rides /v1/models too
                st["programs"] = b.engine.program_inventory()
            except Exception as e:      # a sick engine is itself data
                st["programs"] = {"error": repr(e)}
            out[n] = st
        return out

    def program_report(self) -> dict:
        """``GET /programs``: the dispatch ledger plus every registered
        engine's expected-against-captured program accounting."""
        return _tdev.program_report()

    def health_report(self) -> dict:
        """``GET /health``: the health-plane summary plus each generation
        model's latest decode-step stats."""
        body = _health.report()
        with self._lock:
            batchers = dict(self._models)
        models = {}
        for n, b in sorted(batchers.items()):
            dh = b._decode_health_last
            if dh is not None:
                models[n] = {"decode_health": dict(dh),
                             "nonfinite_generations":
                                 b._nonfinite_generations}
        if models:
            body["models"] = models
        return body

    def model_state(self, name: str) -> str:
        """One model's serving state, with the async warmup folded in
        (STARTING while capturing, UNHEALTHY if the warmup failed)."""
        with self._lock:
            batcher = self._models[name]       # KeyError -> HTTP 404
            if name in self._warm_pending:
                return _lc.STARTING
            if name in self._warm_errors:
                return _lc.UNHEALTHY
        return batcher.state

    def readiness(self):
        """``(ready, body)`` for ``GET /readyz``: ready only when not
        draining, every model is SERVING or DEGRADED, and no model's
        error budget is exhausted (``slo:<model>``) or KV pool starved
        (``kv:<model>``)."""
        with self._lock:
            names = list(self._models)
            draining = self._draining
        states = {}
        for n in names:
            try:
                states[n] = _lc.DRAINING if draining \
                    else self.model_state(n)
            except KeyError:            # unloaded while we looked
                continue
            _m.MODEL_STATE.set(_lc.STATE_CODE[states[n]], model=n)
        blockers = [n for n, s in states.items()
                    if s not in (_lc.SERVING, _lc.DEGRADED)]
        blockers += [f"slo:{n}" for n in _slo.tracker.exhausted()
                     if n in states]
        with self._lock:
            batchers = dict(self._models)
        blockers += [f"kv:{n}" for n, b in batchers.items()
                     if n in states and b.kv_starved]
        blockers = sorted(blockers)
        ready = not draining and not blockers
        body = {"status": "ready" if ready else
                ("draining" if draining else "unready"),
                "draining": draining, "models": states}
        if blockers and not draining:
            body["blockers"] = blockers
        return ready, body

    @property
    def draining(self) -> bool:
        return self._draining

    # -- generation -----------------------------------------------------
    def generate_request(self, name: str, payload: dict,
                         request_id: Optional[str] = None):
        """Parse a ``:generate`` payload and admit it into the model's
        batcher; returns the live request handle.  Admission failures are
        recorded against the model's SLO here."""
        if self._draining:
            raise _lc.Draining(f"server is draining; model {name!r} is "
                               "not accepting new work")
        batcher = self.get_model(name)          # KeyError -> HTTP 404
        if not isinstance(payload, dict):
            raise ValueError(':generate needs a JSON object body')
        tokens = payload.get("tokens", payload.get("inputs"))
        if isinstance(tokens, (list, tuple)) and len(tokens) == 1 \
                and isinstance(tokens[0], (list, tuple)):
            tokens = tokens[0]          # accept a [[...]] batch of one
        if not isinstance(tokens, (list, tuple)) or not tokens:
            raise ValueError('"tokens" must be a non-empty list of '
                             "token ids")
        tokens = [int(t) for t in tokens]       # ValueError -> HTTP 400
        max_new = int(payload.get("max_new_tokens", 32))
        timeout_ms = payload.get("timeout_ms")
        if timeout_ms is not None:
            timeout_ms = float(timeout_ms)
        eos_id = payload.get("eos_id")
        if eos_id is not None:
            eos_id = int(eos_id)
        sampling = None
        if any(k in payload for k in
               ("temperature", "top_k", "top_p", "seed", "logprobs",
                "stop", "n", "logit_bias", "json_mode")):
            lb = payload.get("logit_bias")
            if lb is not None:
                if not isinstance(lb, dict):
                    raise ValueError(
                        '"logit_bias" must be an object mapping token '
                        "id -> bias")
                lb = {int(t): float(b) for t, b in lb.items()}
            seed = payload.get("seed")
            sampling = SamplingParams(
                temperature=float(payload.get("temperature", 0.0)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                seed=int(seed) if seed is not None else None,
                logprobs=int(payload.get("logprobs", 0)),
                stop=tuple(payload.get("stop") or ()),
                n=int(payload.get("n", 1)),
                logit_bias=lb,
                json_mode=bool(payload.get("json_mode", False)))
            if sampling.n > 1 and bool(payload.get("stream", False)):
                raise ValueError(
                    "streaming and n > 1 cannot be combined; stream "
                    "each candidate as its own request")
        try:
            return batcher.submit_async(
                tokens, max_new_tokens=max_new, timeout_ms=timeout_ms,
                request_id=request_id, eos_id=eos_id, sampling=sampling)
        except Exception:
            _slo.tracker.record(name, 0.0, ok=False)
            raise

    # -- drain bookkeeping ----------------------------------------------
    def _http_enter(self) -> None:
        with self._lock:
            self._inflight_http += 1

    def _http_exit(self) -> None:
        with self._lock:
            self._inflight_http -= 1
            self._last_http = time.monotonic()

    # -- lifecycle ------------------------------------------------------
    def preload(self) -> "ModelServer":
        """Capture every registered model's whole program set before
        :meth:`start` binds the port.  Idempotent."""
        with self._lock:
            batchers = sorted(self._models.items())
        for _, b in batchers:
            if not b.engine.warm:
                b.engine.warmup()
        return self

    def start(self) -> "ModelServer":
        """Bind and serve in daemon threads; returns self (``port=0``
        binds an ephemeral port, see :attr:`port`).  Also starts the
        worker watchdog, holds the flight recorder and starts the memory
        sampler."""
        if self._http is not None:
            return self
        srv = start_http_server(_Handler, self._port, self._host,
                                name="mxtorch-serve-http",
                                server_cls=_ServingHTTPServer)
        srv.model_server = self
        self._http = srv
        if self._watchdog is None:
            self._watchdog = _lc.Watchdog(supplier=self._batchers)
        self._watchdog.start()
        _ring.recorder.start()
        _ring.recorder.register_provider("serving", self._flight_state)
        _tdev.start_sampler()
        return self

    def _flight_state(self) -> dict:
        """Flight-dump provider: per-model states and the request ids
        queued or in flight."""
        with self._lock:
            batchers = dict(self._models)
            draining = self._draining
        out = {"draining": draining, "models": {}}
        for n, b in sorted(batchers.items()):
            try:
                out["models"][n] = {
                    "state": self.model_state(n),
                    "breaker": b.breaker.state,
                    "restarts": b.restarts,
                    "requests": b.active_request_ids(),
                }
            except Exception as e:      # a sick model is itself data
                out["models"][n] = {"error": repr(e)}
        return out

    def _batchers(self):
        with self._lock:
            return list(self._models.values())

    @property
    def inflight_http(self) -> int:
        """HTTP requests inside a generate handler."""
        with self._lock:
            return self._inflight_http

    def begin_drain(self) -> None:
        """DRAINING: ``/readyz`` answers 503 and new work is refused with
        503 + ``Retry-After`` while in-flight requests go on; the port
        stays open."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self._last_http = time.monotonic()

    def end_drain(self) -> None:
        """Take traffic again after :meth:`begin_drain`."""
        with self._lock:
            self._draining = False

    def shutdown(self, drain_seconds: Optional[float] = None,
                 linger_seconds: float = 0.3) -> None:
        """The SIGTERM-safe teardown: :meth:`begin_drain`, wait (within
        ``MXNET_DRAIN_SECONDS``) until every batcher is idle, no handler
        is in flight and traffic has been quiet for ``linger_seconds``,
        then :meth:`stop`."""
        if drain_seconds is None:
            drain_seconds = _lc.default_drain_seconds()
        self.begin_drain()
        deadline = time.monotonic() + max(0.0, float(drain_seconds))
        while time.monotonic() < deadline:
            with self._lock:
                inflight = self._inflight_http
                last = self._last_http
                batchers = list(self._models.values())
            if inflight == 0 and all(b.idle for b in batchers) \
                    and time.monotonic() - last >= linger_seconds:
                break
            time.sleep(0.02)
        self.stop(drain=True)

    def stop(self, drain: bool = True) -> None:
        """Stop the HTTP front, then close every batcher (``drain=True``
        finishes queued work first)."""
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._http is not None:
            _ring.recorder.unregister_provider("serving")
            _ring.recorder.stop()
            _tdev.stop_sampler()
        stop_http_server(self._http)
        self._http = None
        with self._lock:
            batchers = list(self._models.values())
            self._models.clear()
            self._warm_pending.clear()
            self._warm_errors.clear()
            _m.MODELS_LOADED.set(0)
        for b in batchers:
            b.close(drain=drain)

    @property
    def port(self) -> Optional[int]:
        """The bound port once :meth:`start` has run."""
        return self._http.server_address[1] if self._http else self._port

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
