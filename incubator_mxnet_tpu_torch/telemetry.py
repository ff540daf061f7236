"""Runtime telemetry of the PyTorch port (counterpart of
``incubator_mxnet_tpu/telemetry.py``): a multi-subscriber event bus, the
process-wide metrics registry, the span tracer and the dispatch ledger.

* **Event bus** — named :class:`Topic` objects any number of subscribers
  attach to.  Publishing to a topic nobody listens to is one list
  truthiness check.
* **Metrics registry** — :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` (bounded reservoir, nearest-rank percentiles),
  exported as Prometheus text (:func:`render_prometheus`), as a
  JSON-ready :func:`snapshot` and as the lossless
  :meth:`MetricsRegistry.export_state` the ``/metrics.json`` route
  serves.
* **Span tracer** — :class:`Span` trees with thread-local context
  (``with trace_span("serve.prefill"): ...``), bounded, searchable by
  ``request_id`` (the ``/trace`` route).
* **Dispatch ledger** — one row per program site (``serving:<model>:
  <program>``): dispatch count, host wall-time reservoir, captures and
  their seconds, the age of the last dispatch and how many programs of
  the site are captured.  The JAX package feeds it from a jit wrapper;
  the port has no jit: its programs are the serving engine's CUDA graphs,
  and the engine records each replay (:func:`ledger_site`).
* **Device gauges** — :func:`sample_device_memory` reads the caching
  allocator's statistics per CUDA device; :func:`device_peak_flops` is
  the card's fp32 peak (the arithmetic the port serves in).

Control plane: ``MXNET_TELEMETRY=1`` starts collection (and with it the
span tracer) at import; :func:`start` does so in code."""
from __future__ import annotations

import itertools
import os
import threading
import time
import uuid
from collections import deque
from typing import Callable, Dict, List, Optional

from .base import MXNetError, getenv_bool, getenv_int

__all__ = [
    "Topic", "EventBus", "bus", "SPAN", "FAULT", "HEALTH",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "counter", "gauge", "histogram", "merge_states",
    "render_prometheus_state",
    "Span", "Tracer", "tracer", "trace_span", "new_request_id",
    "start", "stop", "enabled", "reset",
    "snapshot", "render_prometheus", "counters_flat",
    "sample_device_memory", "device_peak_flops", "GPU_FP32_PEAK_FLOPS",
    "ledger_site", "dispatch_ledger", "reset_dispatch_ledger",
    "StepHealthRing", "health_ring",
]


# ---------------------------------------------------------------------------
# Event bus
# ---------------------------------------------------------------------------
class Topic:
    """A named event stream.  ``subscribers`` is copy-on-write: a
    mutation swaps in a new list under ``_lock``, so ``publish`` fans out
    over a stable snapshot without taking the lock.  A subscriber that
    raises is counted in ``errors`` and skipped — an observer never takes
    the observed program down.  ``forcing`` counts non-passive
    subscribers."""

    __slots__ = ("name", "subscribers", "errors", "last_error", "forcing",
                 "_passive", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.subscribers: List[Callable] = []
        self.errors = 0
        self.last_error: Optional[BaseException] = None
        self.forcing = 0
        self._passive = set()
        self._lock = threading.Lock()

    def subscribe(self, fn: Callable, passive: bool = False) -> Callable:
        with self._lock:
            if fn not in self.subscribers:
                self.subscribers = self.subscribers + [fn]
                if passive:
                    self._passive.add(id(fn))
                else:
                    self.forcing += 1
        return fn

    def unsubscribe(self, fn: Callable) -> None:
        with self._lock:
            # by equality: a re-created bound method still unsubscribes
            # the one registered earlier
            try:
                idx = self.subscribers.index(fn)
            except ValueError:
                return
            registered = self.subscribers[idx]
            fresh = list(self.subscribers)
            del fresh[idx]
            self.subscribers = fresh
            if id(registered) in self._passive:
                self._passive.discard(id(registered))
            else:
                self.forcing -= 1

    def publish(self, *args, **kwargs) -> None:
        for fn in self.subscribers:
            try:
                fn(*args, **kwargs)
            except Exception as e:
                self.errors += 1
                self.last_error = e


class EventBus:
    """Registry of Topics; ``topic(name)`` is get-or-create."""

    def __init__(self):
        self._topics: Dict[str, Topic] = {}
        self._lock = threading.Lock()

    def topic(self, name: str) -> Topic:
        t = self._topics.get(name)
        if t is None:
            with self._lock:
                t = self._topics.setdefault(name, Topic(name))
        return t


bus = EventBus()

# Payload contracts:
#   SPAN(span)                        — a finished ROOT span (full subtree)
#   FAULT(site=, event=, kind=, ...)  — resilience plane (fault.py and the
#                                       serving lifecycle): event in
#                                       {"injected","retry","giveup",
#                                       "fallback","watchdog","breaker",
#                                       "deadline","oom","anomaly",...}
#   HEALTH(kind=, step=, src=, ...)   — one anomaly of the health plane
#   TRAINER(phase=, seconds=)         — phase "step": one SPMDTrainer or
#                                       gluon.Trainer step, "update": one
#                                       gluon.Trainer.update; host seconds
SPAN = bus.topic("span")
FAULT = bus.topic("fault")
HEALTH = bus.topic("health")
TRAINER = bus.topic("trainer")


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------
def _label_key(labels: dict):
    return tuple(sorted(labels.items()))


def _fmt_num(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _nearest_rank(data, q):
    """The ``q`` quantile of sorted ``data`` by nearest rank."""
    return data[min(len(data) - 1, max(0, int(round(q * (len(data) - 1)))))]


class Counter:
    """Monotonic counter, optionally broken out by labels
    (``c.inc(3, model="gpt")``)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise MXNetError(f"counter {self.name}: negative increment")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    @property
    def value(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def sample(self):
        """Plain number when unlabeled, else ``{"total": t, "by":
        {"model=gpt": n, ...}}``."""
        with self._lock:
            vals = dict(self._values)
        if not vals or set(vals) == {()}:
            return vals.get((), 0.0)
        return {
            "total": sum(vals.values()),
            "by": {",".join(f"{k}={v}" for k, v in key): val
                   for key, val in sorted(vals.items()) if key},
        }

    def _reset(self):
        with self._lock:
            self._values.clear()


class Gauge:
    """Last-write-wins value, optionally labeled."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    @property
    def value(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def sample(self):
        with self._lock:
            vals = dict(self._values)
        if not vals or set(vals) == {()}:
            return vals.get((), 0.0)
        return {",".join(f"{k}={v}" for k, v in key) or "_": val
                for key, val in sorted(vals.items())}

    def _reset(self):
        with self._lock:
            self._values.clear()


class Histogram:
    """Bounded-reservoir histogram: the last ``max_samples`` observations
    for percentiles plus exact count/sum/max over the whole stream,
    exported in Prometheus summary form with an extra ``_max`` series."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", max_samples: int = 4096):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._samples = deque(maxlen=max_samples)
        self._count = 0
        self._sum = 0.0
        self._max = None

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._samples.append(v)
            self._count += 1
            self._sum += v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    def stats(self) -> dict:
        with self._lock:
            data = sorted(self._samples)
            count, total, mx = self._count, self._sum, self._max
        if not data:
            return {"count": 0, "sum": 0.0, "p50": None, "p95": None,
                    "p99": None, "max": None}
        return {"count": count, "sum": total,
                "p50": _nearest_rank(data, 0.5),
                "p95": _nearest_rank(data, 0.95),
                "p99": _nearest_rank(data, 0.99), "max": mx}

    def sample(self):
        return self.stats()

    def state(self) -> dict:
        """Mergeable export: exact count/sum/max plus the raw reservoir."""
        with self._lock:
            return {"count": self._count, "sum": self._sum,
                    "max": self._max, "samples": list(self._samples)}

    @staticmethod
    def merge(states, max_samples: int = 4096) -> dict:
        """Union N :meth:`state` exports into one state.  count/sum/max
        merge exactly; reservoirs concatenate, and when the union
        overflows ``max_samples`` each source keeps its proportional
        share by evenly spaced picks over its sorted samples (no RNG, so
        merged percentiles are reproducible across processes)."""
        srcs = [s for s in states if s and s.get("count")]
        count = sum(int(s["count"]) for s in srcs)
        total = sum(float(s["sum"]) for s in srcs)
        maxes = [s["max"] for s in srcs if s.get("max") is not None]
        pools = [sorted(float(v) for v in (s.get("samples") or ()))
                 for s in srcs]
        pools = [p for p in pools if p]
        kept = sum(len(p) for p in pools)
        if kept <= max_samples:
            merged = sorted(v for p in pools for v in p)
        else:
            merged = []
            for p in pools:
                k = max(1, int(round(max_samples * len(p) / kept)))
                k = min(k, len(p))
                if k == len(p):
                    merged.extend(p)
                elif k == 1:
                    merged.append(p[len(p) // 2])
                else:
                    step = (len(p) - 1) / (k - 1)
                    merged.extend(p[int(round(j * step))]
                                  for j in range(k))
            merged.sort()
            del merged[max_samples:]
        return {"count": count, "sum": total,
                "max": max(maxes) if maxes else None, "samples": merged}

    @staticmethod
    def stats_of(state: dict) -> dict:
        """The :meth:`stats` summary of a :meth:`state`/:meth:`merge`
        export (nearest-rank percentiles over its reservoir)."""
        data = sorted(float(v) for v in (state.get("samples") or ()))
        if not data:
            return {"count": 0, "sum": 0.0, "p50": None, "p95": None,
                    "p99": None, "max": None}
        return {"count": int(state.get("count") or 0),
                "sum": float(state.get("sum") or 0.0),
                "p50": _nearest_rank(data, 0.5),
                "p95": _nearest_rank(data, 0.95),
                "p99": _nearest_rank(data, 0.99), "max": state.get("max")}

    def _reset(self):
        with self._lock:
            self._samples.clear()
            self._count = 0
            self._sum = 0.0
            self._max = None


class MetricsRegistry:
    """Process-wide name -> metric store with get-or-create accessors and
    the exporters."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, help, **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise MXNetError(
                f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  max_samples: int = 4096) -> Histogram:
        return self._get(Histogram, name, help, max_samples=max_samples)

    def get(self, name: str):
        return self._metrics.get(name)

    def metrics(self):
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self) -> None:
        """Zero every metric (registrations survive)."""
        for m in self.metrics():
            m._reset()

    # -- exporters ------------------------------------------------------
    def snapshot(self) -> dict:
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            out[m.kind + "s"][m.name] = m.sample()
        return out

    def counters_flat(self) -> Dict[str, float]:
        """name -> total value of every counter and gauge."""
        return {m.name: m.value for m in self.metrics()
                if m.kind in ("counter", "gauge")}

    def export_state(self) -> dict:
        """Lossless JSON-ready export: counters and gauges keep their
        per-label-set values (``"k=v,k2=v2"``, ``""`` unlabeled),
        histograms their whole reservoir."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            if m.kind in ("counter", "gauge"):
                with m._lock:
                    vals = dict(m._values)
                out[m.kind + "s"][m.name] = {
                    "help": m.help,
                    "values": {",".join(f"{k}={v}" for k, v in key): val
                               for key, val in sorted(vals.items())}}
            else:
                st = m.state()
                st["help"] = m.help
                out["histograms"][m.name] = st
        return out

    def render_prometheus(self) -> str:
        lines = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            if m.kind in ("counter", "gauge"):
                lines.append(f"# TYPE {m.name} {m.kind}")
                with m._lock:
                    vals = dict(m._values)
                if not vals:
                    lines.append(f"{m.name} 0")
                for key, val in sorted(vals.items()):
                    label = "{" + ",".join(
                        f'{k}="{v}"' for k, v in key) + "}" if key else ""
                    lines.append(f"{m.name}{label} {_fmt_num(val)}")
            else:
                lines.append(f"# TYPE {m.name} summary")
                s = m.stats()
                for q, k in (("0.5", "p50"), ("0.95", "p95"),
                             ("0.99", "p99")):
                    if s[k] is not None:
                        lines.append(
                            f'{m.name}{{quantile="{q}"}} {repr(s[k])}')
                lines.append(f"{m.name}_sum {repr(float(s['sum']))}")
                lines.append(f"{m.name}_count {int(s['count'])}")
                if s["max"] is not None:
                    lines.append(f"{m.name}_max {repr(s['max'])}")
        return "\n".join(lines) + "\n"


registry = MetricsRegistry()


def merge_states(states, max_samples: int = 4096) -> dict:
    """Fold N :meth:`MetricsRegistry.export_state` exports into one state
    of the same shape: counters and gauges sum per label set, histograms
    union via :meth:`Histogram.merge`.  Summed gauges are fleet totals
    (inflight, queue depth, ``mxtpu_kernel_launches``); the router's
    fleet ``/slo`` federates the ratio-style SLO state from merged
    windows instead."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for kind in ("counters", "gauges"):
        for st in states:
            for name, m in (st or {}).get(kind, {}).items():
                dst = out[kind].setdefault(
                    name, {"help": m.get("help", ""), "values": {}})
                for label, val in (m.get("values") or {}).items():
                    dst["values"][label] = \
                        dst["values"].get(label, 0.0) + float(val)
    hist_names = {}
    for st in states:
        for name, hs in (st or {}).get("histograms", {}).items():
            hist_names.setdefault(name, []).append(hs)
    for name, parts in hist_names.items():
        merged = Histogram.merge(parts, max_samples=max_samples)
        merged["help"] = next(
            (p.get("help") for p in parts if p.get("help")), "")
        out["histograms"][name] = merged
    return out


def render_prometheus_state(state: dict, extra_labels: dict = None,
                            type_lines: bool = True) -> str:
    """Prometheus text exposition of a :func:`merge_states` /
    :meth:`MetricsRegistry.export_state` state.  ``extra_labels`` are
    appended to every series."""
    extra = ",".join(f'{k}="{v}"' for k, v in (extra_labels or {}).items())
    lines = []

    def fmt_labels(label_str):
        parts = [f'{k}="{v}"' for k, v in
                 (kv.split("=", 1) for kv in label_str.split(",") if kv)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    for kind, ptype in (("counters", "counter"), ("gauges", "gauge")):
        for name in sorted((state or {}).get(kind, {})):
            m = state[kind][name]
            if type_lines:
                if m.get("help"):
                    lines.append(f"# HELP {name} {m['help']}")
                lines.append(f"# TYPE {name} {ptype}")
            vals = m.get("values") or {}
            if not vals:
                lines.append(f"{name}{fmt_labels('')} 0")
            for label, val in sorted(vals.items()):
                lines.append(f"{name}{fmt_labels(label)} {_fmt_num(val)}")
    for name in sorted((state or {}).get("histograms", {})):
        hs = state["histograms"][name]
        if type_lines:
            if hs.get("help"):
                lines.append(f"# HELP {name} {hs['help']}")
            lines.append(f"# TYPE {name} summary")
        s = Histogram.stats_of(hs)
        for q, k in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            if s[k] is not None:
                lines.append(f'{name}{{quantile="{q}"'
                             + (f",{extra}" if extra else "")
                             + f'}} {repr(s[k])}')
        tail = fmt_labels("")
        lines.append(f"{name}_sum{tail} {repr(float(s['sum']))}")
        lines.append(f"{name}_count{tail} {int(s['count'])}")
        if s["max"] is not None:
            lines.append(f"{name}_max{tail} {repr(s['max'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def counter(name: str, help: str = "") -> Counter:
    return registry.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return registry.gauge(name, help)


def histogram(name: str, help: str = "",
              max_samples: int = 4096) -> Histogram:
    return registry.histogram(name, help, max_samples=max_samples)


# ---------------------------------------------------------------------------
# Span tracer
# ---------------------------------------------------------------------------
def new_request_id() -> str:
    """A fresh 16-hex request id (the server's fallback when a client
    sent no ``x-request-id``)."""
    return uuid.uuid4().hex[:16]


_span_seq = itertools.count(1)


class Span:
    """One timed region: name, category, wall window (``perf_counter``
    floats), attrs, child spans and the opening thread's ident.  ``sid``
    is a process-unique hex id."""

    __slots__ = ("name", "cat", "t0", "t1", "attrs", "children", "tid",
                 "parent", "sid")

    def __init__(self, name: str, cat: str = "span", attrs: dict = None):
        self.name = name
        self.cat = cat
        self.attrs = attrs or None
        self.t0 = None
        self.t1 = None
        self.tid = 0
        self.sid = f"{next(_span_seq):08x}"
        self.parent: Optional["Span"] = None
        self.children: List["Span"] = []

    @property
    def seconds(self) -> Optional[float]:
        if self.t0 is None or self.t1 is None:
            return None
        return self.t1 - self.t0

    def to_dict(self, epoch: float = 0.0, now: float = None) -> dict:
        d = {"name": self.name, "cat": self.cat, "id": self.sid,
             "start_s": None if self.t0 is None
             else round(self.t0 - epoch, 6)}
        if self.t1 is not None:
            d["duration_s"] = round(self.t1 - self.t0, 6)
        else:
            d["open"] = True
            if now is not None and self.t0 is not None:
                d["duration_s"] = round(now - self.t0, 6)
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict(epoch, now)
                             for c in list(self.children)]
        return d


class _SpanCtx:
    """What :func:`trace_span` returns: a no-op while the tracer is off."""

    __slots__ = ("_name", "_cat", "_parent", "_attrs", "span")

    def __init__(self, name, cat, parent, attrs):
        self._name = name
        self._cat = cat
        self._parent = parent
        self._attrs = attrs
        self.span = None

    def __enter__(self):
        if tracer.active:
            self.span = tracer._begin(self._name, self._cat, self._parent,
                                      self._attrs)
        return self.span

    def __exit__(self, *exc):
        if self.span is not None:
            tracer._end(self.span)
        return False


class Tracer:
    """Hierarchical span recorder with thread-local context propagation,
    enabled by refcount (:meth:`enable` / :meth:`disable`).  Finished
    ROOT spans land in a bounded deque and on the ``SPAN`` topic; open
    roots are kept for the live ``/trace`` view.  Cross-thread: capture
    ``ctx = tracer.current()`` and wrap the worker's body in
    ``with tracer.attach(ctx): ...``."""

    def __init__(self, max_finished: int = 512):
        self._tl = threading.local()
        self._lock = threading.Lock()
        self._enable_count = 0
        self._live: Dict[int, Span] = {}
        self._finished = deque(maxlen=max_finished)
        self._epoch = time.perf_counter()

    @property
    def active(self) -> bool:
        return self._enable_count > 0

    def enable(self) -> None:
        with self._lock:
            self._enable_count += 1

    def disable(self) -> None:
        with self._lock:
            self._enable_count = max(0, self._enable_count - 1)

    def clear(self) -> None:
        """Drop recorded spans (open roots stay)."""
        with self._lock:
            self._finished.clear()

    def _stack(self) -> List[Span]:
        s = getattr(self._tl, "stack", None)
        if s is None:
            s = self._tl.stack = []
        return s

    def _begin(self, name, cat="span", parent=None, attrs=None) -> Span:
        stack = self._stack()
        par = parent if parent is not None else \
            (stack[-1] if stack else None)
        if par is None:
            # a remote parent (another process's span, from X-Trace-Id)
            # is recorded as linkage attrs, not as a tree edge
            rc = getattr(self._tl, "remote", None)
            if rc is not None:
                attrs = dict(attrs) if attrs else {}
                attrs.setdefault("trace_id", rc[0])
                attrs.setdefault("remote_parent", rc[1])
        sp = Span(name, cat, attrs)
        sp.t0 = time.perf_counter()
        sp.tid = threading.get_ident()
        sp.parent = par
        if par is not None:
            par.children.append(sp)
        else:
            with self._lock:
                self._live[id(sp)] = sp
        stack.append(sp)
        return sp

    def _end(self, sp: Span) -> None:
        sp.t1 = time.perf_counter()
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:
            stack.remove(sp)
        if sp.parent is None:
            with self._lock:
                self._live.pop(id(sp), None)
                self._finished.append(sp)
            if SPAN.subscribers:
                SPAN.publish(sp)

    def span(self, name: str, cat: str = "span", parent: Span = None,
             **attrs) -> _SpanCtx:
        return _SpanCtx(name, cat, parent, attrs)

    def current(self) -> Optional[Span]:
        stack = getattr(self._tl, "stack", None)
        return stack[-1] if stack else None

    class _Attach:
        __slots__ = ("_span",)

        def __init__(self, span):
            self._span = span

        def __enter__(self):
            tracer._stack().append(self._span)
            return self._span

        def __exit__(self, *exc):
            stack = tracer._stack()
            if stack and stack[-1] is self._span:
                stack.pop()
            elif self._span in stack:
                stack.remove(self._span)
            return False

    class _RemoteAttach:
        __slots__ = ("_ctx", "_prev")

        def __init__(self, ctx):
            self._ctx = ctx
            self._prev = None

        def __enter__(self):
            self._prev = getattr(tracer._tl, "remote", None)
            tracer._tl.remote = self._ctx
            return self._ctx

        def __exit__(self, *exc):
            tracer._tl.remote = self._prev
            return False

    def remote(self, trace_id: str,
               parent_sid: str) -> "Tracer._RemoteAttach":
        """Adopt a REMOTE parent for root spans opened on this thread
        while held: each gets ``trace_id`` and ``remote_parent`` attrs
        naming the upstream hop span (the ``X-Trace-Id`` header)."""
        return Tracer._RemoteAttach((str(trace_id), str(parent_sid)))

    def attach(self, span: Span) -> "Tracer._Attach":
        """Adopt ``span`` as this thread's current span (not closing it)."""
        return Tracer._Attach(span)

    def tree(self, max_finished: int = 64,
             since: Optional[float] = None) -> dict:
        """The ``/trace`` view: open roots plus the most recent finished
        ones; times in seconds since the tracer's creation, ``since``
        (same clock) drops roots that started before it."""
        now = time.perf_counter()
        with self._lock:
            live = list(self._live.values())
            fin = list(self._finished)
        if since is not None:
            cutoff = self._epoch + float(since)
            live = [s for s in live if s.t0 is None or s.t0 >= cutoff]
            fin = [s for s in fin if s.t0 is None or s.t0 >= cutoff]
        fin = fin[-max(0, int(max_finished)):]
        return {
            "epoch_perf_counter": self._epoch,
            "live": [s.to_dict(self._epoch, now) for s in live],
            "finished": [s.to_dict(self._epoch) for s in fin],
        }

    def find_spans(self, attr: str, value, limit: int = 32) -> List[dict]:
        """Spans (any depth, newest roots first) whose ``attrs[attr] ==
        value``, as subtrees: the ``/trace?request_id=`` view."""
        now = time.perf_counter()
        with self._lock:
            roots = list(self._live.values()) + list(self._finished)[::-1]
        out: List[dict] = []

        def walk(sp: Span):
            if len(out) >= limit:
                return
            if sp.attrs and sp.attrs.get(attr) == value:
                out.append(sp.to_dict(self._epoch, now))
                return
            for ch in list(sp.children):
                walk(ch)

        for root in roots:
            if len(out) >= limit:
                break
            walk(root)
        return out


tracer = Tracer()


def trace_span(name: str, cat: str = "span", parent: Span = None,
               **attrs) -> _SpanCtx:
    """``with trace_span("serve.prefill"): ...`` — open a span under the
    thread's current one (a no-op while tracing is off)."""
    return tracer.span(name, cat, parent, **attrs)


# ---------------------------------------------------------------------------
# Device peak FLOP/s and memory gauges (torch.cuda)
# ---------------------------------------------------------------------------
#: fp32 peak FLOP/s outside the tensor cores by card (NVIDIA data
#: sheets); the port serves in fp32.  The longest matching key wins.
GPU_FP32_PEAK_FLOPS = {
    "h100": 67e12,          # SXM part
    "h100 pcie": 51e12,
    "h100 nvl": 60e12,
}


def cpu_peak_flops() -> float:
    """Order-of-magnitude host fp32 peak: cores x clock x 32 FLOPs/cycle.
    An estimate, comparable only across runs on one host."""
    cores = os.cpu_count() or 1
    ghz = 2.0
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("cpu mhz"):
                    ghz = max(ghz, float(line.split(":")[1]) / 1000.0)
                    break
    except (OSError, ValueError):
        pass
    return cores * ghz * 1e9 * 32.0


def device_peak_flops(device=None) -> Optional[dict]:
    """``{"device": name, "flops": peak}``: the fp32 peak of ``device``
    (default ``cuda:0`` when CUDA is up, else the host), named with the
    card; ``flops`` is None for a card missing from
    :data:`GPU_FP32_PEAK_FLOPS`."""
    import torch
    if device is None:
        device = "cuda:0" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cpu":
        return {"device": "cpu", "flops": cpu_peak_flops()}
    name = torch.cuda.get_device_name(dev)
    k = name.lower()
    best = None
    for key, val in GPU_FP32_PEAK_FLOPS.items():
        if key in k and (best is None or len(key) > len(best[0])):
            best = (key, val)
    return {"device": name, "flops": best[1] if best else None}


def sample_device_memory() -> None:
    """Refresh the device-memory gauges from the CUDA caching allocator
    of every initialised device: bytes in tensors (``mx_device_live_
    array_bytes``, all devices), and per device in use and peak.  Reads
    host-side statistics only (no device call), so it is safe beside a
    CUDA graph capture on another thread.  A no-op while CUDA is not
    initialised."""
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return
    g_live = registry.gauge(
        "mx_device_live_array_bytes",
        "total bytes held by live tensors (all CUDA devices)")
    g_use = registry.gauge("mx_device_bytes_in_use",
                           "per-device bytes in use (caching allocator)")
    g_peak = registry.gauge("mx_device_peak_bytes_in_use",
                            "per-device peak bytes in use")
    total = 0
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        use = st.get("allocated_bytes.all.current", 0)
        total += use
        g_use.set(use, device=f"cuda:{i}")
        g_peak.set(st.get("allocated_bytes.all.peak", 0),
                   device=f"cuda:{i}")
    g_live.set(total)


# ---------------------------------------------------------------------------
# Dispatch ledger
# ---------------------------------------------------------------------------
_LEDGER_RESERVOIR = 512


class _LedgerEntry:
    __slots__ = ("site", "dispatches", "seconds_sum", "seconds_max",
                 "samples", "compiles", "compile_seconds", "last_t",
                 "size_fn", "lock", "_key")

    def __init__(self, site: str):
        self.site = site
        self.dispatches = 0
        self.seconds_sum = 0.0
        self.seconds_max = 0.0
        self.samples = deque(maxlen=_LEDGER_RESERVOIR)
        self.compiles = 0
        self.compile_seconds = 0.0
        self.last_t: Optional[float] = None
        self.size_fn: Optional[Callable[[], int]] = None
        self.lock = threading.Lock()
        self._key = (("site", site),)

    def record(self, dt: float) -> None:
        """One dispatch of ``dt`` host seconds."""
        c = _ledger_dispatches
        with c._lock:
            c._values[self._key] = c._values.get(self._key, 0.0) + 1.0
        _ledger_seconds.observe(dt)
        with self.lock:
            self.dispatches += 1
            self.seconds_sum += dt
            if dt > self.seconds_max:
                self.seconds_max = dt
            self.samples.append(dt)
            self.last_t = time.time()

    def record_compile(self, dt: float) -> None:
        """One program made ready (a CUDA graph captured) in ``dt``
        seconds."""
        with self.lock:
            self.compiles += 1
            self.compile_seconds += dt

    def _reset(self) -> None:
        with self.lock:
            self.dispatches = 0
            self.seconds_sum = 0.0
            self.seconds_max = 0.0
            self.samples.clear()
            self.compiles = 0
            self.compile_seconds = 0.0
            self.last_t = None


_ledger_dispatches = registry.counter(
    "mxtpu_dispatches_total",
    "program dispatches (CUDA graph replays), by site")
_ledger_seconds = registry.histogram(
    "mxtpu_dispatch_seconds",
    "host wall seconds per program dispatch, staging and read-back "
    "included (all sites)")
_ledger: Dict[str, _LedgerEntry] = {}
_ledger_lock = threading.Lock()


def ledger_site(site: str,
                size_fn: Optional[Callable[[], int]] = None) -> _LedgerEntry:
    """The ledger row of ``site`` (created at first use); ``size_fn``, when
    given, replaces the row's count of ready programs (the latest owner
    of a site name wins)."""
    e = _ledger.get(site)
    if e is None:
        with _ledger_lock:
            e = _ledger.setdefault(site, _LedgerEntry(site))
    if size_fn is not None:
        e.size_fn = size_fn
    return e


def dispatch_ledger(prefix: Optional[str] = None) -> Dict[str, dict]:
    """JSON-ready snapshot of the ledger: per site the dispatch count,
    wall-time stats over the bounded reservoir, captures and their
    seconds, seconds since the last dispatch, and the number of programs
    of the site ready to run (``compiled``).  ``prefix`` filters sites
    (``"serving:gpt:"`` for one engine)."""
    now = time.time()
    out: Dict[str, dict] = {}
    with _ledger_lock:
        entries = dict(_ledger)
    for site in sorted(entries):
        if prefix is not None and not site.startswith(prefix):
            continue
        e = entries[site]
        with e.lock:
            data = sorted(e.samples)
            d = {
                "site": site,
                "dispatches": e.dispatches,
                "seconds_sum": round(e.seconds_sum, 6),
                "seconds_max": round(e.seconds_max, 6),
                "compiles": e.compiles,
                "compile_seconds": round(e.compile_seconds, 6),
                "last_dispatch_age_s": None if e.last_t is None
                else round(now - e.last_t, 3),
            }
        if data:
            d["seconds_p50"] = round(_nearest_rank(data, 0.5), 6)
            d["seconds_p99"] = round(_nearest_rank(data, 0.99), 6)
        compiled = None
        if e.size_fn is not None:
            try:
                compiled = int(e.size_fn())
            except Exception:       # a dropped owner reports nothing
                compiled = None
        d["compiled"] = compiled
        out[site] = d
    return out


def reset_dispatch_ledger() -> None:
    """Zero every ledger row in place (rows stay registered: engines
    hold direct references)."""
    with _ledger_lock:
        entries = list(_ledger.values())
    for e in entries:
        e._reset()


# ---------------------------------------------------------------------------
# StepHealth ring (health plane)
# ---------------------------------------------------------------------------
class StepHealthRing:
    """Bounded ring of per-step health records (``MXNET_HEALTH_RING``,
    default 256).  The serving plane reports through ``health.report``;
    the training monitor that fills this ring is not ported yet."""

    def __init__(self, size: Optional[int] = None):
        self._size = size
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self._capacity())

    def _capacity(self) -> int:
        n = self._size if self._size is not None \
            else getenv_int("MXNET_HEALTH_RING", 256)
        return max(1, int(n))

    def record(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)

    def entries(self, last: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._ring)
        return out[-int(last):] if last else out

    def clear(self) -> None:
        with self._lock:
            self._ring = deque(maxlen=self._capacity())

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


health_ring = StepHealthRing()


# ---------------------------------------------------------------------------
# Collector: the subscribers that turn FAULT events into metrics
# ---------------------------------------------------------------------------
_started = False
_m: Dict[str, object] = {}


def _metrics_init():
    c = registry.counter
    _m["faults"] = c("mxtpu_faults_injected",
                     "deterministic faults injected, by site/kind")
    _m["retries"] = c("mxtpu_retries",
                      "transient failures absorbed by retry, by site")
    _m["giveups"] = c("mxtpu_giveups",
                      "retries exhausted (max attempts/deadline), by site")
    _m["skipped_steps"] = c("mxtpu_skipped_steps",
                            "optimizer steps skipped by the non-finite "
                            "gradient guard")
    _m["peak_flops"] = registry.gauge(
        "mxtpu_device_peak_flops",
        "fp32 peak FLOP/s of the device, by device name")


def _on_fault(site="?", event="injected", kind=None, **_kw):
    if event == "injected":
        _m["faults"].inc(site=site, kind=kind or "?")
    elif event == "retry":
        _m["retries"].inc(site=site)
    elif event == "giveup":
        _m["giveups"].inc(site=site)
    elif event == "skipped_step":
        _m["skipped_steps"].inc()


def start() -> None:
    """Begin collecting: subscribe the FAULT handler, turn the span
    tracer on and start the flight recorder.  Idempotent."""
    global _started
    if _started:
        return
    _metrics_init()
    peak = device_peak_flops()
    if peak["flops"] is not None:
        _m["peak_flops"].set(peak["flops"], device=peak["device"])
    FAULT.subscribe(_on_fault)
    tracer.enable()
    _started = True
    from . import telemetry_ring     # imports this module
    telemetry_ring.recorder.start()


def stop() -> None:
    """Detach the collector (metric values are kept; see reset())."""
    global _started
    FAULT.unsubscribe(_on_fault)
    if _started:
        tracer.disable()
        from . import telemetry_ring
        telemetry_ring.recorder.stop()
    _started = False


def enabled() -> bool:
    return _started


def reset() -> None:
    """Zero all metric values, drop recorded spans, zero the ledger and
    clear the health ring."""
    registry.reset()
    tracer.clear()
    reset_dispatch_ledger()
    health_ring.clear()


# ---------------------------------------------------------------------------
# Exporters over the default registry
# ---------------------------------------------------------------------------
def snapshot(include_memory: bool = True) -> dict:
    """JSON-ready dict of every metric (device-memory gauges refreshed
    first)."""
    if include_memory:
        sample_device_memory()
    out = registry.snapshot()
    out["enabled"] = _started
    return out


def render_prometheus(include_memory: bool = True) -> str:
    """Prometheus text exposition of every metric."""
    if include_memory:
        sample_device_memory()
    return registry.render_prometheus()


def counters_flat() -> Dict[str, float]:
    return registry.counters_flat()


# ---------------------------------------------------------------------------
# Env autostart
# ---------------------------------------------------------------------------
if getenv_bool("MXNET_TELEMETRY", False):
    start()
