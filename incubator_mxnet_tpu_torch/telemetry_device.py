"""Device-memory observability of the port (counterpart of
``incubator_mxnet_tpu/telemetry_device.py``, without the profiler
capture, which comes in a later slice).

* **Per-owner attribution** — owners register a byte-count callback
  (:func:`register_owner`: ``kv:<model>``, ``params:<model>``) and
  :func:`sample` folds them into ``mxtpu_device_owned_bytes{owner=...}``;
  the bytes held by tensors that no owner claims land in
  ``mxtpu_device_unattributed_bytes``.
* **Program inventories** — engines register their program accounting
  (:func:`register_inventory`); :func:`program_report` is the
  ``GET /programs`` body: the dispatch ledger plus every engine's
  expected-against-captured programs.
* **OOM forensics** — :func:`is_oom` recognises ``torch.cuda.
  OutOfMemoryError`` (and errors carrying ``RESOURCE_EXHAUSTED``, the
  reference's marker, which an injected fault can carry);
  :func:`report_oom` publishes the FAULT ``oom`` event that the flight
  recorder turns into one dump carrying :func:`memory_breakdown` and
  :func:`program_report`.

Memory numbers come from the CUDA caching allocator's host-side
statistics (``torch.cuda.memory_stats`` per device): reading them issues
no device call, so a sampler thread may run beside a CUDA graph capture.
A background sampler (:func:`start_sampler`) refreshes the gauges every
``MXNET_DEVICE_MEM_INTERVAL_SECONDS`` (0, the default, disables it)."""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from .base import getenv_float
from . import telemetry as _telemetry
from . import telemetry_ring as _ring

__all__ = [
    "register_owner", "owned_bytes", "register_inventory",
    "memory_breakdown", "program_report", "sample",
    "start_sampler", "stop_sampler", "is_oom", "report_oom",
    "default_sample_interval",
]


def default_sample_interval() -> float:
    """``MXNET_DEVICE_MEM_INTERVAL_SECONDS``: background memory-gauge
    sampling cadence (0 disables the sampler thread)."""
    return getenv_float("MXNET_DEVICE_MEM_INTERVAL_SECONDS", 0.0)


_g_owned = _telemetry.registry.gauge(
    "mxtpu_device_owned_bytes",
    "attributed device bytes, by owner (kv:<model>/params:<model>)")
_g_unattributed = _telemetry.registry.gauge(
    "mxtpu_device_unattributed_bytes",
    "bytes held by live tensors that no registered owner claims")
_c_oom = _telemetry.registry.counter(
    "mxtpu_oom_failures",
    "device out-of-memory dispatch failures, by site")

_lock = threading.Lock()
_owners: Dict[str, Callable[[], float]] = {}
_inventories: Dict[str, Callable[[], dict]] = {}


# ---------------------------------------------------------------------------
# Per-owner attribution and program inventories
# ---------------------------------------------------------------------------
def register_owner(owner: str, fn: Callable[[], float]) -> None:
    """Register (or replace) a device-memory owner: ``fn()`` returns the
    bytes attributed to ``owner``."""
    with _lock:
        _owners[owner] = fn


def owned_bytes() -> Dict[str, float]:
    """owner -> bytes for every registered owner (a failing callback
    reports 0: attribution never takes the program down)."""
    with _lock:
        owners = dict(_owners)
    out = {}
    for name, fn in owners.items():
        try:
            out[name] = float(fn() or 0.0)
        except Exception:
            out[name] = 0.0
    return out


def register_inventory(name: str, fn: Callable[[], dict]) -> None:
    """Register (or replace) an engine's program-inventory callback."""
    with _lock:
        _inventories[name] = fn


def program_report() -> dict:
    """``GET /programs``: the dispatch ledger plus every registered
    engine's own accounting."""
    with _lock:
        inventories = dict(_inventories)
    engines = {}
    for name, fn in inventories.items():
        try:
            engines[name] = fn()
        except Exception as e:      # a sick engine is itself data
            engines[name] = {"error": repr(e)}
    return {"sites": _telemetry.dispatch_ledger(), "engines": engines}


# ---------------------------------------------------------------------------
# Memory breakdown and gauges
# ---------------------------------------------------------------------------
def memory_breakdown() -> dict:
    """Per-device bytes in use, peak and limit (``cuda:<i>``; none on a
    host where CUDA is not initialised), the bytes held by live tensors,
    and the per-owner attribution with its unattributed residue.  The
    reference's keys."""
    import torch
    out = {"devices": {}, "owners": owned_bytes(),
           "live_array_bytes": 0.0}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            st = torch.cuda.memory_stats(i)
            use = st.get("allocated_bytes.all.current", 0)
            out["live_array_bytes"] += float(use)
            out["devices"][f"cuda:{i}"] = {
                "bytes_in_use": use,
                "peak_bytes_in_use": st.get("allocated_bytes.all.peak", 0),
                "bytes_limit":
                    torch.cuda.get_device_properties(i).total_memory}
    total_owned = sum(out["owners"].values())
    out["owned_bytes"] = total_owned
    out["unattributed_bytes"] = max(
        0.0, out["live_array_bytes"] - total_owned)
    return out


def sample() -> dict:
    """Refresh every device-memory gauge and return the breakdown."""
    _telemetry.sample_device_memory()
    bd = memory_breakdown()
    for owner, nbytes in bd["owners"].items():
        _g_owned.set(nbytes, owner=owner)
    _g_unattributed.set(bd["unattributed_bytes"])
    return bd


_sampler_stop: Optional[threading.Event] = None


def start_sampler(interval: Optional[float] = None) -> bool:
    """Start the background gauge sampler at ``interval`` seconds
    (default ``MXNET_DEVICE_MEM_INTERVAL_SECONDS``); False (nothing
    started) when the interval is 0 or a sampler already runs."""
    global _sampler_stop
    iv = default_sample_interval() if interval is None else float(interval)
    if iv <= 0:
        return False
    with _lock:
        if _sampler_stop is not None:
            return False
        stop = _sampler_stop = threading.Event()

    def loop():
        while not stop.wait(iv):
            try:
                sample()
            except Exception:       # a sampler never takes the server down
                pass

    threading.Thread(target=loop, name="mxtorch-device-mem",
                     daemon=True).start()
    return True


def stop_sampler() -> None:
    global _sampler_stop
    with _lock:
        stop = _sampler_stop
        _sampler_stop = None
    if stop is not None:
        stop.set()


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------
def is_oom(err: BaseException) -> bool:
    """True when ``err`` is a device out-of-memory: a
    ``torch.cuda.OutOfMemoryError``, or an error whose text carries
    ``RESOURCE_EXHAUSTED`` or ``CUDA out of memory`` (an injected fault
    with that text drills the same path)."""
    import torch
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(err).__name__}: {err}"
    return "RESOURCE_EXHAUSTED" in text or "CUDA out of memory" in text


def report_oom(site: str, err: BaseException, **ctx) -> None:
    """Publish the FAULT ``oom`` event of an out-of-memory dispatch; the
    flight recorder writes one debounced dump for it.  Extra ``ctx``
    (``model=``, ``request_ids=``) rides on the ring entry."""
    _c_oom.inc(site=site)
    try:        # the dump's metrics should show the memory AT the failure
        sample()
    except Exception:
        pass
    _telemetry.FAULT.publish(site=site, event="oom",
                             error=f"{type(err).__name__}: {err}"[:300],
                             **ctx)


_ring.recorder.register_provider("device_memory", memory_breakdown)
_ring.recorder.register_provider("programs", program_report)
