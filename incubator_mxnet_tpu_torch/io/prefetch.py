"""Device-side prefetch for the training loop (counterpart of
``incubator_mxnet_tpu/io/prefetch.py``).

:class:`DevicePrefetcher` wraps any batch iterable (a list, a generator,
a data loader) with a worker thread that fetches ahead of the consumer
and places each batch on the device, ``buffers`` batches deep
(``MXNET_PREFETCH_BUFFERS``, default 2), so batch i+1 is on the card
while batch i computes.

Placement on the card: the worker packs a batch's arrays into one pinned
host buffer, copies it to the device with one non-blocking copy on a side
stream and records an event behind the copy.  The consumer's stream waits
on that event before anything reads the batch, and the batch's device
memory is marked used by the consumer's stream, so the allocator never
hands it back to the side stream early.  The pinned buffers form a ring
of ``buffers + 2`` slots, and a slot is rewritten only once its last
copy's event has completed.  On the CPU (``device="cpu"``) a batch is
placed as CPU tensors.

Fault semantics (``fault.py`` sites ``dataloader.fetch`` and
``prefetch.h2d``), as in the reference: transient errors are absorbed by
``retry_call``; when the retries are exhausted the pipeline degrades to
blocking in-order fetch on the consumer's thread instead of deadlocking
or dropping a batch (a FAULT ``fallback`` event).  The worker polls the
fault site before it consumes from the upstream iterator, so a failed
attempt never loses a batch; a batch fetched but not transferred rides
the degrade marker and is placed by the consumer; an error raised inside
the upstream iterator reaches the consumer."""
from __future__ import annotations

import queue as _queue
import threading
import time as _time

import numpy as _np
import torch

from ..base import getenv_int
from ..context import resolve_device
from .. import fault as _fault
from .. import telemetry as _telemetry

__all__ = ["DevicePrefetcher"]

_OK, _END, _ERR, _DEGRADE = 0, 1, 2, 3
_ALIGN = 16     # bytes: each array's offset in a packed buffer


class _UpstreamError(Exception):
    """An error raised inside the upstream iterator (not by the
    prefetcher's own fault poll).  Not transient: a generator that raised
    is dead, so a retry would truncate the stream; it propagates to the
    consumer."""

    def __init__(self, orig):
        super().__init__(str(orig))
        self.orig = orig


def _host_tensor(a) -> torch.Tensor:
    """A batch array (numpy, tensor, NDArray or scalar) as a contiguous
    CPU tensor."""
    data = getattr(a, "_data", None)
    if isinstance(data, torch.Tensor):
        a = data
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous()
    return torch.from_numpy(_np.ascontiguousarray(_np.asarray(a)))


class _Slot:
    __slots__ = ("host", "event")

    def __init__(self):
        self.host = None
        self.event = None


class _PinnedStaging:
    """The ring of pinned host buffers and the side stream that copies a
    packed batch to the card."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [_Slot() for _ in range(slots)]
        self.next = 0

    def place(self, tensors):
        """Pack ``tensors`` (CPU) into the next pinned slot and copy it to
        the device: returns (device views in order, the copy's event)."""
        offs, total = [], 0
        for t in tensors:
            offs.append(total)
            total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        if slot.event is not None:
            slot.event.synchronize()      # its last copy has been read
        if slot.host is None or slot.host.numel() < total:
            slot.host = torch.empty(max(total, _ALIGN), dtype=torch.uint8,
                                    pin_memory=True)
        for t, off in zip(tensors, offs):
            nb = t.numel() * t.element_size()
            slot.host[off:off + nb].view(t.dtype).view(t.shape).copy_(t)
        with torch.cuda.stream(self.stream):
            dev = torch.empty(max(total, _ALIGN), dtype=torch.uint8,
                              device=self.device)
            dev.copy_(slot.host[:dev.numel()], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        slot.event = event
        views = [dev[off:off + t.numel() * t.element_size()]
                 .view(t.dtype).view(t.shape)
                 for t, off in zip(tensors, offs)]
        return views, event


class DevicePrefetcher:
    """Iterate ``source`` with fetch and host-to-device placement staged
    ``buffers`` deep, on ``device`` (default ``cuda:0``; raises without a
    card unless ``device="cpu"``).  ``placement``, when given, is applied
    to every array of a batch instead of the pinned copy.  Close (or
    exhaust) the iterator to join the worker; it is also a context
    manager."""

    def __init__(self, source, placement=None, buffers=None,
                 fetch_site="dataloader.fetch", h2d_site="prefetch.h2d",
                 device=None):
        self._device = resolve_device(device)
        self._it = iter(source)
        self._placement = placement
        self._buffers = int(buffers) if buffers is not None \
            else max(getenv_int("MXNET_PREFETCH_BUFFERS", 2), 1)
        self._fetch_site = fetch_site
        self._h2d_site = h2d_site
        self._staging = _PinnedStaging(self._device, self._buffers + 2) \
            if placement is None and self._device.type == "cuda" else None
        self._q = _queue.Queue(maxsize=self._buffers)
        self._stop = threading.Event()
        self._degraded = False
        self._batches = 0
        self._wait_seconds = 0.0
        self._thread = threading.Thread(
            target=self._worker, name="mxtpu-prefetch", daemon=True)
        self._thread.start()

    # -------------------------------------------------- worker side
    def _fetch_upstream(self):
        # poll the injection site BEFORE touching the iterator: a raised
        # fault then costs a retry, never a batch
        _fault.inject(self._fetch_site)
        try:
            return next(self._it)
        except StopIteration:
            raise
        except Exception as e:
            raise _UpstreamError(e) from e

    def _place(self, batch):
        """(placed batch, the copy's event or None)."""
        single = not isinstance(batch, (tuple, list))
        arrs = (batch,) if single else tuple(batch)
        event = None
        if self._placement is not None:
            placed = tuple(self._placement(a) for a in arrs)
        elif self._staging is not None:
            placed, event = self._staging.place(
                [_host_tensor(a) for a in arrs])
            placed = tuple(placed)
        else:
            placed = tuple(_host_tensor(a).clone() for a in arrs)
        return (placed[0] if single else placed), event

    def _transfer(self, batch):
        _fault.inject(self._h2d_site)
        placed, event = self._place(batch)
        if _telemetry.TRANSFER.subscribers:
            arrs = placed if isinstance(placed, tuple) else (placed,)
            nbytes = sum(int(a.numel() * a.element_size()) for a in arrs
                         if isinstance(a, torch.Tensor))
            _telemetry.TRANSFER.publish(direction="h2d", nbytes=nbytes)
        return placed, event

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = _fault.retry_call(self._fetch_upstream,
                                          site=self._fetch_site)
            except StopIteration:
                self._put((_END, None))
                return
            except _UpstreamError as e:
                self._put((_ERR, e.orig))
                return
            except _fault.TRANSIENT:
                # retries exhausted: hand the iterator back to the
                # consumer for blocking in-order fetch (no batch was
                # consumed: the poll precedes next())
                self._put((_DEGRADE, None))
                return
            except Exception as e:          # a bug upstream
                self._put((_ERR, e))
                return
            try:
                placed = _fault.retry_call(self._transfer, batch,
                                           site=self._h2d_site)
            except _fault.TRANSIENT:
                # fetched but not transferred: ship it raw so the consumer
                # places it, in order
                self._put((_DEGRADE, batch))
                return
            except Exception as e:
                self._put((_ERR, e))
                return
            if not self._put((_OK, placed)):
                return

    # -------------------------------------------------- consumer side
    def __iter__(self):
        return self

    def _ready(self, placed_event):
        """The batch, after the consumer's stream has been made to wait
        for its copy and its memory marked used by that stream."""
        placed, event = placed_event
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in (placed if isinstance(placed, tuple) else (placed,)):
                t.record_stream(stream)
        self._batches += 1
        return placed

    def __next__(self):
        if self._degraded:
            return self._fetch_blocking()
        t0 = _time.perf_counter()
        with _telemetry.trace_span("prefetch.wait", cat="dataloader"):
            while True:
                try:
                    tag, payload = self._q.get(timeout=0.5)
                    break
                except _queue.Empty:
                    if self._thread is None or not self._thread.is_alive():
                        # the worker died without a terminal marker:
                        # degrade rather than deadlock
                        tag, payload = _DEGRADE, None
                        break
        wait = _time.perf_counter() - t0
        self._wait_seconds += wait
        if _telemetry.DATALOADER.subscribers:
            _telemetry.DATALOADER.publish(seconds=wait)
        if tag == _OK:
            return self._ready(payload)
        if tag == _END:
            self.close()
            raise StopIteration
        if tag == _ERR:
            self.close()
            raise payload
        # _DEGRADE: go on synchronously on this thread, in order
        self._degraded = True
        _telemetry.FAULT.publish(
            site=self._h2d_site if payload is not None
            else self._fetch_site, event="fallback")
        if payload is not None:
            # the worker's fetched-but-untransferred batch, placed here
            # through the same fault site and TRANSFER accounting
            return self._ready(_fault.retry_call(
                self._transfer, payload, site=self._h2d_site))
        return self._fetch_blocking()

    def _fetch_blocking(self):
        try:
            batch = _fault.retry_call(self._fetch_upstream,
                                      site=self._fetch_site)
        except _UpstreamError as e:
            raise e.orig
        return self._ready(_fault.retry_call(self._transfer, batch,
                                             site=self._h2d_site))

    # -------------------------------------------------- lifecycle
    def close(self):
        """Stop the worker and join it; idempotent."""
        self._stop.set()
        # drain so a worker blocked on put() sees the stop flag
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def stats(self):
        """{'batches', 'wait_seconds', 'degraded', 'buffers'}: a consumer
        wait near 0 means fetch and placement overlapped compute."""
        return {"batches": self._batches,
                "wait_seconds": round(self._wait_seconds, 6),
                "degraded": self._degraded,
                "buffers": self._buffers}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
