"""CUDA graph capture as the port's programs use it: the serving engine's
closed program set, the train step and a hybridized Gluon block's forward
and backward (two captures into one pool, the pattern of
``torch.cuda.make_graphed_callables``).

A capture follows four rules:

* captures are serialised process-wide (:data:`CAPTURE_LOCK`): two
  background captures would otherwise toggle the cyclic collector and
  empty the allocator's cache under each other;
* the cyclic collector is off while the capture is open: a CUDA graph
  freed during a capture invalidates it;
* the allocator's cache is emptied first, so the memory reserved during
  the capture is what the graph pool takes;
* ``capture_error_mode="thread_local"``: another thread replaying its own
  graphs does not invalidate this capture.

Beside them, every serving program's dispatch (staging, capture or
replay, read-back) holds :data:`DISPATCH_GATE` shared, and the profiler
stops holding it exclusive: on an H100 (CUDA 12.8, torch 2.11)
``torch.profiler``'s stop, a ``cudaDeviceSynchronize`` on the profiling
thread, deadlocked against a batcher thread's ``cudaGraphLaunch`` while
CUPTI traced them (``tools/torch_profile_capture.py``).

The kernel launches made while capturing (on this thread, or on the
autograd engine's device thread during a captured backward) are the
graph's tally, not launches: pass it to
:func:`.kernels.flash_attention.add_launches` at each replay.

A capture registers the port's generator of its device (``random``,
dropout's masks) with the graph, so each replay draws from the
generator's state at that moment, as an eager run would, and advances
it: a new mask every replay, the one the eager body would draw.  A draw
under capture from any other generator, or where this torch cannot
register one, raises :class:`MXNetError` (:func:`check_capture_draws`)
rather than replaying one mask.

:func:`counted` runs a program's body eagerly and counts its FLOPs from
shapes, the MFU collector's numerator: ``torch.utils.flop_counter.
FlopCounterMode`` for the aten ops, plus what the attention kernels report
for themselves (a hand-written kernel is invisible to the counter)."""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

from . import random as _random
from .base import MXNetError
from .kernels.flash_attention import captured_launches, counted_flops

__all__ = ["CAPTURE_LOCK", "DISPATCH_GATE", "DispatchGate",
           "on_side_stream", "capture", "check_capture_draws", "counted", "HostCopy"]

CAPTURE_LOCK = threading.Lock()
# the ids of the generators the open capture registered (None outside a
# capture): process-wide, as a captured backward draws on the autograd
# engine's device thread; captures are serialised (CAPTURE_LOCK)
_open_gens = None


class DispatchGate:
    """A shared/exclusive gate.  Any number of threads hold it shared at
    once (not reentrant: a thread must not take it shared twice); an
    exclusive holder waits until no shared hold is left and keeps new ones
    out until it is done, and a waiting exclusive holder already keeps new
    shared ones out, so a busy server cannot starve it."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._waiting = 0

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            while self._exclusive or self._waiting:
                self._cond.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                if not self._shared:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            self._waiting += 1
            try:
                while self._exclusive or self._shared:
                    self._cond.wait()
            finally:
                self._waiting -= 1
            self._exclusive = True
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()


#: held shared by every serving program's dispatch and by the engine's
#: cache reset, exclusive by the profiler's stop
#: (``telemetry_device.capture_profile``)
DISPATCH_GATE = DispatchGate()


def on_side_stream(fn, device):
    """Run ``fn()`` on a new side stream of ``device`` (after the current
    stream's work, before any later work on it) and wait for the card;
    returns ``fn``'s result.  The warm-up PyTorch asks for before a
    capture."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    torch.cuda.synchronize(device)
    return out


def capture(fn, device, pool):
    """Capture ``fn()`` into a new ``torch.cuda.CUDAGraph`` in ``pool``
    (``torch.cuda.graph_pool_handle()``); the caller holds
    :data:`CAPTURE_LOCK`.  Nothing runs.  Returns (graph, ``fn``'s
    outputs, the kernel launches the graph holds, the bytes the capture
    added to the allocator's reserve)."""
    global _open_gens
    collecting = gc.isenabled()
    gen = None
    try:
        gc.disable()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        _open_gens = set()
        register = getattr(graph, "register_generator_state", None)
        if register is not None:          # torch >= 2.4
            gen = _random.generator(device)
            register(gen)
            _open_gens.add(id(gen))
        with captured_launches() as tally:
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = fn()
        grown = torch.cuda.memory_reserved(device) - reserved
    except BaseException:
        if gen is not None:
            _end_capture_of(gen)
        raise
    finally:
        _open_gens = None
        if collecting:
            gc.enable()
    return graph, out, dict(tally), grown


def _end_capture_of(gen) -> None:
    """Take ``gen`` out of capture mode after a failed capture: torch ends
    a registered generator's capture only in a capture that ends well, and
    until then every draw from it outside a capture raises.  An empty
    capture that registers it ends it; the graphs registered before keep
    drawing from it."""
    empty = torch.cuda.CUDAGraph()
    empty.register_generator_state(gen)
    with torch.cuda.graph(empty, capture_error_mode="thread_local"):
        pass


def check_capture_draws(gen) -> None:
    """Raise :class:`MXNetError` unless the open capture registered
    ``gen`` (a draw from it under capture is then replayed with each
    replay's own state)."""
    gens = _open_gens
    if gens is None or id(gen) not in gens:
        raise MXNetError(
            "a random draw (dropout) under CUDA graph capture from a "
            "generator the capture did not register: every replay would "
            "reuse one mask.  Capture through cuda_graphs.capture (it "
            "registers the port's generator of its device; torch >= 2.4), "
            "or set dropout to 0")


def counted(fn):
    """Run ``fn()`` eagerly and count its FLOPs from shapes: the aten ops
    through ``FlopCounterMode`` (matrix products, convolutions, SDPA) and
    the attention kernels' own counts (:func:`.kernels.flash_attention.
    counted_flops`).  Returns (``fn``'s result, FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode
    with counted_flops() as extra:
        with FlopCounterMode(display=False) as mode:
            out = fn()
    return out, float(mode.get_total_flops() + extra[0])


class HostCopy:
    """Device tensors on their way to the host without a sync: each is
    copied into pinned memory with a non-blocking copy behind one recorded
    event (CPU tensors are cloned).  ``ready()`` polls the event (the
    counterpart of JAX's ``is_ready()``); ``wait()`` waits for it and
    returns the host tensors.  A captured program's static outputs may be
    overwritten by its next replay: the copy is ordered before it on the
    stream."""

    def __init__(self, *tensors):
        self._event = None
        self._host = []
        for t in tensors:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
            else:
                h = t.detach().clone()
            self._host.append(h)
        if any(t.is_cuda for t in tensors):
            self._event = torch.cuda.Event()
            self._event.record()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self):
        """The host copies, in the order given."""
        if self._event is not None:
            self._event.synchronize()
        return self._host
