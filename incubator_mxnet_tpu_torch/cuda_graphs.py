"""CUDA graph capture as the port's programs use it: the serving engine's
closed program set and the train step.

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

The kernel launches made while capturing (on this thread, or on the
autograd engine's device thread during a captured backward) are the
graph's tally, not launches: pass it to
:func:`.kernels.flash_attention.add_launches` at each replay."""
from __future__ import annotations

import gc
import threading

import torch

from .kernels.flash_attention import captured_launches

__all__ = ["CAPTURE_LOCK", "on_side_stream", "capture"]

CAPTURE_LOCK = threading.Lock()


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
    collecting = gc.isenabled()
    try:
        gc.disable()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        with captured_launches() as tally:
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = fn()
        grown = torch.cuda.memory_reserved(device) - reserved
    finally:
        if collecting:
            gc.enable()
    return graph, out, dict(tally), grown
