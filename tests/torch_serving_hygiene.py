"""Hygiene shared by the port's one-shot serving tests
(``test_torch_oneshot.py``, ``test_torch_dynamic_batcher.py``).

Those files share xdist workers with the JAX package's serving tests, so
they leave the process as they found it:

* :func:`module_hygiene` pins torch to one intra-op thread for the module
  and restores the old count; at the module's end it asserts that no
  non-daemon thread the module started is alive and that no listening
  socket it opened is still open;
* :func:`clean_state` resets the port's process-wide serving state (fault
  plan, telemetry, SLO windows, flight recorder, shutdown flag) around
  every test and restores the SIGTERM and SIGINT handlers a test
  installed;
* :func:`closer` closes every batcher and server a test registers with
  it, in its finaliser, whatever the test's outcome.

A test module takes the fixtures by importing them.  Environment
variables are set only through ``monkeypatch``."""
import os
import signal
import threading

import pytest
import torch

from incubator_mxnet_tpu_torch import fault, telemetry, telemetry_ring
from incubator_mxnet_tpu_torch.serving import lifecycle, slo

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def listening_sockets() -> set:
    """Inodes of the TCP sockets in the LISTEN state that this process
    holds (Linux ``/proc``)."""
    mine = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            link = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        if link.startswith("socket:["):
            mine.add(link[len("socket:["):-1])
    listening = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            cols = row.split()
            if cols[3] == "0A" and cols[9] in mine:
                listening.add(cols[9])
    return listening


@pytest.fixture(scope="module", autouse=True)
def module_hygiene():
    threads = set(threading.enumerate())
    sockets = listening_sockets()
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)
    leaked = [t.name for t in threading.enumerate()
              if t not in threads and t.is_alive() and not t.daemon]
    assert not leaked, f"non-daemon threads left running: {leaked}"
    opened = listening_sockets() - sockets
    assert not opened, f"listening sockets left open: {sorted(opened)}"


def _reset():
    fault.clear_plan()
    telemetry.stop()
    telemetry.reset()
    slo.tracker.reset()
    telemetry_ring.recorder.reset()
    lifecycle.reset_shutdown_state()


@pytest.fixture(autouse=True)
def clean_state():
    handlers = {s: signal.getsignal(s) for s in _SIGNALS}
    _reset()
    yield
    _reset()
    for s, h in handlers.items():
        if signal.getsignal(s) is not h:
            signal.signal(s, h)


@pytest.fixture
def closer():
    """``closer(obj)`` registers a batcher or server (returned as is);
    the finaliser closes each without draining."""
    held = []

    def track(obj):
        held.append(obj)
        return obj

    yield track
    for obj in reversed(held):
        if hasattr(obj, "stop"):
            obj.stop(drain=False)
        else:
            obj.close(drain=False, timeout=5)
