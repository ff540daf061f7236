"""Device contexts (counterpart of ``incubator_mxnet_tpu/context.py``).

A :class:`Context` names a device, ``cpu(0)`` or ``gpu(i)``, and maps to a
``torch.device`` (``Context.device``).  It is also a ``with`` scope that
sets the current context of its thread, as the reference's does: ``with
mx.cpu():`` makes every entry point, layer and array created inside it
land on the CPU.

The port's default differs from the reference's on purpose: outside any
scope the current context is ``gpu(0)`` (``cuda:0``), and where no GPU is
present that raises :class:`MXNetError` instead of quietly running on the
CPU."""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "default_device",
           "resolve_device", "num_gpus"]


class Context:
    """A device context ``(device_type, device_id)``, usable as a ``with``
    scope that makes it the thread's current context."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    _default = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        elif isinstance(device_type, torch.device):
            kind = {"cpu": "cpu", "cuda": "gpu"}.get(device_type.type)
            if kind is None:
                raise MXNetError(f"unsupported device {device_type} (use "
                                 "'cpu' or 'cuda:N')")
            device_type, device_id = kind, device_type.index or 0
        if device_type not in self.devstr2type:
            raise MXNetError(f"unknown device type {device_type!r} "
                             "(use 'cpu' or 'gpu')")
        self.device_typeid = self.devstr2type[device_type]
        self.device_id = int(device_id)
        self._old: list = []

    @property
    def device_type(self) -> str:
        return self.devtype2str[self.device_typeid]

    @property
    def device(self) -> torch.device:
        """The ``torch.device``; a GPU context raises without that GPU."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{self} requested but no CUDA device is available; use "
                "mx.cpu() (or device='cpu') to run on the CPU")
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise MXNetError(f"{self} out of range: {n} CUDA device(s)")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        self._old.append(getattr(Context._default, "value", None))
        Context._default.value = self
        return self

    def __exit__(self, *exc):
        Context._default.value = self._old.pop()
        return False


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    """The context of CUDA device ``device_id``; raises when it is
    absent."""
    ctx = Context("gpu", device_id)
    ctx.device                      # raises without that device
    return ctx


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context() -> Context:
    """The thread's ``with`` scope, else ``gpu(0)`` (raises without a
    GPU)."""
    ctx = getattr(Context._default, "value", None)
    return ctx if ctx is not None else gpu(0)


def default_device() -> torch.device:
    """The current context's ``torch.device``: ``cuda:0`` outside any
    scope (raises when there is no GPU)."""
    return current_context().device


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` of ``device`` (a :class:`Context`, string or
    ``torch.device``; None for the current context); a CUDA device must
    exist."""
    return as_context(device).device


def as_context(device: Optional[object]) -> Context:
    """A :class:`Context` for ``device`` (a Context, torch.device, string
    or None for the current context)."""
    if device is None:
        return current_context()
    if isinstance(device, Context):
        return device
    try:
        dev = torch.device(device)
    except (RuntimeError, TypeError) as e:
        raise MXNetError(f"unsupported device {device!r} (use 'cpu' or "
                         "'cuda:N')") from e
    return Context(dev)
