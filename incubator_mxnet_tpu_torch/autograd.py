"""Autograd over ``torch.autograd`` (counterpart of
``incubator_mxnet_tpu/autograd.py``).

There is no tape of our own.  ``record()`` turns torch's thread-local grad
mode on for its scope and ``pause()`` turns it off, and the NDArray op
funnel (``ndarray._invoke``) and a Gluon block called with NDArrays set
it to :func:`is_recording`, so torch builds the graph exactly for what is
recorded and nothing else: serving and the plain tensor paths build
none.  ``train_mode``/``predict_mode`` set the flag that Gluon's
``Dropout`` reads.

``backward`` calls ``torch.autograd.grad`` over the variables (arrays
with ``attach_grad``, Gluon parameters) and writes each result into that
variable's own gradient buffer per its ``grad_req`` — 'write' overwrites,
'add' accumulates, 'null' has none — instead of letting torch accumulate
into ``.grad``.  A buffer is allocated at its variable's first backward
and keeps its address from then on, as a whole-tree optimizer kernel's
leaf table and a captured CUDA graph need."""
from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

from .base import MXNetError
from . import telemetry as _telemetry

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "mark_variables", "get_symbol", "Function"]

_state = threading.local()
# every live variable (NDArray with a grad_req other than 'null'), by id
_variables: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training


def set_recording(is_record: bool) -> bool:
    st = _st()
    prev, st.recording = st.recording, bool(is_record)
    return prev


def set_training(train: bool) -> bool:
    st = _st()
    prev, st.training = st.training, bool(train)
    return prev


class _RecordingStateScope:
    """Sets recording and/or training for a scope; a recording change
    also sets torch's grad mode, and both come back at the exit."""

    def __init__(self, is_record: Optional[bool],
                 train_mode: Optional[bool]):
        self._is_record = is_record
        self._train_mode = train_mode
        self._prev = []

    def __enter__(self):
        prev = [None, None, torch.is_grad_enabled()]
        if self._is_record is not None:
            prev[0] = set_recording(self._is_record)
            torch.set_grad_enabled(self._is_record)
        if self._train_mode is not None:
            prev[1] = set_training(self._train_mode)
        self._prev.append(prev)
        return self

    def __exit__(self, *exc):
        rec, train, grad_mode = self._prev.pop()
        if self._is_record is not None:
            set_recording(rec)
            torch.set_grad_enabled(grad_mode)
        if self._train_mode is not None:
            set_training(train)
        return False


def record(train_mode: bool = True):
    """Scope: record ops for autograd (and train mode by default)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def _register(var) -> None:
    _variables[id(var)] = var


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make ``variables`` graph leaves whose gradients go into
    ``gradients`` (NDArrays of the same shapes) per ``grad_reqs``."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v.attach_grad(req)
        if req != "null":
            v._grad = g


def _as_head_grad(h, g):
    from .ndarray.ndarray import NDArray
    if g is None:
        return torch.ones_like(h._data)
    if isinstance(g, NDArray):
        return g._data
    return torch.as_tensor(g, dtype=h._data.dtype, device=h._data.device)


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True, create_graph: bool = False,
             variables=None):
    """Differentiate ``heads`` (NDArrays on a recorded graph).  Without
    ``variables`` the gradients go into every reached variable's buffer
    per its ``grad_req`` and None is returned; with ``variables`` they
    are returned instead (``grad``)."""
    with _telemetry.trace_span("autograd.backward", cat="autograd"):
        return _backward(list(heads), head_grads, retain_graph,
                         create_graph, variables)


def _backward(heads, head_grads, retain_graph, create_graph, variables):
    from .ndarray.ndarray import NDArray
    if head_grads is None:
        head_grads = [None] * len(heads)
    pairs = [(h, _as_head_grad(h, g)) for h, g in zip(heads, head_grads)
             if h._data.requires_grad]
    if not pairs:
        raise MXNetError(
            "cannot differentiate: outputs are not on the recorded graph "
            "(did you forget autograd.record() / attach_grad()?)")
    if variables is None:
        leaves = [v for v in list(_variables.values())
                  if v._grad_req != "null" and v._data.requires_grad]
    else:
        leaves = list(variables)
    if not leaves:
        return None if variables is None else []
    try:
        gs = torch.autograd.grad(
            [h._data for h, _ in pairs], [v._data for v in leaves],
            grad_outputs=[g for _, g in pairs],
            retain_graph=retain_graph or create_graph,
            create_graph=create_graph, allow_unused=True)
    except RuntimeError as e:
        raise MXNetError(f"backward: {e}") from e
    if variables is not None:
        return [NDArray(g) if g is not None else
                NDArray(torch.zeros_like(v._data.detach()))
                for v, g in zip(leaves, gs)]
    with torch.no_grad():
        for v, g in zip(leaves, gs):
            if g is None:
                continue
            buf = v._grad
            if buf is None:
                v._grad = NDArray(g.detach().clone())
            elif v._grad_req == "add":
                buf._data.add_(g)
            else:
                buf._data.copy_(g)
    return None


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode: bool = True):
    """Gradients of ``heads`` with respect to ``variables``, returned
    without touching any gradient buffer.  With ``create_graph`` the
    results are themselves on the graph, so a second backward gives
    higher-order gradients."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    if isinstance(heads, NDArray):
        heads = [heads]
    if single:
        variables = [variables]
    if retain_graph is None:
        retain_graph = create_graph
    with _RecordingStateScope(True if create_graph else None, train_mode):
        gs = backward(heads, head_grads, retain_graph=retain_graph,
                      create_graph=create_graph, variables=variables)
    return gs[0] if single else gs


def get_symbol(x):
    raise MXNetError("get_symbol: graph-to-Symbol export is not ported "
                     "(symbol: ROADMAP Queue A item 17)")


class _Bridge(torch.autograd.Function):
    """A user :class:`Function` as one torch autograd node."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray.ndarray import NDArray
        ctx.fn = fn
        with pause():
            out = fn.forward(*[NDArray(t) for t in tensors])
        ctx.single = isinstance(out, NDArray)
        outs = [out] if ctx.single else list(out)
        return outs[0]._data if ctx.single else tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        with pause():
            gs = ctx.fn.backward(*[NDArray(g) for g in grads])
        if isinstance(gs, NDArray):
            gs = (gs,)
        return (None,) + tuple(g._data for g in gs)


class Function:
    """A custom differentiable function: subclass and define ``forward``
    and ``backward`` over NDArrays (both run outside recording)."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *out_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if is_recording() and any(isinstance(i, NDArray)
                                  and i._data.requires_grad
                                  for i in inputs):
            out = _Bridge.apply(self, *[i._data for i in inputs])
            if isinstance(out, tuple):
                return [NDArray(o) for o in out]
            return NDArray(out)
        with pause():
            return self.forward(*inputs)
