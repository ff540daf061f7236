"""NDArray: the imperative tensor of the PyTorch port (counterpart of
``incubator_mxnet_tpu/ndarray/ndarray.py``).

An :class:`NDArray` holds one ``torch.Tensor`` (``_data``) on the device of
its context.  Every op goes through the single funnel :func:`_invoke`
(the reference's ``Imperative::Invoke``): it runs the op with torch's grad
mode set to :func:`..autograd.is_recording`, so an op inside
``autograd.record()`` lands on torch's autograd graph and one outside it
builds no graph at all.  There is no second tape: ``autograd.backward``
is ``torch.autograd.grad`` over the graph torch recorded.

Writes are in place where the array owns its storage (``a[:] = b``,
``a += b`` on a variable or a parameter), so a parameter's NDArray, its
module's ``nn.Parameter`` and the optimizer's kernels keep one buffer.
A write to an array that an op of a recorded graph produced replaces its
tensor instead, as the reference's functional replacement does, so the
graph keeps the value it saved."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as _np
import torch

from ..base import MXNetError
from ..context import Context, as_context

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "full", "arange",
           "eye", "linspace", "concatenate", "waitall"]

_autograd = None


def _ag():
    global _autograd
    if _autograd is None:
        from .. import autograd as m
        _autograd = m
    return _autograd


_NP2TORCH = {
    _np.dtype(_np.float32): torch.float32,
    _np.dtype(_np.float64): torch.float64,
    _np.dtype(_np.float16): torch.float16,
    _np.dtype(_np.uint8): torch.uint8,
    _np.dtype(_np.int8): torch.int8,
    _np.dtype(_np.int16): torch.int16,
    _np.dtype(_np.int32): torch.int32,
    _np.dtype(_np.int64): torch.int64,
    _np.dtype(_np.bool_): torch.bool,
}
_TORCH2NP = {v: k for k, v in _NP2TORCH.items()}


def torch_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype for a numpy dtype, its name, a Python type or a torch
    dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    try:
        return _NP2TORCH[_np.dtype(dtype)]
    except (KeyError, TypeError):
        raise MXNetError(f"unsupported dtype {dtype!r}")


def numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype (bfloat16, which numpy lacks,
    stays the torch dtype)."""
    return _TORCH2NP.get(dtype, dtype)


class NDArray:
    """An n-dimensional array on a device context, with autograd support.
    Wraps a ``torch.Tensor``; the API models the reference's NDArray."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    # let our dunders win over numpy's when mixed with numpy operands
    __array_priority__ = 1000.0

    def __init__(self, data: torch.Tensor):
        self._data = data
        self._grad: Optional[NDArray] = None
        self._grad_req = "null"

    # -- properties -----------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return Context(self._data.device)

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def grad(self) -> Optional["NDArray"]:
        """The gradient buffer of a variable (allocated at its first
        backward, or here as zeros); None without ``attach_grad``."""
        if self._grad is None and self._grad_req != "null":
            self._grad = NDArray(torch.zeros_like(self._data,
                                                  requires_grad=False))
        return self._grad

    @property
    def grad_req(self) -> str:
        return self._grad_req

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    # -- host side ------------------------------------------------------
    def asnumpy(self) -> _np.ndarray:
        """Copy to a host numpy array (waits for the device)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out = t.cpu().numpy()
        return out.copy() if t.device.type == "cpu" else out

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    item = asscalar

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self

    wait_to_write = wait_to_read

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def tolist(self):
        return self.asnumpy().tolist()

    def __reduce__(self):
        return (_rebuild, (self.asnumpy(), str(self._data.device)))

    def __deepcopy__(self, memo):
        """A copy over the deep copy of the tensor (shared through
        ``memo``: a copied block's parameter NDArray wraps the copied
        module's tensor), still a variable if this one is."""
        import copy
        out = NDArray(copy.deepcopy(self._data, memo))
        if self._grad_req != "null":
            out.attach_grad(self._grad_req)
        return out

    # -- copies ---------------------------------------------------------
    def astype(self, dtype, copy: bool = True) -> "NDArray":
        dt = torch_dtype(dtype)
        if dt == self._data.dtype:
            return self.copy() if copy else self
        return _invoke(lambda x: x.to(dt), [self], name="cast")

    def copy(self) -> "NDArray":
        return _invoke(lambda x: x.clone(), [self], name="copy")

    def copyto(self, other) -> "NDArray":
        """Copy to a context (a new array) or into another NDArray (in
        place, cutting the target's graph history)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError(f"copyto shape mismatch {self.shape} vs "
                                 f"{other.shape}")
            other._write(lambda t: t.copy_(self._data.detach()))
            return other
        dev = as_context(other).device
        return NDArray(self._data.detach().to(dev, copy=True))

    def as_in_context(self, ctx) -> "NDArray":
        if as_context(ctx).device == self._data.device:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    # -- autograd -------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Mark this array as a variable with a gradient buffer (written
        per ``grad_req``: 'write' overwrites, 'add' accumulates, 'null'
        keeps none).  A variable is a fresh graph leaf."""
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        if stype not in (None, "default"):
            raise MXNetError(f"gradient storage {stype!r} is not ported "
                             "(sparse arrays: ROADMAP Queue A item 15)")
        self._grad_req = grad_req
        self._grad = None
        t = self._data
        if grad_req == "null":      # a buffer that no backward writes
            self._grad = NDArray(torch.zeros_like(t, requires_grad=False))
            return
        if not (t.is_floating_point() or t.is_complex()):
            raise MXNetError(f"attach_grad needs a floating-point array, "
                             f"got {self.dtype}")
        if not (t.is_leaf and t.requires_grad):
            self._data = t.detach().requires_grad_(True)
        _ag()._register(self)

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph: bool = False,
                 train_mode: bool = True):
        """Reverse-mode autodiff from this array into the gradient buffers
        of the variables it depends on."""
        _ag().backward([self], None if out_grad is None else [out_grad],
                       retain_graph=retain_graph, train_mode=train_mode)

    def zero_grad(self):
        if self._grad is not None:
            self._grad._data.zero_()

    def _write(self, fn):
        """Apply the in-place ``fn`` to this array's tensor outside any
        graph.  A tensor an op of a recorded graph produced is copied
        first, so the graph keeps the value it saved."""
        t = self._data
        with torch.no_grad():
            if t.grad_fn is not None:
                t = t.detach().clone()
            fn(t)
        self._data = t

    # -- shape ----------------------------------------------------------
    def reshape(self, *shape, **kwargs) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape") is not None:
            shape = tuple(kwargs["shape"])
        new_shape = _expand_reshape(self.shape, shape)
        return _invoke(lambda x: x.reshape(new_shape), [self],
                       name="reshape")

    def reshape_like(self, other: "NDArray") -> "NDArray":
        return self.reshape(other.shape)

    def flatten(self) -> "NDArray":
        n = self.shape[0] if self.ndim else 1
        return self.reshape(n, -1)

    def transpose(self, *axes) -> "NDArray":
        from . import ops
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return ops.transpose(self, axes=axes if axes else None)

    def _method(opname):  # noqa: N805 - builds methods at class creation
        def f(self, *a, **kw):
            from . import ops
            return getattr(ops, opname)(self, *a, **kw)
        f.__name__ = opname
        return f

    swapaxes = _method("swapaxes")
    expand_dims = _method("expand_dims")
    squeeze = _method("squeeze")
    broadcast_to = _method("broadcast_to")
    broadcast_like = _method("broadcast_like")
    slice = _method("slice")
    slice_axis = _method("slice_axis")
    take = _method("take")
    pick = _method("pick")
    tile = _method("tile")
    repeat = _method("repeat")
    flip = _method("flip")
    split = _method("split")
    sum = _method("sum")
    nansum = _method("nansum")
    mean = _method("mean")
    max = _method("max")
    min = _method("min")
    prod = _method("prod")
    argmax = _method("argmax")
    argmin = _method("argmin")
    clip = _method("clip")
    abs = _method("abs")
    sign = _method("sign")
    exp = _method("exp")
    expm1 = _method("expm1")
    log = _method("log")
    log1p = _method("log1p")
    log2 = _method("log2")
    log10 = _method("log10")
    sqrt = _method("sqrt")
    rsqrt = _method("rsqrt")
    square = _method("square")
    reciprocal = _method("reciprocal")
    sin = _method("sin")
    cos = _method("cos")
    tanh = _method("tanh")
    relu = _method("relu")
    sigmoid = _method("sigmoid")
    softmax = _method("softmax")
    log_softmax = _method("log_softmax")
    round = _method("round")
    floor = _method("floor")
    ceil = _method("ceil")
    norm = _method("norm")
    one_hot = _method("one_hot")
    dot = _method("dot")
    zeros_like = _method("zeros_like")
    ones_like = _method("ones_like")

    del _method

    # -- operators ------------------------------------------------------
    def _binop(self, other, opname, reverse=False):
        from . import ops
        fn = getattr(ops, opname)
        return fn(other, self) if reverse else fn(self, other)

    def __add__(self, o): return self._binop(o, "add")
    def __radd__(self, o): return self._binop(o, "add", True)
    def __sub__(self, o): return self._binop(o, "subtract")
    def __rsub__(self, o): return self._binop(o, "subtract", True)
    def __mul__(self, o): return self._binop(o, "multiply")
    def __rmul__(self, o): return self._binop(o, "multiply", True)
    def __truediv__(self, o): return self._binop(o, "divide")
    def __rtruediv__(self, o): return self._binop(o, "divide", True)
    def __floordiv__(self, o): return self._binop(o, "floor_divide")
    def __rfloordiv__(self, o): return self._binop(o, "floor_divide", True)
    def __mod__(self, o): return self._binop(o, "mod")
    def __rmod__(self, o): return self._binop(o, "mod", True)
    def __pow__(self, o): return self._binop(o, "power")
    def __rpow__(self, o): return self._binop(o, "power", True)
    def __matmul__(self, o): return self._binop(o, "matmul")
    def __rmatmul__(self, o): return self._binop(o, "matmul", True)

    def __neg__(self):
        return self._binop(-1, "multiply")

    def __abs__(self):
        from . import ops
        return ops.abs(self)

    def __eq__(self, o): return self._binop(o, "equal")
    def __ne__(self, o): return self._binop(o, "not_equal")
    def __gt__(self, o): return self._binop(o, "greater")
    def __ge__(self, o): return self._binop(o, "greater_equal")
    def __lt__(self, o): return self._binop(o, "lesser")
    def __le__(self, o): return self._binop(o, "lesser_equal")

    __hash__ = None     # a mutable container, as the reference's

    def _iop(self, other, opname):
        res = self._binop(other, opname)
        dt = self._data.dtype
        if res._data.requires_grad:
            # on a recorded graph: the result's history replaces ours
            self._data = res._data.to(dt)
        else:
            self._write(lambda t: t.copy_(res._data))
        return self

    def __iadd__(self, o): return self._iop(o, "add")
    def __isub__(self, o): return self._iop(o, "subtract")
    def __imul__(self, o): return self._iop(o, "multiply")
    def __itruediv__(self, o): return self._iop(o, "divide")
    def __imod__(self, o): return self._iop(o, "mod")

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- indexing -------------------------------------------------------
    @staticmethod
    def _key(key):
        def one(k):
            if isinstance(k, NDArray):
                k = k._data
            if isinstance(k, torch.Tensor) and not k.is_floating_point() \
                    and k.dtype != torch.bool:
                k = k.long()
            return k
        if isinstance(key, tuple):
            return tuple(one(k) for k in key)
        return one(key)

    def __getitem__(self, key):
        key = self._key(key)
        return _invoke(lambda x: x[key], [self], name="getitem")

    def __setitem__(self, key, value):
        """In-place write outside any graph (the reference's slice
        assign); cuts this array's graph history."""
        key = self._key(key)
        src = value._data.detach() if isinstance(value, NDArray) \
            else value

        def write(t):
            t[key] = torch.as_tensor(src, dtype=t.dtype, device=t.device)
        self._write(write)

    def __repr__(self):
        return (f"\n{self.asnumpy()!r}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")


def _rebuild(data, device):
    return NDArray(torch.from_numpy(_np.array(data)).to(device))


# ---------------------------------------------------------------------------
# MXNet's reshape codes 0, -1, -2, -3, -4
# ---------------------------------------------------------------------------
def _expand_reshape(old: Sequence[int], new: Sequence[int]):
    out = []
    i = 0
    j = 0
    new = list(new)
    while j < len(new):
        d = new[j]
        if d == 0:           # copy this dim
            out.append(old[i])
            i += 1
        elif d == -2:        # copy all remaining dims
            out.extend(old[i:])
            i = len(old)
        elif d == -3:        # merge two consecutive dims
            out.append(old[i] * old[i + 1])
            i += 2
        elif d == -4:        # split one dim into the next two new dims
            a, b = new[j + 1], new[j + 2]
            if a == -1:
                a = old[i] // b
            if b == -1:
                b = old[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        elif d == -1:
            out.append(-1)
            i += 1
        else:
            out.append(d)
            i += 1
        j += 1
    return tuple(out)


# ---------------------------------------------------------------------------
# _invoke: the op funnel
# ---------------------------------------------------------------------------
def _invoke(fun: Callable, inputs: Sequence[NDArray], *, name: str = "op",
            differentiable: bool = True):
    """Run ``fun(*tensors)`` (a tensor or a tuple of tensors) with torch's
    grad mode on exactly while recording; wrap the result(s) as
    NDArray(s) (a list for a tuple)."""
    tensors = [i._data for i in inputs]
    grad = differentiable and _ag().is_recording()
    try:
        with torch.set_grad_enabled(grad):
            out = fun(*tensors)
    except MXNetError:
        raise
    except (RuntimeError, ValueError, IndexError, TypeError) as e:
        raise MXNetError(f"{name}: {e}") from e
    if isinstance(out, (tuple, list)):
        return [NDArray(o) for o in out]
    return NDArray(out)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def _device(ctx) -> torch.device:
    return as_context(ctx).device


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source, ctx=None, dtype=None) -> NDArray:
    """An array from Python or numpy data (or a tensor or NDArray).  As
    the reference: non-array sources default to float32, numpy sources
    keep their dtype but 64-bit narrows to 32."""
    if isinstance(source, NDArray):
        src = source._data.detach()
    elif isinstance(source, torch.Tensor):
        src = source.detach()
    elif isinstance(source, _np.ndarray):
        src = source
        if dtype is None:
            dtype = {_np.dtype(_np.float64): _np.float32,
                     _np.dtype(_np.int64): _np.int32,
                     _np.dtype(_np.uint64): _np.uint32}.get(src.dtype,
                                                            src.dtype)
    else:
        src = _np.asarray(source)
        if dtype is None:
            dtype = _np.float32 if src.dtype.kind in "fiu" else src.dtype
    dev = _device(ctx)
    dt = torch_dtype(dtype)
    if isinstance(src, _np.ndarray):
        t = torch.from_numpy(_np.ascontiguousarray(src))
        return NDArray(t.to(device=dev, dtype=dt or t.dtype, copy=True))
    return NDArray(src.to(device=dev, dtype=dt or src.dtype, copy=True))


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=None) -> NDArray:
    return NDArray(torch.zeros(_shape(shape),
                               dtype=torch_dtype(dtype) or torch.float32,
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None) -> NDArray:
    return NDArray(torch.ones(_shape(shape),
                              dtype=torch_dtype(dtype) or torch.float32,
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None) -> NDArray:
    return NDArray(torch.full(_shape(shape), val,
                              dtype=torch_dtype(dtype) or torch.float32,
                              device=_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    if stop is None:
        start, stop = 0, start
    a = torch.arange(start, stop, step,
                     dtype=torch_dtype(dtype) or torch.float32,
                     device=_device(ctx))
    if repeat != 1:
        a = a.repeat_interleave(repeat)
    return NDArray(a)


def eye(N, M=0, k=0, ctx=None, dtype=None) -> NDArray:
    a = _np.eye(N, M if M else N, k=k, dtype=_np.float32)
    return array(a, ctx=ctx, dtype=dtype or _np.float32)


def linspace(start, stop, num, endpoint=True, ctx=None,
             dtype=None) -> NDArray:
    a = _np.linspace(start, stop, num, endpoint=endpoint)
    return array(a, ctx=ctx, dtype=dtype or _np.float32)


def concatenate(arrays, axis=0):
    from . import ops
    return ops.concat(*arrays, dim=axis)


def waitall():
    """Wait until all queued device work is done."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
