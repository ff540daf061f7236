"""The NDArray ops of the PyTorch port (counterpart of
``incubator_mxnet_tpu/ndarray/ops.py``): the subset that the Gluon layers,
the losses and the slice's tests call.  Each op is one :func:`_invoke` of a
torch expression, with the reference's conventions: comparisons return
floats, ``argmax`` returns float indices, ``pick``/``take`` clip their
indices, ``one_hot`` is not differentiable.  The rest of the op corpus is
ROADMAP Queue A item 15."""
from __future__ import annotations

import builtins

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .ndarray import NDArray, _invoke, array as _array, torch_dtype

__all__: list = []      # filled at the bottom


def _nd(x, ref: NDArray = None) -> NDArray:
    if isinstance(x, NDArray):
        return x
    return _array(_np.asarray(x), ctx=None if ref is None else ref.context)


# ---------------------------------------------------------------------------
# elementwise binary
# ---------------------------------------------------------------------------
def _binary(name, fn, differentiable=True):
    def op(lhs, rhs):
        if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
            return _invoke(fn, [lhs, rhs], name=name,
                           differentiable=differentiable)
        if isinstance(lhs, NDArray):
            return _invoke(lambda x: fn(x, rhs), [lhs], name=name,
                           differentiable=differentiable)
        if isinstance(rhs, NDArray):
            return _invoke(lambda y: fn(lhs, y), [rhs], name=name,
                           differentiable=differentiable)
        raise TypeError(f"{name}: at least one NDArray operand required")
    op.__name__ = name
    return op


def _cmp(fn):
    """The reference's comparisons return the lhs's float dtype (float32
    for integer operands), not bools."""
    def f(a, b):
        ref = a if isinstance(a, torch.Tensor) else b
        out_dt = ref.dtype if ref.is_floating_point() else torch.float32
        return fn(a, b).to(out_dt)
    return f


def _pair(a, b):
    """Both operands as tensors (a scalar on the other's device)."""
    ref = a if isinstance(a, torch.Tensor) else b
    return tuple(x if isinstance(x, torch.Tensor)
                 else torch.as_tensor(x, device=ref.device) for x in (a, b))


add = _binary("add", lambda a, b: a + b)
subtract = _binary("subtract", lambda a, b: a - b)
multiply = _binary("multiply", lambda a, b: a * b)
divide = _binary("divide", lambda a, b: a / b)
floor_divide = _binary("floor_divide", lambda a, b: a // b,
                       differentiable=False)
mod = _binary("mod", lambda a, b: a % b)
power = _binary("power", lambda a, b: a ** b)
maximum = _binary("maximum", lambda a, b: torch.maximum(*_pair(a, b)))
minimum = _binary("minimum", lambda a, b: torch.minimum(*_pair(a, b)))
equal = _binary("equal", _cmp(lambda a, b: a == b), differentiable=False)
not_equal = _binary("not_equal", _cmp(lambda a, b: a != b),
                    differentiable=False)
greater = _binary("greater", _cmp(lambda a, b: a > b), differentiable=False)
greater_equal = _binary("greater_equal", _cmp(lambda a, b: a >= b),
                        differentiable=False)
lesser = _binary("lesser", _cmp(lambda a, b: a < b), differentiable=False)
lesser_equal = _binary("lesser_equal", _cmp(lambda a, b: a <= b),
                       differentiable=False)
logical_and = _binary("logical_and",
                      _cmp(lambda a, b: (a != 0) & (b != 0)),
                      differentiable=False)
logical_or = _binary("logical_or", _cmp(lambda a, b: (a != 0) | (b != 0)),
                     differentiable=False)
logical_xor = _binary("logical_xor",
                      _cmp(lambda a, b: (a != 0) ^ (b != 0)),
                      differentiable=False)

broadcast_add = broadcast_plus = elemwise_add = add
broadcast_sub = broadcast_minus = elemwise_sub = subtract
broadcast_mul = elemwise_mul = multiply
broadcast_div = elemwise_div = divide
broadcast_mod = mod
broadcast_power = power
broadcast_maximum = maximum
broadcast_minimum = minimum
broadcast_equal = equal
broadcast_not_equal = not_equal
broadcast_greater = greater
broadcast_greater_equal = greater_equal
broadcast_lesser = lesser
broadcast_lesser_equal = lesser_equal
broadcast_logical_and = logical_and
broadcast_logical_or = logical_or
broadcast_logical_xor = logical_xor


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------
def _unary(name, fn, differentiable=True):
    def op(data):
        return _invoke(fn, [_nd(data)], name=name,
                       differentiable=differentiable)
    op.__name__ = name
    return op


abs = _unary("abs", torch.abs)
sign = _unary("sign", torch.sign)
negative = _unary("negative", torch.neg)
reciprocal = _unary("reciprocal", lambda x: 1.0 / x)
square = _unary("square", lambda x: x * x)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", lambda x: 1.0 / torch.sqrt(x))
exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log10 = _unary("log10", torch.log10)
log2 = _unary("log2", torch.log2)
log1p = _unary("log1p", torch.log1p)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
arcsin = _unary("arcsin", torch.asin)
arccos = _unary("arccos", torch.acos)
arctan = _unary("arctan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
trunc = fix = _unary("trunc", torch.trunc)
round = _unary("round", torch.round)
rint = _unary("rint", torch.round)
erf = _unary("erf", torch.erf)
logical_not = _unary("logical_not", lambda x: (x == 0).float(),
                     differentiable=False)
isnan = _unary("isnan", torch.isnan, differentiable=False)
isinf = _unary("isinf", torch.isinf, differentiable=False)
isfinite = _unary("isfinite", torch.isfinite, differentiable=False)
relu = _unary("relu", torch.relu)
sigmoid = _unary("sigmoid", torch.sigmoid)
softsign = _unary("softsign", F.softsign)
softrelu = softplus = _unary("softrelu", F.softplus)


def identity(data):
    return _invoke(lambda x: x, [_nd(data)], name="identity")


copy = identity


def stop_gradient(data):
    return _invoke(lambda x: x.detach(), [_nd(data)], name="stop_gradient",
                   differentiable=False)


BlockGrad = stop_gradient


def cast(data, dtype):
    dt = torch_dtype(dtype)
    return _invoke(lambda x: x.to(dt), [_nd(data)], name="cast")


Cast = cast


def zeros_like(data):
    return _invoke(torch.zeros_like, [_nd(data)], name="zeros_like",
                   differentiable=False)


def ones_like(data):
    return _invoke(torch.ones_like, [_nd(data)], name="ones_like",
                   differentiable=False)


def full_like(data, fill_value):
    return _invoke(lambda x: torch.full_like(x, fill_value), [_nd(data)],
                   name="full_like", differentiable=False)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def gelu(data, approximate=False):
    mode = "tanh" if approximate else "none"
    return _invoke(lambda x: F.gelu(x, approximate=mode), [_nd(data)],
                   name="gelu")


def leaky_relu(data, act_type="leaky", slope=0.25, gamma=None, **kw):
    d = _nd(data)
    if act_type == "leaky":
        return _invoke(lambda x: torch.where(x > 0, x, slope * x), [d],
                       name="leaky_relu")
    if act_type == "elu":
        return _invoke(lambda x: torch.where(x > 0, x,
                                             slope * torch.expm1(x)),
                       [d], name="elu")
    if act_type == "selu":
        return _invoke(F.selu, [d], name="selu")
    if act_type == "gelu":
        return gelu(d)
    if act_type == "prelu":
        return _invoke(lambda x, g: torch.where(x > 0, x, g * x),
                       [d, _nd(gamma, d)], name="prelu")
    raise MXNetError(f"LeakyReLU: unknown act_type {act_type}")


LeakyReLU = leaky_relu

# act_type -> torch function (MXNet's Activation op; also Dense's
# ``activation`` and gluon.nn.Activation)
ACTIVATIONS = {
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "softrelu": F.softplus, "softsign": F.softsign,
    "log_sigmoid": F.logsigmoid,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
}


def Activation(data, act_type="relu"):
    if act_type not in ACTIVATIONS:
        raise MXNetError(f"Activation: unknown act_type {act_type}")
    return _invoke(ACTIVATIONS[act_type], [_nd(data)], name=act_type)


def softmax(data, axis=-1, temperature=None, length=None):
    d = _nd(data)
    if length is not None:
        def fn(x, lv):
            t = x / temperature if temperature else x
            shp = [1] * x.dim()
            shp[axis] = x.shape[axis]
            idx = torch.arange(x.shape[axis], device=x.device).reshape(shp)
            mask = idx < lv.unsqueeze(axis)
            t = t.masked_fill(~mask, float("-inf"))
            return torch.softmax(t, dim=axis).masked_fill(~mask, 0.0)
        return _invoke(fn, [d, _nd(length, d)], name="softmax")
    return _invoke(lambda x: torch.softmax(
        x / temperature if temperature else x, dim=axis), [d],
        name="softmax")


def log_softmax(data, axis=-1, temperature=None):
    return _invoke(lambda x: torch.log_softmax(
        x / temperature if temperature else x, dim=axis), [_nd(data)],
        name="log_softmax")


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(a % ndim for a in axis)
    return (int(axis) % ndim,)


def _reduce(name, fn, int_keep=False, differentiable=True):
    def op(data, axis=None, keepdims=False, **kw):
        d = _nd(data)

        def run(x):
            ax = _axes(axis, x.dim())
            if not x.dim():
                return fn(x, (), False)
            out = fn(x, ax, keepdims)
            if int_keep and not x.is_floating_point():
                out = out.to(x.dtype)
            return out
        return _invoke(run, [d], name=name, differentiable=differentiable)
    op.__name__ = name
    return op


def _prod(x, ax, keep):
    for a in sorted(ax, reverse=True):
        x = x.prod(dim=a, keepdim=keep)
    return x


def _mean(x, ax, keep):
    if not x.is_floating_point():
        x = x.float()
    return x.mean(dim=ax, keepdim=keep) if ax else x


sum = _reduce("sum", lambda x, ax, k: x.sum(dim=ax, keepdim=k) if ax else x,
              int_keep=True)
nansum = _reduce("nansum", lambda x, ax, k: x.nansum(dim=ax, keepdim=k)
                 if ax else x, int_keep=True)
mean = _reduce("mean", _mean)
prod = _reduce("prod", _prod, int_keep=True)
max = _reduce("max", lambda x, ax, k: x.amax(dim=ax, keepdim=k)
              if ax else x)
min = _reduce("min", lambda x, ax, k: x.amin(dim=ax, keepdim=k)
              if ax else x)
sum_axis = sum
max_axis = max
min_axis = min


def _arg(name, fn):
    def op(data, axis=None, keepdims=False):
        def run(x):
            if axis is None:
                return fn(x.reshape(-1), 0).float()
            r = fn(x, axis)
            return (r.unsqueeze(axis) if keepdims else r).float()
        return _invoke(run, [_nd(data)], name=name, differentiable=False)
    op.__name__ = name
    return op


argmax = _arg("argmax", lambda x, a: torch.argmax(x, dim=a))
argmin = _arg("argmin", lambda x, a: torch.argmin(x, dim=a))


def norm(data, ord=2, axis=None, keepdims=False):
    def fn(x):
        ax = _axes(axis, x.dim())
        if ord == 1:
            return x.abs().sum(dim=ax, keepdim=keepdims)
        return torch.sqrt((x * x).sum(dim=ax, keepdim=keepdims))
    return _invoke(fn, [_nd(data)], name="norm")


# ---------------------------------------------------------------------------
# linear algebra
# ---------------------------------------------------------------------------
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Contract lhs's last axis with rhs's first (after the optional
    transposes), as the reference's ``dot``."""
    def fn(a, b):
        if transpose_a and a.dim() > 1:
            a = torch.movedim(a, 0, -1)
        if transpose_b and b.dim() > 1:
            b = torch.movedim(b, -1, 0)
        return torch.tensordot(a, b, dims=1)
    return _invoke(fn, [_nd(lhs), _nd(rhs)], name="dot")


def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    def fn(a, b):
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return _invoke(fn, [_nd(lhs), _nd(rhs)], name="batch_dot")


def matmul(lhs, rhs):
    return _invoke(torch.matmul, [_nd(lhs), _nd(rhs)], name="matmul")


def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    ins = [_nd(data), _nd(weight)] + ([] if bias is None or no_bias
                                      else [_nd(bias)])

    def fn(x, w, b=None):
        if flatten:
            x = x.reshape(x.shape[0], -1)
        return F.linear(x, w, b)
    return _invoke(fn, ins, name="FullyConnected")


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------
def reshape(data, shape=None, reverse=False, **kw):
    d = _nd(data)
    if not reverse:
        return d.reshape(shape)
    spec = list(shape)
    if -4 in spec:
        raise MXNetError("reshape: reverse=True with -4 is not supported")
    from .ndarray import _expand_reshape
    return d.reshape(_expand_reshape(d.shape[::-1], spec[::-1])[::-1])


def reshape_like(data, other):
    return _nd(data).reshape(_nd(other).shape)


def flatten(data):
    return _nd(data).flatten()


Flatten = flatten


def transpose(data, axes=None):
    def fn(x):
        return x.permute(*axes) if axes else x.permute(
            *range(x.dim() - 1, -1, -1))
    return _invoke(fn, [_nd(data)], name="transpose")


def swapaxes(data, dim1=0, dim2=0):
    return _invoke(lambda x: x.transpose(dim1, dim2), [_nd(data)],
                   name="swapaxes")


SwapAxis = swapaxes


def expand_dims(data, axis):
    return _invoke(lambda x: x.unsqueeze(axis), [_nd(data)],
                   name="expand_dims")


def squeeze(data, axis=None):
    def fn(x):
        if axis is None:
            return x.squeeze()
        ax = axis if isinstance(axis, (list, tuple)) else (axis,)
        return x.squeeze(tuple(ax))
    return _invoke(fn, [_nd(data)], name="squeeze")


def broadcast_to(data, shape):
    d = _nd(data)
    # 0 in the target shape keeps the source's dim, as the reference
    tgt = tuple(s if s != 0 else d.shape[i] for i, s in enumerate(shape))
    return _invoke(lambda x: x.expand(tgt), [d], name="broadcast_to")


def broadcast_axis(data, axis=None, size=None):
    d = _nd(data)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    sizes = size if isinstance(size, (list, tuple)) else [size]
    tgt = list(d.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return broadcast_to(d, tgt)


broadcast_axes = broadcast_axis


def broadcast_like(lhs, rhs):
    return broadcast_to(lhs, _nd(rhs).shape)


def _seq(data):
    return [_nd(d) for d in (data[0] if len(data) == 1 and
                             isinstance(data[0], (list, tuple)) else data)]


def concat(*data, dim=1):
    return _invoke(lambda *xs: torch.cat(xs, dim=dim), _seq(data),
                   name="concat")


Concat = concat


def stack(*data, axis=0):
    return _invoke(lambda *xs: torch.stack(xs, dim=axis), _seq(data),
                   name="stack")


def split(data, num_outputs, axis=1, squeeze_axis=False):
    d = _nd(data)
    if d.shape[axis] % num_outputs:
        raise MXNetError(f"split: axis {axis} of size {d.shape[axis]} is "
                         f"not divisible into {num_outputs} parts")

    def fn(x):
        parts = torch.split(x, x.shape[axis] // num_outputs, dim=axis)
        if squeeze_axis:
            parts = [p.squeeze(axis) for p in parts]
        return tuple(parts)
    out = _invoke(fn, [d], name="split")
    return out if num_outputs > 1 else out[0]


SliceChannel = split


def slice(data, begin, end, step=None):
    begin = tuple(begin) if isinstance(begin, (list, tuple)) else (begin,)
    end = tuple(end) if isinstance(end, (list, tuple)) else (end,)
    step = tuple(step) if step else (None,) * len(begin)
    key = tuple(builtins.slice(b, e, s) for b, e, s in zip(begin, end, step))
    return _invoke(lambda x: x[key], [_nd(data)], name="slice")


def slice_axis(data, axis, begin, end):
    d = _nd(data)
    key = [builtins.slice(None)] * d.ndim
    key[axis] = builtins.slice(begin, d.shape[axis] if end is None else end)
    key = tuple(key)
    return _invoke(lambda x: x[key], [d], name="slice_axis")


def slice_like(data, shape_like, axes=None):
    d, s = _nd(data), _nd(shape_like)
    key = [builtins.slice(None)] * d.ndim
    for a in (axes if axes is not None else range(d.ndim)):
        key[a] = builtins.slice(0, s.shape[a])
    key = tuple(key)
    return _invoke(lambda x: x[key], [d], name="slice_like")


def tile(data, reps):
    return _invoke(lambda x: x.tile(tuple(reps)), [_nd(data)], name="tile")


def repeat(data, repeats, axis=None):
    def fn(x):
        if axis is None:
            return x.reshape(-1).repeat_interleave(repeats)
        return x.repeat_interleave(repeats, dim=axis)
    return _invoke(fn, [_nd(data)], name="repeat")


def flip(data, axis):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return _invoke(lambda x: x.flip(ax), [_nd(data)], name="flip")


reverse = flip


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------
def take(a, indices, axis=0, mode="clip"):
    if mode not in ("clip", "wrap"):
        raise MXNetError(f"take: mode {mode!r} is not ported")
    d = _nd(a)

    def fn(x, i):
        i = i.long()
        n = x.shape[axis]
        i = i.clamp(0, n - 1) if mode == "clip" else i % n
        out = x.index_select(axis, i.reshape(-1))
        return out.reshape(x.shape[:axis] + i.shape + x.shape[axis + 1:])
    return _invoke(fn, [d, _nd(indices, d)], name="take")


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    d = _nd(data)

    def fn(x, i):
        i = i.long().clamp(0, x.shape[axis] - 1)
        out = torch.gather(x, axis, i.unsqueeze(axis))
        return out if keepdims else out.squeeze(axis)
    return _invoke(fn, [d, _nd(index, d)], name="pick")


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    dt = torch_dtype(dtype)

    def fn(i):
        oh = F.one_hot(i.long(), depth).to(torch.float32)
        return (oh * (on_value - off_value) + off_value).to(dt)
    return _invoke(fn, [_nd(indices)], name="one_hot", differentiable=False)


def where(condition, x, y):
    c = _nd(condition)
    return _invoke(lambda cc, a, b: torch.where(cc != 0, a, b),
                   [c, _nd(x, c), _nd(y, c)], name="where")


def clip(data, a_min=None, a_max=None):
    return _invoke(lambda x: torch.clamp(x, a_min, a_max), [_nd(data)],
                   name="clip")


def Embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    if sparse_grad:
        raise MXNetError("Embedding(sparse_grad=True) is not ported "
                         "(sparse arrays: ROADMAP Queue A item 15)")
    return _invoke(lambda i, w: F.embedding(i.long(), w),
                   [_nd(data), _nd(weight)], name="Embedding")


embedding = Embedding


def add_n(*args):
    def fn(*xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out
    return _invoke(fn, _seq(args), name="add_n")


ElementWiseSum = add_n


def dropout(data, p=0.5, mode="training", axes=None):
    """Dropout drawn from the context's generator (``..random``)."""
    from .. import random as _random
    d = _nd(data)
    if p <= 0 or mode != "training":
        return identity(d)
    gen = _random.generator(d.context)

    def fn(x):
        shape = x.shape if axes is None else tuple(
            x.shape[i] if i in axes else 1 for i in range(x.dim()))
        keep = torch.rand(shape, generator=gen, device=x.device) >= p
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    return _invoke(fn, [d], name="dropout")


Dropout = dropout


def make_loss(data):
    return identity(data)


__all__ = [n for n in dir() if not n.startswith("_") and n not in
           ("annotations", "builtins", "F", "torch", "NDArray",
            "MXNetError", "torch_dtype")]
