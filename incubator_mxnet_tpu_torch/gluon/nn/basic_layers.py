"""Basic layers with MXNet's parameter shapes and names (counterpart of
``incubator_mxnet_tpu/gluon/nn/basic_layers.py``): ``Sequential``,
``HybridSequential``, ``Dense``, ``LayerNorm``, ``Embedding``,
``Dropout``, ``Flatten``, ``Identity``, ``Lambda``, ``HybridLambda``.

Each layer is a :class:`..block.HybridBlock` whose ``forward`` is torch
code over tensors, and each creates its parameters on ``device``
(default: the current context, ``cuda:0`` outside ``with mx.cpu():``).
A layer's input width is given at construction (``in_units``,
``in_channels``): deferred shape inference is not ported."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ndarray import ops as _ops
from ...ndarray.ndarray import torch_dtype
from .. import block as _block
from ..block import Block, HybridBlock, mx_named_parameters

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential",
           "Dense", "LayerNorm", "Embedding", "Dropout", "Flatten",
           "Identity", "Lambda", "HybridLambda", "gelu",
           "mx_named_parameters"]


def _param(shape, device, init=None):
    """A zero ``nn.Parameter`` of ``shape`` on ``device`` carrying its own
    initializer (``mx_init``) when ``init`` is given."""
    p = nn.Parameter(torch.zeros(*shape, device=resolve_device(device)))
    if init is not None:
        from ... import initializer as _init
        p.mx_init = _init.create(init)
    return p


class _SequentialMixin:
    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
            if isinstance(x, (tuple, list)):
                args = tuple(x[1:])
                x = x[0]
        return (x,) + args if args else x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_SequentialMixin, Block):
    """Blocks run in order."""

    def hybridize(self, active=True, **kwargs):
        for child in self._children_blocks():
            child.hybridize(active, **kwargs)


class HybridSequential(_SequentialMixin, HybridBlock):
    """Hybrid blocks run in order."""


class Dense(HybridBlock):
    """``out = act(x @ weight.T + bias)`` with ``weight`` (units,
    in_units).  ``activation`` is any of MXNet's ``Activation`` types or
    None; ``flatten`` folds every axis after the first into the input."""

    def __init__(self, units, in_units=0, use_bias=True, flatten=True,
                 activation=None, dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", device=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if activation is not None and activation not in _ops.ACTIVATIONS:
            raise MXNetError(f"Dense activation {activation!r} is not "
                             f"ported; have {sorted(_ops.ACTIVATIONS)} or "
                             "None")
        if int(in_units) <= 0:
            raise MXNetError("Dense needs in_units: deferred shape "
                             "inference is not ported")
        if torch_dtype(dtype) != torch.float32:
            raise MXNetError("Dense is created in float32; cast() it")
        self._units = int(units)
        self._flatten = bool(flatten)
        self._act_type = activation
        self._act = _ops.ACTIVATIONS.get(activation)
        self.weight = _param((units, in_units), device, weight_initializer)
        self.bias = _param((units,), device, bias_initializer) \
            if use_bias else None

    def forward(self, x):
        if self._flatten:
            x = x.reshape(x.shape[0], -1)
        out = F.linear(x, self.weight, self.bias)
        return out if self._act is None else self._act(out)

    def __repr__(self):
        return (f"Dense({self.weight.shape[1]} -> {self._units}, "
                f"{self._act_type or 'linear'})")


class LayerNorm(HybridBlock):
    """Normalises ``axis`` (default the last); ``gamma``/``beta`` of
    ``in_channels`` and ``epsilon=1e-5`` as in MXNet."""

    def __init__(self, in_channels, epsilon=1e-5, axis=-1, device=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._eps = float(epsilon)
        self._axis = int(axis)
        self.gamma = _param((in_channels,), device)
        self.beta = _param((in_channels,), device)

    def forward(self, x):
        if self._axis not in (-1, x.dim() - 1):
            x = x.movedim(self._axis, -1)
            out = F.layer_norm(x, (x.shape[-1],), self.gamma, self.beta,
                               self._eps)
            return out.movedim(-1, self._axis)
        return F.layer_norm(x, (x.shape[-1],), self.gamma, self.beta,
                            self._eps)


# a table of at most this many rows takes its gradient as one GEMM over
# a one-hot matrix (the token types: 2 rows)
_ONE_HOT_ROWS = 64


class _SortedEmbedding(torch.autograd.Function):
    """``weight[ids]`` whose gradient sums the rows of a repeated id in a
    fixed order: one GEMM over a one-hot matrix for a small table, else
    ``index_put_`` with ``accumulate``, which sorts the ids on the card.
    ``F.embedding``'s CUDA backward sums a long run of one id (the token
    types: every id 0) in an order that changes from call to call, which
    no bit-for-bit check of a train step survives."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        flat, g = ids.reshape(-1), grad.reshape(-1, grad.shape[-1])
        if ctx.rows <= _ONE_HOT_ROWS:
            rows = torch.arange(ctx.rows, device=ids.device)
            return None, (flat[:, None] == rows).to(g.dtype).t() @ g
        gw = grad.new_zeros(ctx.rows, g.shape[1])
        gw.index_put_((flat.long(),), g, accumulate=True)
        return None, gw


class Embedding(HybridBlock):
    """Row lookup into ``weight`` (input_dim, output_dim); ids of any
    integer dtype.  On the card its gradient is deterministic
    (:class:`_SortedEmbedding`); on the CPU it is ``F.embedding``'s, which
    is."""

    def __init__(self, input_dim, output_dim, weight_initializer=None,
                 sparse_grad=False, device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True) is not ported "
                             "(sparse arrays: ROADMAP Queue A item 15)")
        self.weight = _param((input_dim, output_dim), device,
                             weight_initializer)

    def forward(self, ids):
        if ids.dtype not in (torch.int32, torch.int64):
            ids = ids.long()
        if self.weight.is_cuda:
            return _SortedEmbedding.apply(ids, self.weight)
        return F.embedding(ids, self.weight)


class Dropout(HybridBlock):
    """Dropout at ``rate``.  Called through the Gluon surface (with
    NDArrays) it is active while ``autograd.is_training()``; called with
    tensors it follows the module's ``training`` flag, as the serving
    engine and ``SPMDTrainer`` set it."""

    def __init__(self, rate=0.0, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = float(rate)
        self._axes = tuple(axes)

    def forward(self, x):
        from ... import autograd as _ag
        training = _ag.is_training() if _block.in_gluon_call() \
            else self.training
        if not training or self._rate <= 0.0:
            return x
        if not self._axes:
            return F.dropout(x, self._rate, training=True)
        shape = tuple(x.shape[i] if i in self._axes else 1
                      for i in range(x.dim()))
        keep = torch.rand(shape, device=x.device) >= self._rate
        return torch.where(keep, x / (1.0 - self._rate), torch.zeros_like(x))


class Flatten(HybridBlock):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def __repr__(self):
        return "Flatten"


class Identity(HybridBlock):
    def forward(self, x):
        return x


class Lambda(Block):
    """A function of NDArrays as a block; a string names an ``nd`` op."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            function = getattr(nd, function)
        self._func = function

    def forward(self, *args):
        return _block._unwrap(self._func(*_block._wrap(args)))


class HybridLambda(HybridBlock):
    """``function(F, *args)`` over NDArrays as a block; a string names an
    ``F`` op."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func = function

    def forward(self, *args):
        from ... import ndarray as nd
        nds = _block._wrap(args)
        out = getattr(nd, self._func)(*nds) if isinstance(self._func, str) \
            else self._func(nd, *nds)
        return _block._unwrap(out)


def gelu(x):
    """The erf GELU (MXNet's ``approximate=False``)."""
    return F.gelu(x, approximate="none")
