"""Basic layers with MXNet's parameter shapes and names (counterpart of
``incubator_mxnet_tpu/gluon/nn/basic_layers.py``): ``Sequential``,
``HybridSequential``, ``Dense``, ``LayerNorm``, ``BatchNorm``,
``InstanceNorm``, ``GroupNorm``, ``Embedding``, ``Dropout``,
``Flatten``, ``Identity``, ``Lambda``, ``HybridLambda``,
``HybridConcatenate``, ``Concatenate``.

Each layer is a :class:`..block.HybridBlock` whose ``forward`` is torch
code over tensors, and each creates its parameters on ``device``
(default: the current context, ``cuda:0`` outside ``with mx.cpu():``).
An input width of 0 (``in_units``, ``in_channels``, the default) is
deferred to the first forward, which sets it from the input
(``infer_shape``), as in the reference.  ``BatchNorm`` writes its
running statistics through ``block.update_aux`` while
``autograd.is_training()`` (inside a hybridized call's graph too)."""
from __future__ import annotations

import math

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
           "Dense", "LayerNorm", "BatchNorm", "InstanceNorm", "GroupNorm",
           "Embedding", "Dropout", "Flatten", "Identity", "Lambda",
           "HybridLambda", "HybridConcatenate", "Concatenate", "gelu",
           "mx_named_parameters"]


def _param(shape, device, init=None, dtype="float32", grad_req="write",
           differentiable=True):
    """A zero ``nn.Parameter`` of ``shape`` and ``dtype`` on ``device``
    carrying its own initializer (``mx_init``) when ``init`` is given, and
    the Gluon parameter's ``grad_req`` and ``differentiable``.  A 0 in
    ``shape`` defers that dimension to the first forward (``mx_deferred``:
    the tensor is a zero-size placeholder until then)."""
    p = nn.Parameter(torch.zeros(*shape, device=resolve_device(device),
                                 dtype=torch_dtype(dtype)))
    if init is not None:
        from ... import initializer as _init
        p.mx_init = _init.create(init)
    p.mx_grad_req = grad_req
    p.mx_differentiable = differentiable
    p.mx_deferred = 0 in tuple(shape)
    return p


def _training(block) -> bool:
    """Train mode as Dropout reads it: ``autograd.is_training()`` through
    the Gluon surface, the module's ``training`` flag for tensor calls."""
    from ... import autograd as _ag
    return _ag.is_training() if _block.in_gluon_call() else block.training


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
    None; ``flatten`` folds every axis after the first into the input;
    ``dtype`` the parameters' (as the JAX layer's; ``cast`` changes it
    later)."""

    def __init__(self, units, in_units=0, use_bias=True, flatten=True,
                 activation=None, dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", device=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if activation is not None and activation not in _ops.ACTIVATIONS:
            raise MXNetError(f"Dense activation {activation!r} is not "
                             f"ported; have {sorted(_ops.ACTIVATIONS)} or "
                             "None")
        self._units = int(units)
        self._flatten = bool(flatten)
        self._act_type = activation
        self._act = _ops.ACTIVATIONS.get(activation)
        self.weight = _param((units, max(int(in_units), 0)), device,
                             weight_initializer, dtype)
        self.bias = _param((units,), device, bias_initializer, dtype) \
            if use_bias else None

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self._reg_params["weight"].shape = (self._units, in_units)

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
    ``in_channels`` (0: from the first input) and ``epsilon=1e-5`` as in
    MXNet."""

    def __init__(self, in_channels=0, epsilon=1e-5, axis=-1, device=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._eps = float(epsilon)
        self._axis = int(axis)
        self.gamma = _param((in_channels,), device)
        self.beta = _param((in_channels,), device)

    def infer_shape(self, x, *args):
        for name in ("gamma", "beta"):
            self._reg_params[name].shape = (x.shape[self._axis],)

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
    fixed order: one GEMM over a one-hot matrix for a small table (in the
    weight's dtype, fp32 accumulation), else ``index_put_`` with
    ``accumulate`` into fp32, which sorts the ids on the card.
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
        # a 16-bit table's rows sum in fp32 and round once
        gw = grad.new_zeros(ctx.rows, g.shape[1], dtype=torch.float32)
        gw.index_put_((flat.long(),), g.float(), accumulate=True)
        return None, gw.to(grad.dtype)


class Embedding(HybridBlock):
    """Row lookup into ``weight`` (input_dim, output_dim) of ``dtype`` (as
    the JAX layer's); ids of any integer dtype.  On the card its gradient
    is deterministic (:class:`_SortedEmbedding`, in the weight's dtype:
    a 16-bit table's gradient sums in fp32 and rounds once); on the CPU
    it is ``F.embedding``'s, which is."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, device=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True) is not ported "
                             "(sparse arrays: ROADMAP Queue A item 15)")
        self.weight = _param((input_dim, output_dim), device,
                             weight_initializer, dtype)

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
    engine and ``SPMDTrainer`` set it.  Its masks come from the port's
    generator of the input's device (``ndarray.ops.dropout_tensor``), so
    ``mx.random.seed`` fixes them and a checkpoint's ``rng`` carries
    them, as the JAX layer's come from the framework's key stream."""

    def __init__(self, rate=0.0, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = float(rate)
        self._axes = tuple(axes)

    def forward(self, x):
        if not _training(self) or self._rate <= 0.0:
            return x
        return _ops.dropout_tensor(x, self._rate, self._axes or None)


class _Norm(HybridBlock):
    """``gamma`` and ``beta`` of ``in_channels`` (0: the input's channel
    axis at the first forward), as the reference's norm layers make them:
    their own initializers, ``grad_req='null'`` for gamma without
    ``scale`` and for beta without ``center``."""

    def __init__(self, in_channels, center, scale, beta_initializer,
                 gamma_initializer, device, prefix, params, axis=1):
        super().__init__(prefix=prefix, params=params)
        self._axis = int(axis)
        self.gamma = _param((in_channels,), device, gamma_initializer,
                            grad_req="write" if scale else "null")
        self.beta = _param((in_channels,), device, beta_initializer,
                           grad_req="write" if center else "null")

    def infer_shape(self, x, *args):
        for p in self._reg_params.values():
            p.shape = (x.shape[self._axis],)


class BatchNorm(_Norm):
    """Batch normalisation over ``axis`` (the channel axis, default 1).
    While ``autograd.is_training()`` (the module's ``training`` for a
    tensor call) and not ``use_global_stats`` it normalises with the
    batch's statistics and moves the running ones, ``running =
    running * momentum + batch * (1 - momentum)`` with the biased batch
    variance, through :func:`..block.update_aux`; otherwise it normalises
    with the running statistics.  ``scale=False`` fixes gamma at one
    (the op's ``fix_gamma``)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 device=None, prefix=None, params=None):
        super().__init__(in_channels, center, scale, beta_initializer,
                         gamma_initializer, device, prefix, params, axis)
        self._momentum = float(momentum)
        self._epsilon = float(epsilon)
        self._scale = bool(scale)
        self._use_global_stats = bool(use_global_stats)
        self.in_channels = in_channels
        self.running_mean = _param((in_channels,), device,
                                   running_mean_initializer,
                                   grad_req="null", differentiable=False)
        self.running_var = _param((in_channels,), device,
                                  running_variance_initializer,
                                  grad_req="null", differentiable=False)

    def forward(self, x):
        from ...ndarray.nn import batch_norm
        if _training(self) and not self._use_global_stats:
            out, mean, var = batch_norm(
                x, self.gamma, self.beta, eps=self._epsilon,
                fix_gamma=not self._scale, axis=self._axis)
            m = self._momentum
            with torch.no_grad():
                new_mean = self.running_mean * m + mean * (1 - m)
                new_var = self.running_var * m + var * (1 - m)
            _block.update_aux(self._reg_params["running_mean"], new_mean)
            _block.update_aux(self._reg_params["running_var"], new_var)
            return out
        return batch_norm(x, self.gamma, self.beta, self.running_mean,
                          self.running_var, eps=self._epsilon,
                          fix_gamma=not self._scale, use_global_stats=True,
                          axis=self._axis)[0]


class InstanceNorm(_Norm):
    """Normalises each sample's channel over the axes after the channel
    axis (1); by default gamma is fixed (``scale=False``), as in the
    reference."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, prefix=None, params=None):
        super().__init__(in_channels, center, scale, beta_initializer,
                         gamma_initializer, device, prefix, params)
        self._epsilon = float(epsilon)

    def forward(self, x):
        from ...ndarray.nn import instance_norm
        return instance_norm(x, self.gamma, self.beta, self._epsilon)


class GroupNorm(_Norm):
    """Normalises each of ``num_groups`` groups of channels (axis 1) of
    each sample."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, prefix=None, params=None):
        super().__init__(in_channels, center, scale, beta_initializer,
                         gamma_initializer, device, prefix, params)
        self._num_groups = int(num_groups)
        self._epsilon = float(epsilon)

    def forward(self, x):
        from ...ndarray.nn import group_norm
        return group_norm(x, self.gamma, self.beta, self._num_groups,
                          self._epsilon)


class _ConcatMixin:
    add = _SequentialMixin.add

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return torch.cat([block(x) for block in self._modules.values()],
                         dim=self.axis)


class HybridConcatenate(_ConcatMixin, HybridBlock):
    """Runs each child on the input and concatenates their outputs along
    ``axis``."""


class Concatenate(_ConcatMixin, Block):
    """:class:`HybridConcatenate` as a plain block."""


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
