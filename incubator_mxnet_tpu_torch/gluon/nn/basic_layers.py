"""Basic layers as ``torch.nn.Module``s with MXNet's parameter shapes and
names (counterpart of ``incubator_mxnet_tpu/gluon/nn/basic_layers.py``).

Every layer derives from :class:`Block`, whose ``_alias`` is the word
MXNet's name scopes number (``dense0``, ``layernorm1``, ...).
:func:`mx_named_parameters` walks a module tree in registration order and
numbers the aliases per parent exactly as MXNet's name scopes do, so a
port model's parameters carry the JAX package's ``collect_params()``
names (model prefix stripped) — the key that weights cross packages by."""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError

__all__ = ["Block", "Dense", "LayerNorm", "Embedding", "Dropout", "gelu",
           "mx_named_parameters"]


class Block(nn.Module):
    """A module that takes part in MXNet-style parameter naming."""

    _alias = "block"

    @property
    def device(self) -> torch.device:
        """The device of the block's (first) parameter."""
        return next(self.parameters()).device

    def initialize(self, init=None, seed=0):
        """Draw every parameter from ``numpy.random.RandomState(seed)``
        (default initializer ``Uniform(0.07)``, as in MXNet)."""
        # initializer names parameters through this module
        from ... import initializer as _init
        _init.initialize(self, init if init is not None else _init.Uniform(),
                         seed)
        return self


def _scope_children(module: nn.Module):
    """Children in registration order; plain containers (``ModuleList``,
    ``Sequential``) are transparent, as MXNet's ``HybridSequential``
    children are named in their creator's scope."""
    for child in module.children():
        if isinstance(child, (nn.ModuleList, nn.Sequential)):
            yield from _scope_children(child)
        else:
            yield child


def mx_named_parameters(module: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """``[(mxnet_name, parameter)]`` in MXNet ``collect_params()`` order,
    without the root block's own prefix (``embedding0_weight``,
    ``gptcell0_multiheadattention0_dense0_weight``, ...)."""
    out: List[Tuple[str, nn.Parameter]] = []

    def walk(mod, prefix):
        for pname, p in mod.named_parameters(recurse=False):
            out.append((prefix + pname, p))
        counters = {}
        for child in _scope_children(mod):
            alias = getattr(child, "_alias", None)
            if alias is None:
                raise TypeError(
                    f"{type(child).__name__} is not a Block: cannot give its "
                    "parameters MXNet names")
            idx = counters.get(alias, 0)
            counters[alias] = idx + 1
            walk(child, f"{prefix}{alias}{idx}_")

    walk(module, "")
    return out


# Dense activations that are ported (MXNet ``act_type`` names)
_ACTIVATIONS = {"tanh": torch.tanh}


class Dense(Block):
    """``out = act(x @ weight.T + bias)``; ``weight`` is (units, in_units)
    and ``activation`` is None or ``"tanh"``.  ``flatten`` folds every axis
    after the first into the input, as MXNet's (default False here: the
    port's callers pass the JAX layer's value)."""

    _alias = "dense"

    def __init__(self, units, in_units, use_bias=True, flatten=False,
                 activation=None, device=None):
        super().__init__()
        if activation is not None and activation not in _ACTIVATIONS:
            raise MXNetError(f"Dense activation {activation!r} is not "
                             f"ported; have {sorted(_ACTIVATIONS)} or None")
        self._flatten = bool(flatten)
        self._act = _ACTIVATIONS.get(activation)
        self.weight = nn.Parameter(torch.zeros(units, in_units, device=device))
        self.bias = nn.Parameter(torch.zeros(units, device=device)) \
            if use_bias else None

    def forward(self, x):
        if self._flatten:
            x = x.reshape(x.shape[0], -1)
        out = F.linear(x, self.weight, self.bias)
        return out if self._act is None else self._act(out)


class LayerNorm(Block):
    """Normalises the last axis; ``gamma``/``beta`` and ``epsilon=1e-5``
    as in MXNet."""

    _alias = "layernorm"

    def __init__(self, in_channels, epsilon=1e-5, device=None):
        super().__init__()
        self._eps = float(epsilon)
        self.gamma = nn.Parameter(torch.ones(in_channels, device=device))
        self.beta = nn.Parameter(torch.zeros(in_channels, device=device))

    def forward(self, x):
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


class Embedding(Block):
    """Row lookup into ``weight`` (input_dim, output_dim).  On the card
    its gradient is deterministic (:class:`_SortedEmbedding`); on the CPU
    it is ``F.embedding``'s, which is."""

    _alias = "embedding"

    def __init__(self, input_dim, output_dim, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(input_dim, output_dim, device=device))

    def forward(self, ids):
        if self.weight.is_cuda:
            return _SortedEmbedding.apply(ids, self.weight)
        return F.embedding(ids, self.weight)


class Dropout(Block):
    """Dropout that is active only in training mode."""

    _alias = "dropout"

    def __init__(self, rate=0.0):
        super().__init__()
        self._rate = float(rate)

    def forward(self, x):
        if self.training and self._rate > 0.0:
            return F.dropout(x, self._rate, training=True)
        return x


def gelu(x):
    """The erf GELU (MXNet's ``approximate=False``)."""
    return F.gelu(x, approximate="none")
