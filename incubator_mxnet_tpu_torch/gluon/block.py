"""Gluon ``Block`` and ``HybridBlock`` as ``torch.nn.Module``s
(counterpart of ``incubator_mxnet_tpu/gluon/block.py``).

Naming follows the reference: a block's prefix is its alias (the class
name in lower case) numbered per enclosing name scope (``gptmodel0_``),
a block built inside ``with parent.name_scope():`` is numbered in the
parent's scope (``gptmodel0_gptcell1_``), and a ``torch.nn.Parameter``
assigned to a block becomes a Gluon :class:`.Parameter` named
``prefix + attribute`` (``gptmodel0_gptcell1_ln1_gamma``), so
``collect_params()`` keys are the JAX package's.  The counters are per
thread, as the reference's.

Called with NDArrays, a block unwraps them, runs ``forward`` on tensors
with torch's grad mode set to ``autograd.is_recording()`` and wraps the
outputs; ``Dropout`` then takes its mode from ``autograd.is_training()``.
Called with tensors it is the plain ``nn.Module`` call, untouched: the
serving engine, its CUDA-graph captures and ``SPMDTrainer`` see no
change.

``hybridize()`` keeps the reference's flag and its propagation; a
hybridized block runs the same eager body (the reference's cached graph
as CUDA-graph replay is ROADMAP Queue A item 8; a block served through
:class:`..serving.InferenceEngine` already replays one graph per
batch-size bucket).  A block may define the
reference's ``hybrid_forward(F, x, *args, **params)`` over NDArrays
instead of ``forward``; ``F`` is :mod:`..ndarray`."""
from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import List, Tuple

import torch
from torch import nn

from ..base import MXNetError
from .. import autograd as _ag
from ..ndarray.ndarray import NDArray
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "mx_named_parameters", "in_gluon_call"]

_naming = threading.local()
_calls = threading.local()


def _scopes():
    if not hasattr(_naming, "counters"):
        _naming.counters = [{}]     # per-scope alias counters
        _naming.prefixes = [""]
    return _naming


def _gen_prefix(hint: str) -> str:
    st = _scopes()
    cnt = st.counters[-1]
    i = cnt.get(hint, 0)
    cnt[hint] = i + 1
    return f"{st.prefixes[-1]}{hint}{i}_"


class _NameScope:
    """The prefix scope children are built in (``Block.name_scope``)."""

    def __init__(self, prefix):
        self._prefix = prefix

    def __enter__(self):
        st = _scopes()
        st.prefixes.append(self._prefix)
        st.counters.append({})
        return self

    def __exit__(self, *exc):
        st = _scopes()
        st.prefixes.pop()
        st.counters.pop()
        return False


def in_gluon_call() -> bool:
    """True inside a block called with NDArrays (the Gluon surface)."""
    return getattr(_calls, "depth", 0) > 0


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return x


def _wrap(x):
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap(v) for v in x)
    return x


def _has_nd(args, kwargs) -> bool:
    return any(isinstance(a, NDArray) or (
        isinstance(a, (list, tuple)) and any(isinstance(v, NDArray)
                                             for v in a))
        for a in (*args, *kwargs.values()))


class Block(nn.Module):
    """A module with the reference's names, parameters and calling
    convention.  ``_alias`` (default: the class name in lower case) is
    the word its prefix numbers."""

    _alias = "block"

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "_alias" not in cls.__dict__:
            cls._alias = cls.__name__.lower()

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = prefix if prefix is not None \
            else _gen_prefix(self._name_hint())
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._scope = _NameScope(self._prefix)
        self._active = False

    def _name_hint(self) -> str:
        return self._alias

    # -- naming ---------------------------------------------------------
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    def name_scope(self):
        """The scope in which children get this block's prefix."""
        return self._scope

    @property
    def params(self) -> ParameterDict:
        return self._params

    @property
    def device(self) -> torch.device:
        """The device of the block's (first) parameter."""
        return next(self.parameters()).device

    def _children_blocks(self):
        """Child blocks in registration order; a plain torch container
        between two blocks is looked through."""
        for child in self._modules.values():
            if isinstance(child, Block):
                yield child
            elif child is not None:
                yield from Block._children_blocks(child)

    # -- registration ---------------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            super().__setattr__(name, value._var)
            self._register(name, value)
            return
        if isinstance(value, nn.Parameter) and "_reg_params" in \
                self.__dict__:
            own = self._reg_params.get(name)
            if own is not None:         # a new tensor for a parameter
                super().__setattr__(name, value)
                own._rebind(value)
                return
            full = self._prefix + name
            shared = self._params._get_impl(full)
            if shared is not None and shared._var is not value:
                if shared.shape != tuple(value.shape):
                    raise MXNetError(f"shared Parameter {full} has shape "
                                     f"{shared.shape}, not "
                                     f"{tuple(value.shape)}")
                super().__setattr__(name, shared._var)
                self._register(name, shared)
                return
            super().__setattr__(name, value)
            self._register(name, shared or Parameter(
                full, var=value, init=getattr(value, "mx_init", None)))
            return
        super().__setattr__(name, value)

    def _register(self, name, param: Parameter):
        self._reg_params[name] = param
        self._params._params[param.name] = param

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def collect_params(self, select=None) -> ParameterDict:
        """Every parameter of this block and its descendants, optionally
        those whose name matches the regex ``select``."""
        ret = ParameterDict(self._params.prefix)
        pat = re.compile(select) if select is not None else None
        ret.update({k: v for k, v in self._params.items()
                    if pat is None or pat.match(k)})
        for child in self._children_blocks():
            ret.update(child.collect_params(select=select))
        return ret

    # -- state ----------------------------------------------------------
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, seed=None):
        """Fill every parameter not yet initialized, in
        ``collect_params()`` order, from one numpy ``RandomState``
        (``seed``'s, else one drawn from :mod:`..random`); each
        parameter's own initializer wins over ``init`` (default
        ``Uniform()``).  ``initialize(init, seed)`` with an int in the
        second place is the port's earlier form and is kept."""
        if isinstance(ctx, int) and not isinstance(ctx, bool):
            ctx, seed = None, ctx
        self.collect_params().initialize(init, ctx, verbose, force_reinit,
                                         seed=seed)
        return self

    def hybridize(self, active=True, **kwargs):
        """A plain block only passes the flag to its children."""
        for child in self._children_blocks():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter to ``dtype``.  The attention kernels take
        fp32 only (bf16 instances: ROADMAP Queue B); a layer without a
        kernel runs in any dtype torch runs it in."""
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def zero_grad(self, set_to_none=None):
        """Zero every parameter's gradient buffer."""
        self.collect_params().zero_grad()

    def reset_ctx(self, ctx):
        self.collect_params().reset_ctx(ctx)

    # -- serialization --------------------------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        """Structural names (``cells.0.ln1.gamma``), the keys of
        ``save_parameters``."""
        if prefix:
            prefix += "."
        ret = {prefix + n: p for n, p in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename):
        from ..ndarray import utils as nd_utils
        nd_utils.save(filename, {k: v.data() for k, v in
                                 self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """Load a ``save_parameters`` file of this package or the JAX
        package (structural names; full names are tried when no
        structural one matches)."""
        from ..ndarray import utils as nd_utils
        loaded = nd_utils.load(filename, ctx="cpu")
        if not isinstance(loaded, dict):
            raise MXNetError(f"{filename} does not contain a parameter dict")
        loaded = {k.split(":", 1)[-1] if k.startswith(("arg:", "aux:"))
                  else k: v for k, v in loaded.items()}
        params = self._collect_params_with_prefix()
        if loaded and not any(k in params for k in loaded):
            params = {p.name: p for p in self.collect_params().values()}
        for name, p in params.items():
            if name not in loaded:
                if not allow_missing:
                    raise MXNetError(
                        f"Parameter {name} missing in {filename}")
                continue
            p.set_data(loaded[name])
        if not ignore_extra:
            for k in loaded:
                if k not in params:
                    raise MXNetError(
                        f"Parameter {k} from {filename} not found in Block")

    save_params = save_parameters
    load_params = load_parameters

    # -- calling --------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if not _has_nd(args, kwargs):
            return super().__call__(*args, **kwargs)
        _calls.depth = getattr(_calls, "depth", 0) + 1
        try:
            with torch.set_grad_enabled(_ag.is_recording()):
                out = super().__call__(
                    *_unwrap(args), **{k: _unwrap(v)
                                       for k, v in kwargs.items()})
        finally:
            _calls.depth -= 1
        return _wrap(out)


class HybridBlock(Block):
    """A block that may be hybridized (the reference's flag; see the
    module docstring)."""

    def forward(self, *args, **kwargs):
        """``hybrid_forward(F, *NDArrays, **params)`` for a block written
        against NDArrays, with its parameters as NDArrays by attribute
        name; the port's own layers define ``forward`` over tensors."""
        from .. import ndarray as F
        kw = {n: p.data() for n, p in self._reg_params.items()}
        kw.update(kwargs)
        return _unwrap(self.hybrid_forward(F, *_wrap(args), **kw))

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} defines neither forward nor "
            "hybrid_forward")

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = bool(active)
        # children run inside a hybridized parent's graph; the flag
        # reaches them only when it is turned off, as in the reference
        if not active:
            for child in self._children_blocks():
                child.hybridize(False, **kwargs)


def _scope_children(module: nn.Module):
    """Children in registration order; plain containers and sequentials
    are transparent, as a ``HybridSequential``'s children are named in
    their creator's scope."""
    from .nn.basic_layers import HybridSequential, Sequential
    for child in module.children():
        if isinstance(child, (nn.ModuleList, nn.Sequential,
                              HybridSequential, Sequential)):
            yield from _scope_children(child)
        else:
            yield child


def mx_named_parameters(module: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """``[(mxnet_name, parameter)]`` in ``collect_params()`` order, the
    root block's own prefix left out (``embedding0_weight``,
    ``gptcell0_multiheadattention0_dense0_weight``, ...): the names of
    the JAX package's parameters with its model prefix stripped, computed
    from the module tree, so they do not depend on how many models this
    thread built before."""
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
