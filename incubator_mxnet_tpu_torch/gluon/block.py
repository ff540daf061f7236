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
change.  A block whose parameters wait for their shape (``Dense(4)``)
settles them at its first call (:meth:`HybridBlock.infer_shape`), as the
reference's deferred initialisation does.

``hybridize()`` makes a HybridBlock called with NDArrays run as the
reference's cached graph (:class:`_CachedGraph`): one program per key
(the inputs' shapes and dtypes, the other arguments, training and
recording, and the parameters' storage).  On the card the key's first
call runs the block eagerly, which settles what is lazy, and then
captures its forward, and under ``autograd.record()`` its backward, as
two CUDA graphs in one pool; later calls replay them, the pair as one
tape node (``autograd.GraphedCall``), the port's generator registered so
dropout draws what eager would.  On the CPU a key binds the eager body.
Running statistics are written through :func:`update_aux`, in place, so
a capture holds the write.  A hybridized child runs inline in its
parent's call.  A block may define the reference's
``hybrid_forward(F, x, *args, **params)`` over NDArrays instead of
``forward``; ``F`` is :mod:`..ndarray`."""
from __future__ import annotations

import re
import threading
import time
import weakref
from collections import OrderedDict
from typing import List, Tuple

import torch
from torch import nn

from ..base import MXNetError
from .. import autograd as _ag
from .. import telemetry as _telemetry
from ..ndarray.ndarray import NDArray
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "mx_named_parameters", "in_gluon_call",
           "update_aux", "functional_call"]

_naming = threading.local()
_calls = threading.local()
# per thread: the aux collector of an open functional_call, and how many
# cached-graph bodies are running (a hybridized child runs inline there)
_trace = threading.local()


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


class _GluonCall:
    """The scope of a block called through the Gluon surface: layers
    read ``autograd.is_training()`` inside it.  ``inline`` also marks a
    cached-graph body, in which hybridized children run inline."""

    def __init__(self, inline=False):
        self._inline = inline

    def __enter__(self):
        _calls.depth = getattr(_calls, "depth", 0) + 1
        if self._inline:
            _trace.inline = getattr(_trace, "inline", 0) + 1
        return self

    def __exit__(self, *exc):
        _calls.depth -= 1
        if self._inline:
            _trace.inline -= 1
        return False


def _inline() -> bool:
    """True inside a cached-graph body, a functional_call or any open CUDA
    graph capture: there a hybridized block runs its body inline."""
    return (getattr(_trace, "inline", 0) > 0
            or getattr(_trace, "collector", None) is not None
            or (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()))


class _substituted:
    """Within the scope, every module of ``block`` that holds a parameter
    tensor whose id is a key of ``values`` holds the value instead (put
    into ``_parameters`` directly, as ``torch.func`` reparametrises), and
    the Gluon :class:`.Parameter` over that tensor hands it out from
    ``data()``, which ``hybrid_forward`` blocks read; the tensors come
    back at the exit."""

    def __init__(self, block, values):
        self._block = block
        self._values = values
        self._saved = []
        self._nds = []

    def __enter__(self):
        seen = set()
        for mod in self._block.modules():
            for name, var in list(mod._parameters.items()):
                if var is not None and id(var) in self._values:
                    self._saved.append((mod, name, var))
                    mod._parameters[name] = self._values[id(var)]
            params = mod._params._params.values() \
                if isinstance(mod, Block) else ()
            for p in params:
                if id(p._var) in self._values and id(p) not in seen:
                    seen.add(id(p))
                    self._nds.append((p._nd, p._nd._data))
                    p._nd._data = self._values[id(p._var)]
        return self

    def __exit__(self, *exc):
        for mod, name, var in reversed(self._saved):
            mod._parameters[name] = var
        for nd, data in self._nds:
            nd._data = data
        self._saved = []
        self._nds = []
        return False


def update_aux(param: Parameter, new_value):
    """Write ``new_value`` into an auxiliary (non-differentiable)
    parameter, running statistics for example.  In place, outside any
    graph: a captured program holds the write, so each replay makes it.
    Inside :func:`functional_call` the value is collected instead and the
    parameter is left as it is."""
    val = new_value._data if isinstance(new_value, NDArray) else new_value
    coll = getattr(_trace, "collector", None)
    if coll is not None:
        coll[id(param)] = val
        return
    with torch.no_grad():
        param._var.copy_(val)


def functional_call(block, params, param_vals, aux_params, aux_vals,
                    inputs, training, rng_key=None):
    """Run ``block``'s forward with ``param_vals``/``aux_vals`` (tensors or
    NDArrays) in place of the parameters ``params``/``aux_params``, in
    train mode ``training``, and collect the aux updates
    (:func:`update_aux`) instead of writing them.  Returns (the outputs as
    a list of tensors, the new aux values aligned with ``aux_params``;
    an aux the forward did not update keeps its value).  The reference
    pauses recording and its outputs stay differentiable by JAX's
    transforms; here torch's autograd is the transform, so recording
    follows the caller's grad mode and the outputs are differentiable in
    the values, ``hybrid_forward`` bodies over NDArrays included.  The
    parameters are as before afterwards.  ``rng_key`` (the reference's
    dropout key) is refused by name: the port's dropout draws from
    ``random.generator``."""
    if rng_key is not None:
        raise MXNetError("functional_call: rng_key is not ported; dropout "
                         "draws from the port's generator (random.seed)")
    all_params = list(params) + list(aux_params)
    all_vals = [v._data if isinstance(v, NDArray) else v
                for v in list(param_vals) + list(aux_vals)]
    coll = {}
    prev = getattr(_trace, "collector", None)
    grad_mode = torch.is_grad_enabled()
    try:
        _trace.collector = coll
        with _substituted(block, {id(p._var): v for p, v in
                                  zip(all_params, all_vals)}), \
                _ag._RecordingStateScope(grad_mode, training), \
                _GluonCall(), torch.set_grad_enabled(grad_mode):
            out = nn.Module.__call__(block, *_unwrap(list(inputs)))
    finally:
        _trace.collector = prev
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    new_aux = [coll.get(id(p), v) for p, v in
               zip(aux_params, all_vals[len(params):])]
    return outs, new_aux


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
        self._cached_graph = None
        # a parameter of this block waits for its shape (first call)
        self._deferred = False

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
                full, var=value, init=getattr(value, "mx_init", None),
                grad_req=getattr(value, "mx_grad_req", "write"),
                differentiable=getattr(value, "mx_differentiable", True),
                allow_deferred_init=getattr(value, "mx_deferred", False)))
            return
        super().__setattr__(name, value)

    def _register(self, name, param: Parameter):
        self._reg_params[name] = param
        self._params._params[param.name] = param
        if not param._allocated:
            self._deferred = True

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
        """Cast every parameter (and its gradient buffer) to ``dtype``, as
        the JAX block casts them.  A cast net computes in that dtype at
        every layer, as the JAX net does: the attention kernels take
        fp32, bf16 and fp16 (fp32 inside), and the whole-tree updates
        keep or promote the dtypes as the reference's rules do."""
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
        if self._deferred:
            self._settle(args)
        if not _has_nd(args, kwargs):
            return super().__call__(*args, **kwargs)
        if self._cached_graph is not None and not _inline():
            return self._cached_graph(args, kwargs)
        return self._call_nd(args, kwargs)

    def _call_nd(self, args, kwargs):
        """The eager call through the Gluon surface: NDArrays in and out,
        grad mode as recording."""
        with _GluonCall(), torch.set_grad_enabled(_ag.is_recording()):
            out = super().__call__(*_unwrap(args),
                                   **{k: _unwrap(v) for k, v in
                                      kwargs.items()})
        return _wrap(out)

    def _settle(self, args):
        """Settle this block's deferred parameters from its first inputs:
        :meth:`infer_shape`, then allocate and fill each (the reference's
        ``_forward_eager`` on a ``DeferredInitializationError``)."""
        params = list(self._reg_params.values())
        if any(p._deferred_init is not None for p in params):
            self.infer_shape(*_unwrap(args))
            for p in params:
                p._finish_deferred_init()
        for p in params:
            p._check_initialized()
        self._deferred = False

    def infer_shape(self, *args):
        """Set the shapes of this block's deferred parameters from its
        inputs; layers with ``in_units``/``in_channels=0`` override it."""
        raise MXNetError(
            f"{type(self).__name__} has deferred-shape parameters but does "
            "not implement infer_shape; initialize with explicit input "
            "dims")


class HybridBlock(Block):
    """A block that may be hybridized (see the module docstring)."""

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
        """Run this block's NDArray calls as a cached graph
        (:class:`_CachedGraph`; a new one each time, so the old programs
        are dropped); ``active=False`` returns to eager calls.
        ``static_alloc``/``static_shape`` are kept for the reference's API:
        a captured graph's buffers are static and its key holds exact
        shapes anyway."""
        self._active = bool(active)
        self._cached_graph = _CachedGraph(self) if active else None
        # children run inside a hybridized parent's graph; the flag
        # reaches them only when it is turned off, as in the reference
        if not active:
            for child in self._children_blocks():
                child.hybridize(False, **kwargs)


# ---------------------------------------------------------------------------
# the cached graph
# ---------------------------------------------------------------------------
_ND = "\0nd"     # an NDArray's place in a call's argument template


def _template(x, leaves):
    """The hashable structure of a call's arguments, each NDArray (or
    tensor) replaced by :data:`_ND` and its tensor appended to
    ``leaves``."""
    if isinstance(x, (NDArray, torch.Tensor)):
        leaves.append(x._data if isinstance(x, NDArray) else x)
        return _ND
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_template(v, leaves) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _template(v, leaves))
                                 for k, v in sorted(x.items()))
    try:
        hash(x)
    except TypeError:
        return repr(x)
    return x


def _substitute(x, it):
    """``x`` with each NDArray (or tensor) replaced by the next tensor of
    ``it``."""
    if isinstance(x, (NDArray, torch.Tensor)):
        return next(it)
    if isinstance(x, (list, tuple)):
        return type(x)(_substitute(v, it) for v in x)
    if isinstance(x, dict):
        return {k: _substitute(v, it) for k, v in x.items()}
    return x


def _flatten_out(x, leaves):
    """The structure of a block's output, its tensors appended to
    ``leaves``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return None
    if isinstance(x, (list, tuple)):
        return (type(x), [_flatten_out(v, leaves) for v in x])
    return ("const", x)


def _build_out(spec, it):
    if spec is None:
        return next(it)
    if spec[0] == "const":
        return spec[1]
    kind, parts = spec
    return kind(_build_out(p, it) for p in parts)


def _users(t) -> int:
    """How many tensors use ``t``'s storage (views and aliases
    included)."""
    return torch._C._storage_Use_Count(t.untyped_storage()._cdata)


class _Token:
    """Lives as long as a replay's tape node (weakly referenced)."""


class _Program:
    """One captured instance of a key: the forward graph and, for a
    recorded key, the backward graph, in one pool of their own.

    ``inputs`` are the static buffers the caller's tensors are copied
    into, ``outs`` the forward's outputs, ``grad_outs`` the buffers of the
    incoming output gradients and ``grads`` the gradients of the
    differentiable tensors (``None`` where there is none).  The program is
    busy while a replay's tape node waits for its backward (``hold``), or
    while the caller still uses an output of the last replay (more users
    of its storage than ``users``).  With ``copy_out`` a replay returns
    copies of the outputs, which leave it free."""

    def __init__(self):
        self.fwd = self.bwd = None
        self.inputs = []
        self.outs = []
        self.spec = None
        self.diff = ()
        self.grad_outs = []
        self.grads = ()
        self.fwd_tally = self.bwd_tally = {}
        self.users = []
        self.generation = 0
        self.pending = None
        self.copy_out = False
        self.pool_bytes = 0

    def busy(self) -> bool:
        return self.pending_backward() or self.held()

    def pending_backward(self) -> bool:
        return self.pending is not None and self.pending() is not None

    def held(self) -> bool:
        return not self.copy_out and any(
            _users(o) > n for o, n in zip(self.outs, self.users))

    def hold(self):
        """A token whose life marks the saved activations as needed."""
        token = _Token()
        self.pending = weakref.ref(token)
        return token

    def stage(self, tensors):
        with torch.no_grad():
            for s, t in zip(self.inputs, tensors):
                if s.data_ptr() != t.data_ptr():
                    s.copy_(t)

    def replay_forward(self):
        from ..kernels.flash_attention import add_launches
        self.fwd.replay()
        add_launches(self.fwd_tally)
        self.generation += 1
        if self.copy_out:
            return tuple(o.clone() for o in self.outs)
        return tuple(o.detach() for o in self.outs)

    def replay_backward(self, generation, grads):
        """Replay the backward graph for the incoming ``grads`` (one per
        output); the gradient buffers, one per differentiable tensor."""
        from ..kernels.flash_attention import add_launches
        if generation != self.generation:
            raise MXNetError(
                "backward through a hybridized call whose graph was "
                "replayed since (a second backward with retain_graph after "
                "another call of the block): its saved activations are "
                "gone")
        with torch.no_grad():
            for s, g in zip(self.grad_outs,
                            (g for g, d in zip(grads, self.diff) if d)):
                if g is None:
                    s.zero_()
                elif s.data_ptr() != g.data_ptr():
                    s.copy_(g)
        self.bwd.replay()
        add_launches(self.bwd_tally)
        self.pending = None
        return tuple(None if g is None else g.detach() for g in self.grads)


class _Entry:
    """The programs of one key, the first failure of its capture, and
    whether its replays return copies of their outputs."""

    def __init__(self):
        self.programs: List[_Program] = []
        self.error = None
        self.copy_out = False

    def free(self):
        for p in self.programs:
            if not p.busy():
                return p
        return None

    def copy_from_now_on(self):
        """An output held across calls: drop the programs that hold one
        (their outputs stay the caller's), and let every replay of the key
        return copies."""
        self.programs = [p for p in self.programs if not p.held()]
        self.copy_out = True
        for p in self.programs:
            p.copy_out = True


class _CachedGraph:
    """The reference's CachedOp (its ``_CachedGraph``) over CUDA graphs:
    one :class:`_Entry` per key.

    The key is JAX's (the NDArray inputs' shapes and dtypes, the other
    arguments, ``is_training()``) with recording, each input's device and
    whether it takes a gradient, and the storage (pointer, dtype) of every
    parameter: a ``cast``, ``reset_ctx``, ``load_state_dict(...,
    assign=True)`` or a settled deferred shape gives new storage, and the
    programs over the old storage are dropped, never replayed.
    ``set_data``, ``load_parameters`` and ``initialize(force_reinit=True)``
    write in place, and a replay reads the new values.

    On the card the first call of a key runs the block eagerly (it settles
    what is lazy and builds kernels at first use; its outputs are the
    call's), then captures program 0.  A later call stages its inputs
    into a free program's buffers and replays it; its outputs are the
    program's own buffers, handed out without a copy.  With no program
    free it captures another, one for each recorded call still waiting
    for its backward (gradient accumulation over calls: the activations
    eager would hold too).  An output the caller still holds at the next
    call (``logits = net(x)`` in a loop holds the last step's logits while
    the next call runs) is never overwritten: its program is dropped,
    another is captured, and the key's replays return copies from then on
    (one pool, a copy of the outputs per call).  A capture that fails
    raises :class:`MXNetError`
    naming the block and the key, and so does every later call of the
    key: nothing runs eagerly on the card after the first call.

    On the CPU a key binds the eager body, as the serving engine's warmup
    binds its bodies there.  ``captures`` counts captures (CPU: bound
    keys), ``replays`` calls served by them; both, with each call's host
    seconds, also go to the dispatch ledger's ``cached_op`` site."""

    def __init__(self, block):
        # weakly: the block holds this cache, and a cycle would keep a
        # dropped net's graph pools until the cyclic collector ran
        self._block = weakref.ref(block)
        self._cache = {}
        self._params = None
        self._sig = None
        self._lock = threading.RLock()
        self.captures = 0
        self.replays = 0
        self._ledger = _telemetry.ledger_site("cached_op")

    @property
    def block(self):
        return self._block()

    def __deepcopy__(self, memo):
        import copy
        return _CachedGraph(copy.deepcopy(self.block, memo))

    def keys(self):
        return list(self._cache)

    @property
    def pool_bytes(self) -> int:
        """The bytes the captures of the programs kept added to the
        allocator's reserve."""
        return sum(p.pool_bytes for e in self._cache.values()
                   for p in e.programs)

    def __call__(self, args, kwargs):
        with _telemetry.trace_span("cached_op", cat="executor",
                                   block=self.block.name):
            with self._lock:
                return self._call_impl(args, kwargs)

    def _param_list(self):
        if self._params is None:
            self._params = list(self.block.collect_params().values())
        return self._params

    def _call_impl(self, args, kwargs):
        params = self._param_list()
        if any(not p._allocated for p in params):
            # settle deferred shapes eagerly first, as the reference
            return self.block._call_nd(args, kwargs)
        tensors = []
        template = _template((args, kwargs), tensors)
        recording, training = _ag.is_recording(), _ag.is_training()
        sig = tuple((p._var.data_ptr(), p._var.dtype, p._var.requires_grad)
                    for p in params)
        if sig != self._sig:
            self._cache.clear()
            self._sig = sig
        key = (template, tuple((tuple(t.shape), t.dtype, t.device,
                                recording and t.requires_grad)
                               for t in tensors), training, recording)
        dev = tensors[0].device if tensors else params[0]._var.device
        t0 = time.perf_counter()
        entry = self._cache.get(key)
        if dev.type != "cuda":
            if entry is None:
                entry = self._cache[key] = _Entry()
                out = self._run(args, kwargs, tensors)
                self.captures += 1
                self._ledger.record_compile(time.perf_counter() - t0)
            else:
                out = self._run(args, kwargs, tensors)
                self.replays += 1
            self._ledger.record(time.perf_counter() - t0)
            return _wrap(out)
        from .. import cuda_graphs as _graphs
        if entry is None:
            entry = self._cache[key] = _Entry()
            with _graphs.CAPTURE_LOCK:
                # on the caller's stream, where its backward will run
                out = self._run(args, kwargs, tensors)
                self._capture(entry, key, args, kwargs, tensors, params,
                              dev)
            self._ledger.record(time.perf_counter() - t0)
            return _wrap(out)
        if entry.error is not None:
            raise MXNetError(entry.error)
        prog = entry.free()
        if prog is None:
            if any(p.held() for p in entry.programs):
                entry.copy_from_now_on()
            with _graphs.CAPTURE_LOCK:
                prog = self._capture(entry, key, args, kwargs, tensors,
                                     params, dev)
        prog.copy_out = entry.copy_out
        prog.stage(tensors)
        if prog.bwd is not None:
            live = list({id(p._var): p._var for p in params
                         if p._var.requires_grad}.values()) \
                + [t for t in tensors if t.requires_grad]
            outs = _ag.GraphedCall.apply(prog, *live)
        else:
            outs = prog.replay_forward()
        self.replays += 1
        self._ledger.record(time.perf_counter() - t0)
        return _wrap(_build_out(prog.spec, iter(outs)))

    def _run(self, args, kwargs, tensors):
        """The block's eager body over ``tensors`` in the NDArrays'
        places: tensors out."""
        a, kw = _substitute((args, kwargs), iter(tensors))
        with _GluonCall(inline=True), \
                torch.set_grad_enabled(_ag.is_recording()):
            return nn.Module.__call__(self.block, *a, **kw)

    def _capture(self, entry, key, args, kwargs, tensors, params, dev):
        """Capture one more program of ``key`` (the caller holds
        ``CAPTURE_LOCK``); a failure is the key's for good."""
        from .. import cuda_graphs as _graphs
        recording = key[-1]
        prog = _Program()
        with torch.no_grad():
            prog.inputs = [t.detach().clone() for t in tensors]
        for s, t in zip(prog.inputs, tensors):
            if recording and t.requires_grad:
                s.requires_grad_(True)
        # the capture differentiates fresh leaves over the parameters'
        # storage: a live graph's nodes of the parameters themselves may
        # carry another stream, which a captured backward cannot wait on
        leaves = {id(p._var): p._var.detach().requires_grad_(True)
                  for p in params if recording and p._var.requires_grad}
        diff_in = list(leaves.values()) \
            + [s for s in prog.inputs if s.requires_grad]
        flat = []

        def forward():
            with _substituted(self.block, leaves):
                out = self._run(args, kwargs, prog.inputs)
            prog.spec = _flatten_out(out, flat)
            return flat

        def backward(outs):
            diff = [o for o in outs if o.requires_grad]
            if not diff or not diff_in:
                return None
            prog.grad_outs = [torch.empty_like(o) for o in diff]
            return lambda: torch.autograd.grad(
                diff, diff_in, grad_outputs=prog.grad_outs,
                allow_unused=True)

        t0 = time.perf_counter()
        try:
            # the pattern of torch.cuda.make_graphed_callables, through
            # capture(), which registers the port's generator with both
            pool = torch.cuda.graph_pool_handle()
            fwd = _graphs.capture(forward, dev, pool)
            body = backward(fwd[1]) if recording else None
            bwd = _graphs.capture(body, dev, pool) if body is not None \
                else None
            # the body holds the outputs: the users counted below must be
            # the program's own only, or a held output would go unseen
            del body
        except Exception as e:
            entry.error = (f"hybridized {type(self.block).__name__} "
                           f"{self.block.name}: capture of key "
                           f"{_key_text(key)} failed: {e}")
            raise MXNetError(entry.error) from e
        prog.fwd, _, prog.fwd_tally, grown = fwd
        prog.pool_bytes = grown
        prog.diff = tuple(o.requires_grad for o in flat)
        if bwd is not None:
            prog.bwd, grads, prog.bwd_tally, grown = bwd
            prog.pool_bytes += grown
            prog.grads = tuple(None if g is None else g.detach()
                               for g in grads)
            _ag.register_graph_grads(g for g in prog.grads
                                     if g is not None)
        else:
            prog.grad_outs = []
            prog.diff = (False,) * len(flat)
        prog.outs = [o.detach() for o in flat]
        del flat[:]
        prog.users = [_users(o) for o in prog.outs]
        entry.programs.append(prog)
        self.captures += 1
        self._ledger.record_compile(time.perf_counter() - t0)
        return prog


def _key_text(key) -> str:
    template, inputs, training, recording = key
    shapes = ", ".join(f"{list(s)} {str(d).replace('torch.', '')}"
                       for s, d, _, _ in inputs)
    return (f"({shapes}; training={training}, recording={recording})")


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
