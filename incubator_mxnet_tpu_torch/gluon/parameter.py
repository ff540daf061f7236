"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict`` (counterpart of
``incubator_mxnet_tpu/gluon/parameter.py``).

A :class:`Parameter` wraps one ``torch.nn.Parameter`` of the block that
owns it: ``data()`` is an NDArray over that very tensor, so an update
through ``set_data``, the optimizer or a kernel is seen by the module, and
the module's forward records onto the same graph leaf.  Its gradient
buffer is the NDArray variable's (``autograd``): allocated at the first
backward, written per ``grad_req``, kept at one address.

The module attribute (``dense.weight``) stays the ``nn.Parameter``, as
PyTorch code expects; the Gluon object is reached through
``collect_params()``, ``block.params`` or ``block._reg_params``.

A shape with a 0 (``Dense(4)``'s weight ``(4, 0)``) is unknown until the
block's first forward, as in the reference: the module's tensor is then
a zero-size placeholder, ``initialize`` defers (``allow_deferred_init``)
and ``data()`` raises :class:`DeferredInitializationError`; the first
forward sets the shape (``HybridBlock.infer_shape``) and
``_finish_deferred_init`` gives the same ``nn.Parameter`` object its
full tensor and fills it, so the module, the Gluon parameter and its
NDArray still share one tensor."""
from __future__ import annotations

from collections import OrderedDict
import numpy as _np
import torch
from torch import nn

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, numpy_dtype, torch_dtype

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """A parameter read before the first forward settled its deferred
    shape."""


class Parameter:
    """A weight, bias or state tensor of a block.  ``grad_req`` is
    'write', 'add' or 'null'; ``lr_mult``/``wd_mult`` scale the
    optimizer's learning rate and weight decay for it."""

    def __init__(self, name, grad_req="write", shape=None,
                 dtype=_np.float32, lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default", var=None):
        if stype != "default" or grad_stype != "default":
            raise MXNetError(f"Parameter {name}: sparse storage is not "
                             "ported (ROADMAP Queue A item 15)")
        self.name = name
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        # (init, default_init, rng) from initialize() while the shape waits
        # for the first forward
        self._deferred_init = None
        if var is None:
            from ..context import resolve_device
            self._shape = tuple(int(s) for s in shape) \
                if shape is not None else None
            var = nn.Parameter(torch.zeros(
                tuple(max(s, 0) for s in self._shape or (0,)),
                dtype=torch_dtype(dtype), device=resolve_device(None)))
        else:
            self._shape = tuple(var.shape)
        self._allocated = self._shape_known()
        var.requires_grad_(self._grad_req != "null")
        self._var = var
        # a variable from the start, as the reference's attach at init:
        # a backward fills its gradient (allocated then)
        self._nd = NDArray(var)
        self._attach()
        self._initialized = False

    def _attach(self):
        """Make the NDArray a variable per ``grad_req`` ('null': no
        gradient at all, as the reference's parameter)."""
        self._nd.attach_grad(self._grad_req)
        if self._grad_req == "null":
            self._nd._grad = None

    # -- properties -----------------------------------------------------
    @property
    def shape(self):
        """The shape; a 0 (or None for all of it) is not known yet."""
        return tuple(self._var.shape) if self._allocated else self._shape

    @shape.setter
    def shape(self, new_shape):
        """Set the shape, merged as the reference merges: a known dimension
        may not change, a 0 takes the new value."""
        new_shape = tuple(int(s) for s in new_shape)
        old = self.shape
        if old is not None and (len(old) != len(new_shape) or any(
                s != 0 and s != n for s, n in zip(old, new_shape))):
            raise MXNetError(f"inconsistent shape for Parameter "
                             f"{self.name}: {old} vs {new_shape}")
        if not self._allocated:
            self._shape = new_shape

    def _shape_known(self) -> bool:
        return self._shape is not None and all(s > 0 for s in self._shape)

    @property
    def dtype(self):
        return numpy_dtype(self._var.dtype)

    @property
    def stype(self):
        return "default"

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req!r}")
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        self._var.requires_grad_(req != "null")
        self._attach()

    def _rebind(self, var: nn.Parameter):
        """Wrap ``var``, the module's new tensor for this parameter (a
        ``load_state_dict(..., assign=True)``)."""
        var.requires_grad_(self._grad_req != "null")
        self._var = var
        self._nd._data = var
        self._nd._grad = None
        self._shape = tuple(var.shape)
        self._allocated = self._shape_known()

    def _materialize(self):
        """Give the module's tensor its full (now known) shape, in place:
        the same ``nn.Parameter`` object, zeros until filled."""
        with torch.no_grad():
            self._var.data = torch.zeros(self._shape, dtype=self._var.dtype,
                                         device=self._var.device)
        self._nd._grad = None
        self._allocated = True

    def _finish_deferred_init(self):
        """Allocate and fill a deferred parameter once its shape is known
        (the block's first forward); nothing when none is pending."""
        if self._deferred_init is None:
            return
        if not self._shape_known():
            raise DeferredInitializationError(
                f"Parameter {self.name} has unknown shape {self.shape}")
        init, default_init, rng = self._deferred_init
        self._deferred_init = None
        self._materialize()
        self._fill(init, default_init, rng)

    def _check_initialized(self):
        if self._allocated:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"Parameter {self.name} was not initialized yet: its shape "
                "is deferred to the first forward. Run a forward pass first")
        raise MXNetError(
            f"Parameter {self.name} has not been initialized: its shape "
            f"{self.shape} is not known. Call .initialize() on the Block "
            "and run a forward pass")

    # -- access ---------------------------------------------------------
    def data(self, ctx=None) -> NDArray:
        """The parameter as an NDArray over the module's tensor."""
        self._check_initialized()
        return self._nd

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None) -> NDArray:
        if self._grad_req == "null":
            raise MXNetError(
                f"Parameter {self.name} has grad_req='null': no gradient")
        return self.data().grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [self.data().context]

    def set_data(self, data):
        """Copy ``data`` (NDArray, tensor or array-like) into the
        parameter in place."""
        if isinstance(data, NDArray):
            src = data._data.detach()
        elif isinstance(data, torch.Tensor):
            src = data.detach()
        else:
            src = torch.from_numpy(_np.ascontiguousarray(_np.asarray(data)))
        if not self._allocated:
            self.shape = tuple(src.shape)
            self._deferred_init = None
            self._materialize()
        if tuple(src.shape) != self.shape:
            raise MXNetError(f"Parameter {self.name}: shape "
                             f"{tuple(src.shape)} does not match "
                             f"{self.shape}")
        with torch.no_grad():
            self._var.copy_(src)
        self._initialized = True

    def zero_grad(self):
        self._nd.zero_grad()

    def cast(self, dtype):
        """Change the parameter's dtype in place.  Its gradient follows:
        a buffer it had is replaced by a zero buffer of the new dtype (as
        the JAX parameter re-attaches its gradient), and a backward
        writes the new dtype."""
        had = self._nd._grad is not None
        with torch.no_grad():
            self._var.data = self._var.data.to(torch_dtype(dtype))
        self._nd._grad = NDArray(torch.zeros_like(self._var.data)) \
            if had else None

    def reset_ctx(self, ctx):
        from ..context import as_context
        with torch.no_grad():
            self._var.data = self._var.data.to(as_context(ctx).device)
        self._nd._grad = None

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, rng=None):
        """Fill the parameter from an initializer: its own ``init``
        first, then ``init``, then ``default_init`` (``Uniform()``), drawn
        from ``rng`` (a numpy ``RandomState``; default: one seeded from
        :func:`..random.numpy_rng`)."""
        from .. import random as _random
        if self._initialized and not force_reinit:
            return
        if ctx is not None:
            self.reset_ctx(ctx)
        rng = rng if rng is not None else _random.numpy_rng()
        if not self._shape_known():
            if not self.allow_deferred_init:
                raise MXNetError(
                    f"cannot initialize Parameter {self.name}: shape "
                    f"{self.shape} unknown; set allow_deferred_init=True "
                    "or provide in_units/in_channels")
            self._deferred_init = (init, default_init, rng)
            return
        self._fill(init, default_init, rng)

    def _fill(self, init, default_init, rng):
        from .. import initializer as _init
        initer = _init.create(self.init if self.init is not None
                              else init if init is not None
                              else default_init if default_init is not None
                              else _init.Uniform())
        self.set_data(initer(self.name, self.shape, rng))

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={_np.dtype(self.dtype).name})")


class Constant(Parameter):
    """A parameter that holds a fixed value and takes no gradient."""

    def __init__(self, name, value):
        if isinstance(value, NDArray):
            value = value.asnumpy()
        value = _np.asarray(value)
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, differentiable=False)
        self.value = value
        self.set_data(value)

    def initialize(self, *args, **kwargs):
        self.set_data(self.value)


class ParameterDict:
    """Ordered name -> Parameter mapping with a shared prefix."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key) -> Parameter:
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def get(self, name, **kwargs) -> Parameter:
        """Create or retrieve the parameter ``prefix + name``."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            param = Parameter(full, **kwargs)
            self._params[full] = param
        return param

    def get_constant(self, name, value=None) -> Constant:
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            if value is None:
                raise MXNetError(f"no constant named {full}")
            param = self._params[full] = Constant(full, value)
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared:
            self._params[name] = self._shared[name]
            return self._params[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate Parameter {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, seed=None):
        """Fill every parameter not yet initialized (all with
        ``force_reinit``), in order, from one numpy ``RandomState``:
        ``seed``'s, else one seeded from :func:`..random.numpy_rng`."""
        from .. import random as _random
        rng = _np.random.RandomState(int(seed)) if seed is not None \
            else _random.numpy_rng()
        for p in self.values():
            p.initialize(None, ctx, default_init=init,
                         force_reinit=force_reinit, rng=rng)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        from ..ndarray import utils as nd_utils
        arg_dict = {}
        for name, p in self.items():
            if not name.startswith(strip_prefix):
                raise MXNetError(f"Parameter {name} does not start with "
                                 f"prefix {strip_prefix}")
            arg_dict[name[len(strip_prefix):]] = p.data()
        nd_utils.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray import utils as nd_utils
        loaded = nd_utils.load(filename, ctx="cpu")
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError(
                        f"Parameter {name} missing in file {filename}")
        for name, v in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        f"Parameter {name} in file {filename} is not in "
                        "this ParameterDict")
                continue
            self._params[name].set_data(v)

    def __repr__(self):
        s = "\n".join(f"  {v}" for v in self.values())
        return f"ParameterDict(prefix={self._prefix!r}\n{s}\n)"
