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
``collect_params()``, ``block.params`` or ``block._reg_params``.  Shapes
are known at construction: deferred shape inference is not ported."""
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
    """Kept for the reference's API; the port never defers a shape."""


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
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        if var is None:
            if shape is None or any(int(s) <= 0 for s in shape):
                raise MXNetError(
                    f"Parameter {name}: shape {shape} is not known; "
                    "deferred shape inference is not ported")
            from ..context import resolve_device
            var = nn.Parameter(torch.zeros(tuple(shape),
                                           dtype=torch_dtype(dtype),
                                           device=resolve_device(None)))
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
        return tuple(self._var.shape)

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

    # -- access ---------------------------------------------------------
    def data(self, ctx=None) -> NDArray:
        """The parameter as an NDArray over the module's tensor."""
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
        """Change the parameter's dtype in place (its gradient buffer is
        reallocated at the next backward)."""
        with torch.no_grad():
            self._var.data = self._var.data.to(torch_dtype(dtype))
        self._nd._grad = None

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
        from .. import initializer as _init
        from .. import random as _random
        if self._initialized and not force_reinit:
            return
        if ctx is not None:
            self.reset_ctx(ctx)
        initer = _init.create(self.init if self.init is not None
                              else init if init is not None
                              else default_init if default_init is not None
                              else _init.Uniform())
        rng = rng if rng is not None else _random.numpy_rng()
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
