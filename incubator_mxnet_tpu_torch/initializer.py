"""Weight initializers (counterpart of ``incubator_mxnet_tpu/initializer.py``
with ``random.py``'s seeding).

Values are drawn on the host from a numpy ``RandomState(seed)`` passed in
explicitly, in MXNet ``collect_params()`` order, and copied to the
parameters' device — so one seed gives the same weights on the CPU and on
the card.  Dispatch by name suffix follows MXNet: ``*bias`` and ``*beta``
are zeros, ``*gamma`` ones, everything else goes to ``_init_weight``.  A
parameter with its own initializer (an ``mx_init`` attribute, MXNet's
``Parameter.init``) takes that one instead of the one passed in."""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .gluon.nn.basic_layers import mx_named_parameters

__all__ = ["Initializer", "Zero", "One", "Constant", "Normal", "Uniform",
           "create", "initialize"]


class Initializer:
    """Base initializer; subclasses implement ``_init_weight``."""

    def __call__(self, name: str, shape, rng: _np.random.RandomState):
        if name.endswith("bias") or name.endswith("beta"):
            return _np.zeros(shape, _np.float32)
        if name.endswith("gamma"):
            return _np.ones(shape, _np.float32)
        return _np.asarray(self._init_weight(shape, rng), _np.float32)

    def _init_weight(self, shape, rng):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class Zero(Initializer):
    def _init_weight(self, shape, rng):
        return _np.zeros(shape)


class One(Initializer):
    def _init_weight(self, shape, rng):
        return _np.ones(shape)


class Constant(Initializer):
    """Every element ``value`` (bias and gamma included)."""

    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, name, shape, rng):
        return _np.full(shape, self.value, _np.float32)

    def __repr__(self):
        return f"Constant(value={self.value})"


class Normal(Initializer):
    """N(0, sigma^2) weights."""

    def __init__(self, sigma=0.01):
        self.sigma = float(sigma)

    def _init_weight(self, shape, rng):
        return rng.normal(0.0, self.sigma, shape)

    def __repr__(self):
        return f"Normal(sigma={self.sigma})"


class Uniform(Initializer):
    """U(-scale, scale) weights."""

    def __init__(self, scale=0.07):
        self.scale = float(scale)

    def _init_weight(self, shape, rng):
        return rng.uniform(-self.scale, self.scale, shape)

    def __repr__(self):
        return f"Uniform(scale={self.scale})"


_BY_NAME = {"zeros": Zero, "zero": Zero, "ones": One, "one": One,
            "normal": Normal, "uniform": Uniform}


def create(init) -> Initializer:
    """An initializer from an instance or its name (``"zeros"``,
    ``"ones"``, ``"normal"``, ``"uniform"``)."""
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str) and init.lower() in _BY_NAME:
        return _BY_NAME[init.lower()]()
    raise MXNetError(f"unknown initializer {init!r}")


def initialize(module: torch.nn.Module, init: Initializer, seed: int):
    """Fill every parameter of ``module`` from ``RandomState(seed)``."""
    if not isinstance(init, Initializer):
        raise MXNetError(f"initialize needs an Initializer, got {init!r}")
    rng = _np.random.RandomState(int(seed))
    with torch.no_grad():
        for name, p in mx_named_parameters(module):
            val = getattr(p, "mx_init", init)(name, tuple(p.shape), rng)
            p.copy_(torch.from_numpy(val))
    return module
