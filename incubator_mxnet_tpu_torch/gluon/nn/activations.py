"""Activation layers (counterpart of
``incubator_mxnet_tpu/gluon/nn/activations.py``): ``Activation``,
``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``Swish``, ``GELU``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...base import MXNetError
from ...ndarray import ops as _ops
from ..block import HybridBlock
from .basic_layers import _param

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


class Activation(HybridBlock):
    """MXNet's ``Activation`` op as a layer; its prefix is the
    activation's name (``relu0_``), as in the reference."""

    def __init__(self, activation, prefix=None, params=None):
        if activation not in _ops.ACTIVATIONS:
            raise MXNetError(f"Activation: unknown act_type {activation}")
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _name_hint(self):
        return self._act_type

    def forward(self, x):
        return _ops.ACTIVATIONS[self._act_type](x)

    def __repr__(self):
        return f"Activation({self._act_type})"


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return torch.where(x > 0, x, self._alpha * x)


class PReLU(HybridBlock):
    """``max(x, 0) + alpha * min(x, 0)`` with a learned ``alpha`` (one
    value, initialised to 0.25)."""

    def __init__(self, alpha_initializer=None, device=None, prefix=None,
                 params=None):
        from ... import initializer as _init
        super().__init__(prefix=prefix, params=params)
        self.alpha = _param((1,), device,
                            alpha_initializer or _init.Constant(0.25))

    def forward(self, x):
        return torch.clamp_min(x, 0) + self.alpha * torch.clamp_max(x, 0)


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return torch.where(x > 0, x, self._alpha * torch.expm1(x))


class SELU(HybridBlock):
    def forward(self, x):
        return F.selu(x)


class Swish(HybridBlock):
    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)


class GELU(HybridBlock):
    def forward(self, x):
        return F.gelu(x, approximate="none")
