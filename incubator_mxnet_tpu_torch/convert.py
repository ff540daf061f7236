"""Weights from the JAX package into the port.

``params`` is a ``{name: numpy array}`` dict keyed by the JAX package's own
parameter names — ``net.collect_params()`` keys with the model's prefix
stripped, e.g. ``embedding0_weight`` or
``gptcell0_multiheadattention0_dense0_weight``; a ``BERTForPretrain``'s
heads are ``dense0_weight`` ... and its encoder ``bertmodel0_...`` (JAX
builds the encoder outside the heads' name scope, so only the heads carry
the ``bertforpretrain0_`` prefix to strip).  The port's modules carry
the same names (:func:`.gluon.nn.mx_named_parameters`), so after
:func:`load_jax_params` both packages compute the same function.  Every
``nn.Parameter`` of the model is carried, the normalisation layers'
``gamma``, ``beta``, ``running_mean`` and ``running_var`` among them; a
block with deferred shapes (``Dense(in_units=0)``) takes its arrays once
its first forward has settled them."""
from __future__ import annotations

from typing import Mapping

import numpy as _np
import torch

from .base import MXNetError
from .gluon.nn import mx_named_parameters

__all__ = ["load_jax_params", "mx_param_names"]


def mx_param_names(model: torch.nn.Module):
    """The port model's parameter names, in MXNet ``collect_params()``
    order."""
    return [name for name, _ in mx_named_parameters(model)]


def load_jax_params(model: torch.nn.Module, params: Mapping[str, object]):
    """Copy every array of ``params`` into the same-named parameter of
    ``model``.  Raises :class:`MXNetError` on a name that is unmatched in
    either direction or on a shape mismatch; nothing is copied then."""
    named = dict(mx_named_parameters(model))
    missing = sorted(set(named) - set(params))
    unknown = sorted(set(params) - set(named))
    if missing or unknown:
        raise MXNetError(
            f"load_jax_params: names do not match — missing from params: "
            f"{missing}; not in the model: {unknown}")
    arrays = {}
    for name, p in named.items():
        a = _np.asarray(params[name], dtype=_np.float32)
        if getattr(p, "mx_deferred", False) and 0 in tuple(p.shape):
            raise MXNetError(
                f"load_jax_params: {name}'s shape waits for the model's "
                f"first forward ({tuple(p.shape)}); run one, then load")
        if tuple(a.shape) != tuple(p.shape):
            raise MXNetError(f"load_jax_params: {name} has shape "
                             f"{tuple(a.shape)}, the model expects "
                             f"{tuple(p.shape)}")
        arrays[name] = a
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(torch.tensor(arrays[name]))
    return model
