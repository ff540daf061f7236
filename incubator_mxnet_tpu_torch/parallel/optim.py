"""Functional optimizers for the train step (counterpart of
``incubator_mxnet_tpu/parallel/optim.py``).  ``init(params)`` builds the
state; ``update(params, grads, state, step)`` applies one step in place,
``step`` 1-based.  Only Adam is ported; :func:`create` refuses the other
rules."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..base import MXNetError
from ..optimizer import cores

__all__ = ["FunctionalOptimizer", "adam", "create"]


class FunctionalOptimizer(NamedTuple):
    """(init, update) pair; ``elementwise`` marks per-element rules."""
    init: Any
    update: Any
    elementwise: bool = True


def _prep(g, w, rescale_grad, clip_gradient, wd):
    """rescale -> clip -> fold wd, each stage decided statically."""
    return cores.prep_grad(
        g, rescale_grad if float(rescale_grad) != 1.0 else None,
        clip_gradient if clip_gradient else None, wd if wd else None, w)


def adam(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
         rescale_grad=1.0, clip_gradient=None):
    """Adam as the JAX package's: wd folds into the gradient before the
    moments, and the bias correction folds into lr, both computed in fp32
    as the compiled step computes them.  ``lr_schedule`` is not ported."""

    def init(params):
        return {"m": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params]}

    def update(params, grads, state, step):
        t = torch.tensor(float(step), dtype=torch.float32)
        coef = torch.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
        lr_t = float(torch.tensor(learning_rate, dtype=torch.float32) * coef)
        with torch.no_grad():
            for w, g, m, v in zip(params, grads, state["m"], state["v"]):
                cores.adam(w, _prep(g, w, rescale_grad, clip_gradient, wd),
                           m, v, lr_t, beta1, beta2, epsilon)
        return params, state
    return FunctionalOptimizer(init, update)


_REGISTRY = {"adam": adam}
# the JAX package's other rules, refused by name until they are ported
_NOT_PORTED = ("sgd", "nag", "adamw", "rmsprop", "adagrad", "lamb")


def create(name, **kwargs) -> FunctionalOptimizer:
    if isinstance(name, FunctionalOptimizer):
        return name
    if name in _NOT_PORTED:
        raise MXNetError(f"functional optimizer {name!r} is not ported "
                         f"yet; have {sorted(_REGISTRY)}")
    if name not in _REGISTRY:
        raise MXNetError(f"unknown functional optimizer {name!r} "
                         f"(have {sorted(_REGISTRY)})")
    return _REGISTRY[name](**kwargs)
