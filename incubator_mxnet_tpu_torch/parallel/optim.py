"""Functional optimizers for the train step (counterpart of
``incubator_mxnet_tpu/parallel/optim.py``).  ``init(params)`` builds the
state; ``update(params, grads, state, step)`` applies one step in place,
``step`` 1-based, a 0-d int32 tensor on the device (the JAX update's
traced step).  Only Adam is ported; :func:`create` refuses the other
rules."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..base import MXNetError
from ..optimizer import fused

__all__ = ["FunctionalOptimizer", "adam", "bias_corrected_lr", "create"]


class FunctionalOptimizer(NamedTuple):
    """(init, update) pair; ``elementwise`` marks per-element rules."""
    init: Any
    update: Any
    elementwise: bool = True


def bias_corrected_lr(learning_rate, beta1, beta2, step,
                      lr_schedule=None) -> torch.Tensor:
    """Adam's lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t) at the 0-d
    int32 ``step`` tensor, as a 0-d fp32 tensor on its device: computed
    in fp32 on the device, as the JAX update computes it from the traced
    step, so a CUDA graph replays it with each step's value.  ``lr`` is
    ``lr_schedule(step)`` when a schedule is given."""
    lr = lr_schedule(step) if lr_schedule is not None else learning_rate
    t = step.to(torch.float32)
    coef = torch.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
    return lr * coef


def adam(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
         lr_schedule=None, rescale_grad=1.0, clip_gradient=None):
    """Adam as the JAX package's: wd folds into the gradient before the
    moments, and the bias correction folds into lr, computed in fp32 on
    the device from the step tensor.  ``lr_schedule``, when given, is a
    callable of the 0-d int32 step tensor that returns the learning rate
    as a 0-d fp32 tensor on its device (JAX's is a callable of the traced
    step).  The update is :func:`..optimizer.fused.adam_update`: one
    launch of kernel K8 over every leaf on the card, the per-leaf loop on
    the CPU."""

    def init(params):
        return {"m": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params]}

    def update(params, grads, state, step):
        """One step in place; ``step`` the 1-based step count, a 0-d
        int32 tensor on the parameters' device."""
        lr_t = bias_corrected_lr(learning_rate, beta1, beta2, step,
                                 lr_schedule)
        fused.adam_update(params, grads, state["m"], state["v"], lr_t,
                          beta1, beta2, epsilon, rescale_grad,
                          clip_gradient, wd)
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
