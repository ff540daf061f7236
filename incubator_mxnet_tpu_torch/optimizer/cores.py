"""Optimizer update cores (counterpart of
``incubator_mxnet_tpu/optimizer/cores.py``): the same formulas, evaluated
in the same order, as in-place updates of torch tensors.  Callers run them
under ``torch.no_grad()``.  Only the Adam family's cores are ported."""
from __future__ import annotations

import torch

__all__ = ["prep_grad", "moments", "adam"]


def prep_grad(g, rescale_grad=None, clip_gradient=None, wd=None, w=None):
    """rescale -> clip -> fold wd * w into the gradient; ``None`` skips a
    stage.  Returns a new tensor (``g`` is left as it is)."""
    if rescale_grad is not None:
        g = g * rescale_grad
    if clip_gradient is not None:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if wd is not None and w is not None:
        g = g + wd * w
    return g


def moments(m, v, g, beta1, beta2):
    """Adam-family moment EMAs in place: m = beta1 m + (1 - beta1) g,
    v = beta2 v + (1 - beta2) g g."""
    m.mul_(beta1).add_(g * (1 - beta1))
    v.mul_(beta2).add_(g * (1 - beta2) * g)
    return m, v


def adam(w, g, m, v, lr, beta1, beta2, epsilon):
    """Adam in place: ``lr`` arrives pre-scaled by the bias correction
    sqrt(1 - beta2^t) / (1 - beta1^t), and wd is already folded into
    ``g`` by :func:`prep_grad`; w -= lr m / (sqrt(v) + epsilon)."""
    moments(m, v, g, beta1, beta2)
    w.sub_(m * lr / (torch.sqrt(v) + epsilon))
    return w, m, v
