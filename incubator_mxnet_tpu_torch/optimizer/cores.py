"""Optimizer update cores (counterpart of
``incubator_mxnet_tpu/optimizer/cores.py``): the same formulas, evaluated
in the same order, as in-place updates of torch tensors.  Callers run them
under ``torch.no_grad()``.

Each torch op rounds to fp32 once, as each of the JAX package's eager
ops does; the whole-tree kernels K8-K10 (``optimizer/fused.py``) are held
bit for bit (LAMB: to its stated tolerance) to these loops.  A scalar
(``lr``, ``wd``, a bias-correction denominator) may be a Python number,
which torch rounds to fp32 once as JAX weak-types it, or a 0-d fp32
tensor on the leaves' device, as the train step passes it.

Square roots go through :func:`sqrt`: torch's fp32 ``sqrt`` on the CPU is
not correctly rounded (about 0.6 % of results are 1 ulp off), while
XLA's, numpy's and CUDA's are; so on the CPU it is taken in fp64 and
rounded once to fp32, which gives the correctly rounded value."""
from __future__ import annotations

import torch

__all__ = ["sqrt", "prep_grad", "sgd", "sgd_momentum", "nag_momentum",
           "moments", "adam", "adamw", "rmsprop", "adagrad", "lamb_direction",
           "lamb_apply"]


def sqrt(x):
    """The correctly rounded square root of a fp32 tensor on any
    device."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


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


def sgd(w, g, lr):
    """w = w - lr g (g prepped, wd folded)."""
    w.sub_(lr * g)
    return w


def sgd_momentum(w, g, m, lr, momentum):
    """m = momentum m - lr g; w = w + m."""
    m.mul_(momentum).sub_(lr * g)
    w.add_(m)
    return w, m


def nag_momentum(w, g, m, lr, momentum):
    """m = momentum m + g; w = w - lr (g + momentum m)."""
    m.mul_(momentum).add_(g)
    w.sub_(lr * (g + momentum * m))
    return w, m


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
    w.sub_(m * lr / (sqrt(v) + epsilon))
    return w, m, v


def adamw(w, g, m, v, lr, wd, beta1, beta2, epsilon, coef1, coef2):
    """AdamW (decoupled weight decay): ``coef1``/``coef2`` are the bias
    correction's denominators 1 - beta1^t and 1 - beta2^t;
    w -= lr (m / coef1 / (sqrt(v / coef2) + epsilon) + wd w)."""
    moments(m, v, g, beta1, beta2)
    w.sub_(lr * (m / coef1 / (sqrt(v / coef2) + epsilon) + wd * w))
    return w, m, v


def rmsprop(w, g, n, lr, gamma1, epsilon):
    """Non-centered RMSProp, epsilon inside the sqrt, wd folded into g:
    n = (1 - gamma1) g g + gamma1 n; w -= lr g / sqrt(n + epsilon)."""
    t = g * (1 - gamma1) * g
    n.mul_(gamma1).add_(t)
    w.sub_(lr * g / sqrt(n + epsilon))
    return w, n


def adagrad(w, g, h, lr, epsilon, wd):
    """AdaGrad, decoupled wd, epsilon inside the sqrt: h = h + g g;
    w -= lr (g / sqrt(h + epsilon) + wd w)."""
    h.add_(g * g)
    w.sub_(lr * (g / sqrt(h + epsilon) + wd * w))
    return w, h


def lamb_direction(w, g, m, v, beta1, beta2, epsilon, wd, coef1, coef2):
    """LAMB's first phase: the moments in place, then the update
    direction u = m / coef1 / (sqrt(v / coef2) + epsilon) + wd w (a new
    tensor).  Without bias correction the denominators are 1, and a
    division by 1 changes no bit."""
    moments(m, v, g, beta1, beta2)
    return m / coef1 / (sqrt(v / coef2) + epsilon) + wd * w


def lamb_apply(w, u, lr, lower_bound=None, upper_bound=None):
    """LAMB's second phase: r1 = ||w|| (clamped to each bound that is
    given and > 0, as the reference), r2 = ||u||, ratio r1 / r2 where
    both are > 0, else 1; w -= (lr ratio) u."""
    r1 = torch.linalg.vector_norm(w)
    r2 = torch.linalg.vector_norm(u)
    if lower_bound is not None and lower_bound > 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = torch.clamp(r1, max=upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                        torch.ones_like(r1))
    w.sub_(lr * ratio * u)
    return w
