"""Eager per-parameter optimizer ops (counterpart of
``incubator_mxnet_tpu/ndarray/optimizer_ops.py``): ``sgd_update``,
``sgd_mom_update``, ``nag_mom_update``, ``adam_update``,
``rmsprop_update``, ``rmspropalex_update``, ``ftrl_update``,
``signsgd_update``, ``signum_update``, ``lamb_update_phase1/2``,
``adagrad_update``, ``adadelta_update`` and ``sgld_update``.

Each writes the new weight into ``weight`` (or ``out``) and the new state
into its state arrays, in place, under ``torch.no_grad()``: the same terms
in the same order as the JAX ops, one rounding to the leaves' dtype per
op (16-bit leaves: each Python-number hyperparameter weak-typed to their
dtype, as jnp does), the shared rules through ``optimizer.cores``.
``lazy_update`` is accepted and, as for a dense gradient in the JAX
package, changes nothing (sparse gradients are not ported).  ``sgld_update`` draws its noise from the
port's per-device generator (``random.generator``), so its noise differs
from the JAX package's threefry stream.  The multi-precision ops
``mp_sgd_update``/``mp_sgd_mom_update`` update an fp32 master copy
(``weight32``) in fp32 from the gradient cast to fp32, and write the
low-precision weight rounded from it."""
from __future__ import annotations

import torch

from .ndarray import NDArray

__all__ = ["sgd_update", "sgd_mom_update", "nag_mom_update", "adam_update",
           "rmsprop_update", "rmspropalex_update", "ftrl_update",
           "signsgd_update", "signum_update", "mp_sgd_update",
           "mp_sgd_mom_update", "lamb_update_phase1", "lamb_update_phase2",
           "adagrad_update", "adadelta_update", "sgld_update"]


def _c():
    # the optimizer package imports this module's package
    from ..optimizer import cores
    return cores


def _clip(clip_gradient):
    return clip_gradient if clip_gradient is not None \
        and clip_gradient > 0 else None


def _prep_grad(g, rescale_grad, clip_gradient, wd=0.0, w=None):
    return _c().prep_grad(g, rescale_grad, _clip(clip_gradient),
                          wd if wd else None, w)


def _target(weight: NDArray, out) -> torch.Tensor:
    """The tensor the new weight is written into: ``weight``'s own, or
    ``out``'s holding a copy of the weight."""
    if out is None or out is weight:
        return weight._data
    return out._data.copy_(weight._data)


def _result(weight: NDArray, out):
    return weight if out is None else out


def _set(arr: NDArray, value: torch.Tensor) -> None:
    arr._data.copy_(value)


def sgd_update(weight: NDArray, grad: NDArray, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True, out=None):
    with torch.no_grad():
        g = _prep_grad(grad._data, rescale_grad, clip_gradient, wd,
                       weight._data)
        _c().sgd(_target(weight, out), g, lr)
    return _result(weight, out)


def sgd_mom_update(weight: NDArray, grad: NDArray, mom: NDArray, lr,
                   momentum=0.0, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True, out=None):
    with torch.no_grad():
        g = _prep_grad(grad._data, rescale_grad, clip_gradient, wd,
                       weight._data)
        _c().sgd_momentum(_target(weight, out), g, mom._data, lr, momentum)
    return _result(weight, out)


def nag_mom_update(weight: NDArray, grad: NDArray, mom: NDArray, lr,
                   momentum=0.0, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, out=None):
    """Nesterov momentum (the reference's nag_mom_update)."""
    with torch.no_grad():
        g = _prep_grad(grad._data, rescale_grad, clip_gradient, wd,
                       weight._data)
        _c().nag_momentum(_target(weight, out), g, mom._data, lr, momentum)
    return _result(weight, out)


def adam_update(weight: NDArray, grad: NDArray, mean: NDArray, var: NDArray,
                lr, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                out=None):
    """``lr`` pre-scaled by sqrt(1 - beta2^t) / (1 - beta1^t), as the
    ``Adam`` class passes it."""
    with torch.no_grad():
        g = _prep_grad(grad._data, rescale_grad, clip_gradient, wd,
                       weight._data)
        _c().adam(_target(weight, out), g, mean._data, var._data, lr, beta1,
                  beta2, epsilon)
    return _result(weight, out)


def rmsprop_update(weight: NDArray, grad: NDArray, n: NDArray, lr,
                   gamma1=0.95, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, clip_weights=-1.0, out=None):
    with torch.no_grad():
        g = _prep_grad(grad._data, rescale_grad, clip_gradient, wd,
                       weight._data)
        w = _target(weight, out)
        _c().rmsprop(w, g, n._data, lr, gamma1, epsilon)
        if clip_weights and clip_weights > 0:
            w.clamp_(-clip_weights, clip_weights)
    return _result(weight, out)


def rmspropalex_update(weight: NDArray, grad: NDArray, n: NDArray,
                       g_mean: NDArray, delta: NDArray, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0, out=None):
    """Centered RMSProp (Graves 2013; the reference's
    rmspropalex_update)."""
    with torch.no_grad():
        w = weight._data
        g = _prep_grad(grad._data, rescale_grad, clip_gradient, wd, w)
        nn, gm, d = n._data, g_mean._data, delta._data
        c = _c()
        new_n = c.add(c.mul(c.mul(1 - gamma1, g), g), c.mul(gamma1, nn))
        new_gm = c.add(c.mul(1 - gamma1, g), c.mul(gamma1, gm))
        new_d = c.sub(c.mul(gamma2, d), c.div(c.mul(lr, g), c.sqrt(
            c.add(c.sub(new_n, c.mul(new_gm, new_gm)), epsilon))))
        new_w = c.add(w, new_d)
        if clip_weights and clip_weights > 0:
            cw = c.weak(clip_weights, new_w.dtype)
            new_w = torch.clamp(new_w, -cw, cw)
        _set(n, new_n)
        _set(g_mean, new_gm)
        _set(delta, new_d)
        _target(weight, out).copy_(new_w)
    return _result(weight, out)


def ftrl_update(weight: NDArray, grad: NDArray, z: NDArray, n: NDArray, lr,
                lamda1=0.01, beta=1.0, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, out=None):
    with torch.no_grad():
        w = weight._data
        g = _prep_grad(grad._data, rescale_grad, clip_gradient)
        zz, nn = z._data, n._data
        c = _c()
        new_z = c.sub(c.add(zz, g), c.mul(c.div(c.sub(
            c.sqrt(c.add(nn, c.mul(g, g))), c.sqrt(nn)), lr), w))
        new_n = c.add(nn, c.mul(g, g))
        live = torch.abs(new_z) > c.weak(lamda1, new_z.dtype)
        new_w = c.mul(c.div(c.sub(c.mul(torch.sign(new_z), lamda1), new_z),
                            c.add(c.div(c.add(beta, c.sqrt(new_n)), lr),
                                  wd)), live.to(new_z.dtype))
        _set(z, new_z)
        _set(n, new_n)
        _target(weight, out).copy_(new_w)
    return _result(weight, out)


def signsgd_update(weight: NDArray, grad: NDArray, lr, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, out=None):
    with torch.no_grad():
        w = weight._data
        g = _prep_grad(grad._data, rescale_grad, clip_gradient)
        c = _c()
        new_w = c.sub(w, c.mul(lr, c.add(torch.sign(g), c.mul(wd, w))))
        _target(weight, out).copy_(new_w)
    return _result(weight, out)


def signum_update(weight: NDArray, grad: NDArray, mom: NDArray, lr,
                  momentum=0.0, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                  wd_lh=0.0, out=None):
    with torch.no_grad():
        w = weight._data
        g = _prep_grad(grad._data, rescale_grad, clip_gradient, wd, w)
        c = _c()
        new_m = c.sub(c.mul(momentum, mom._data), c.mul(1 - momentum, g))
        new_w = c.add(w, c.mul(lr, c.sub(torch.sign(new_m),
                                         c.mul(wd_lh, w))))
        _set(mom, new_m)
        _target(weight, out).copy_(new_w)
    return _result(weight, out)


def mp_sgd_update(weight: NDArray, grad: NDArray, weight32: NDArray, lr,
                  wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                  lazy_update=True, out=None):
    """Multi-precision SGD: the fp32 master ``weight32`` steps from the
    gradient in fp32; ``weight`` (or ``out``) takes the master rounded to
    its dtype."""
    with torch.no_grad():
        w32 = weight32._data
        g = _prep_grad(grad._data.to(torch.float32), rescale_grad,
                       clip_gradient, wd, w32)
        _c().sgd(w32, g, lr)
        _target(weight, out).copy_(w32)
    return _result(weight, out)


def mp_sgd_mom_update(weight: NDArray, grad: NDArray, mom: NDArray,
                      weight32: NDArray, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True, out=None):
    """Multi-precision SGD with momentum: the fp32 master and the fp32
    momentum step from the gradient in fp32; ``weight`` (or ``out``)
    takes the master rounded to its dtype."""
    with torch.no_grad():
        w32 = weight32._data
        g = _prep_grad(grad._data.to(torch.float32), rescale_grad,
                       clip_gradient, wd, w32)
        _c().sgd_momentum(w32, g, mom._data, lr, momentum)
        _target(weight, out).copy_(w32)
    return _result(weight, out)


def lamb_update_phase1(weight: NDArray, grad: NDArray, mean: NDArray,
                       var: NDArray, beta1=0.9, beta2=0.999, epsilon=1e-6,
                       t=1, bias_correction=True, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    """The moments in place; returns the update direction (a new
    NDArray)."""
    with torch.no_grad():
        g = _prep_grad(grad._data, rescale_grad, clip_gradient)
        w = weight._data
        # the denominators as device scalars: CUDA divides by a host
        # scalar as a multiply by its reciprocal
        coef1, coef2 = (torch.full((), c, dtype=torch.float32,
                                   device=w.device)
                        for c in ((1 - beta1 ** t, 1 - beta2 ** t)
                                  if bias_correction else (1.0, 1.0)))
        u = _c().lamb_direction(w, g, mean._data, var._data, beta1, beta2,
                                epsilon, wd, coef1, coef2)
    return NDArray(u)


def lamb_update_phase2(weight: NDArray, g: NDArray, r1: NDArray,
                       r2: NDArray, lr, lower_bound=-1.0, upper_bound=-1.0,
                       out=None):
    """The trust-ratio step: w -= lr ratio g, ratio = r1 / r2 (r1 clamped
    to the given bounds) where both are > 0, else 1."""
    with torch.no_grad():
        r1v, r2v = r1._data, r2._data
        if lower_bound and lower_bound > 0:
            r1v = torch.clamp(r1v, min=lower_bound)
        if upper_bound and upper_bound > 0:
            r1v = torch.clamp(r1v, max=upper_bound)
        c = _c()
        ratio = torch.where((r1v > 0) & (r2v > 0), c.div(r1v, r2v),
                            torch.ones_like(r1v))
        tgt = _target(weight, out)
        tgt.copy_(c.sub(tgt, c.mul(c.mul(lr, ratio), g._data)))
    return _result(weight, out)


def adagrad_update(weight: NDArray, grad: NDArray, history: NDArray, lr,
                   epsilon=1e-7, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, out=None):
    with torch.no_grad():
        g = _prep_grad(grad._data, rescale_grad, clip_gradient)
        _c().adagrad(_target(weight, out), g, history._data, lr, epsilon,
                     wd)
    return _result(weight, out)


def adadelta_update(weight: NDArray, grad: NDArray, acc_g: NDArray,
                    acc_delta: NDArray, rho=0.9, epsilon=1e-5, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, out=None):
    with torch.no_grad():
        w = weight._data
        g = _prep_grad(grad._data, rescale_grad, clip_gradient, wd, w)
        ag, ad = acc_g._data, acc_delta._data
        c = _c()
        new_ag = c.add(c.mul(rho, ag), c.mul(c.mul(1 - rho, g), g))
        delta = c.mul(c.div(c.sqrt(c.add(ad, epsilon)),
                            c.sqrt(c.add(new_ag, epsilon))), g)
        new_ad = c.add(c.mul(rho, ad), c.mul(c.mul(1 - rho, delta), delta))
        _set(acc_g, new_ag)
        _set(acc_delta, new_ad)
        tgt = _target(weight, out)
        tgt.copy_(c.sub(tgt, delta))
    return _result(weight, out)


def sgld_update(weight: NDArray, grad: NDArray, lr, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, out=None):
    """Stochastic Gradient Langevin Dynamics: w - lr/2 g + N(0, lr) noise
    drawn from the weight's device generator."""
    from .. import random as _random
    with torch.no_grad():
        w = weight._data
        g = _prep_grad(grad._data, rescale_grad, clip_gradient, wd, w)
        noise = torch.randn(w.shape, generator=_random.generator(w.device),
                            device=w.device, dtype=w.dtype) * \
            _c().sqrt(torch.tensor(lr, dtype=w.dtype, device=w.device))
        c = _c()
        new_w = c.add(c.sub(w, c.mul(lr / 2, g)), noise)
        _target(weight, out).copy_(new_w)
    return _result(weight, out)
