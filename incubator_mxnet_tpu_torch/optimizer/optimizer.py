"""Optimizers of the eager Gluon ``Trainer`` (counterpart of
``incubator_mxnet_tpu/optimizer/optimizer.py``): the ``Optimizer`` base
with the reference's bookkeeping (learning rate and schedule, per-index
lr/wd multipliers, ``rescale_grad``, ``clip_gradient``, per-index update
counts), ``register``/``create``, ``Updater``/``get_updater`` and every
optimizer the JAX package registers: ``SGD``, ``NAG``, ``Adam``,
``Adamax``, ``Nadam``, ``AdaGrad``, ``RMSProp``, ``AdaDelta``, ``Ftrl``,
``Signum`` (also ``SignSGD``), ``LAMB``, ``SGLD``, ``DCASGD``, ``FTML``,
``LARS``, ``GroupAdaGrad``, ``AdamW`` and ``Test``.  Each update is the
JAX class's, term for term, on the tensors in place (through the ops of
``ndarray/optimizer_ops.py`` where the JAX class uses them).  Host
arithmetic (bias corrections, Nadam's schedule) is in Python doubles, as
there.  ``multi_precision=True`` keeps fp32 master weights for fp16
parameters, as the JAX package's (fp16 only): the state is (master, inner
state), the update runs in fp32 on the master and writes the fp16 weight
from it; SGD takes the ``mp_sgd_update``/``mp_sgd_mom_update`` ops."""
from __future__ import annotations

import math
import pickle

import numpy as _np

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..ndarray import optimizer_ops as _oo
from . import cores

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "Adamax", "Nadam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "FTML", "Signum", "SignSGD",
           "LAMB", "LARS", "AdamW", "GroupAdaGrad", "SGLD", "DCASGD", "Test",
           "create", "register", "get_updater", "Updater"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise MXNetError(f"unknown optimizer {name!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


class Optimizer:
    """Base optimizer.  State is created per parameter index;
    ``update(index, weight, grad, state)`` applies one step in place."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}

    create_optimizer = staticmethod(create)

    def __getstate__(self):
        # the Parameters are the Trainer's, re-attached after a load
        state = dict(self.__dict__)
        state["param_dict"] = {}
        return state

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision`` and an fp16 weight: (its fp32 master
        copy, the rule's state for the master); else the rule's state."""
        if self.multi_precision and weight.dtype == _np.float16:
            w32 = NDArray(weight._data.detach().to(torch.float32))
            return (w32, self.create_state(index, w32))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """With ``multi_precision`` and an fp16 weight: the update on the
        fp32 master with the gradient in fp32, then the fp16 weight
        rounded from the master; else :meth:`update`."""
        if self.multi_precision and weight.dtype == _np.float16:
            w32, inner = state
            self.update(index, w32, NDArray(grad._data.to(torch.float32)),
                        inner)
            with torch.no_grad():
                weight._data.copy_(w32._data)
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; cannot set lr directly")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith("_weight")}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.learning_rate
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            lr *= self.param_dict[name].lr_mult
        elif name in self.lr_mult:
            lr *= self.lr_mult[name]
        return lr

    def _get_wd(self, index):
        wd = self.wd
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            wd *= self.param_dict[name].wd_mult
        elif name in self.wd_mult:
            wd *= self.wd_mult[name]
        return wd

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.learning_rate})"


def _zeros_like(weight: NDArray, dtype=None) -> NDArray:
    return NDArray(torch.zeros_like(weight._data, dtype=dtype,
                                    requires_grad=False))


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """The Python number ``x`` as a 0-d tensor on ``like``'s device: a
    divisor there, typed as JAX types a weak constant beside ``like``
    (fp32, or ``like``'s 16-bit dtype, rounded through fp32: no
    promotion, as the fused update's ``_hp``).  (CUDA divides by a host
    scalar as a multiply by its reciprocal, which is not the true
    division the reference and the kernels do.)"""
    t = torch.full((), x, dtype=torch.float32, device=like.device)
    return t.to(like.dtype) if like.dtype in cores.HALF else t


def _clip(g, clip_gradient):
    if clip_gradient:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register
class SGD(Optimizer):
    """mom = momentum mom - lr (grad + wd w); w += mom (plain SGD with
    momentum 0).  ``lazy_update`` is accepted; with dense gradients it
    changes nothing, as in the JAX package."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient or -1.0)
        if state is not None:
            _oo.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                               lazy_update=self.lazy_update, **kw)
        else:
            _oo.sgd_update(weight, grad, lazy_update=self.lazy_update, **kw)

    def update_multi_precision(self, index, weight, grad, state):
        """fp16 with ``multi_precision``: the reference's mp_sgd ops (the
        count advances after lr and wd are read, as there)."""
        if self.multi_precision and weight.dtype == _np.float16:
            w32, mom = state
            lr, wd = self._get_lr(index), self._get_wd(index)
            self._update_count(index)
            kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                      clip_gradient=self.clip_gradient or -1.0)
            if mom is not None:
                _oo.mp_sgd_mom_update(weight, grad, mom, w32,
                                      momentum=self.momentum, **kw)
            else:
                _oo.mp_sgd_update(weight, grad, w32, **kw)
        else:
            self.update(index, weight, grad, state)


@register
class NAG(SGD):
    """Nesterov accelerated SGD."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient or -1.0)
        if state is not None:
            _oo.nag_mom_update(weight, grad, state, momentum=self.momentum,
                               **kw)
        else:
            _oo.sgd_update(weight, grad, **kw)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the learning rate in
    Python doubles (lr * sqrt(1 - beta2^t) / (1 - beta1^t)) and weight
    decay folded into the gradient, as the reference's ``adam_update``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def bias_corrected_lr(self, index) -> float:
        """The step's lr for ``index`` (its count already advanced)."""
        t = self._index_update_count[index]
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        return self._get_lr(index) * (math.sqrt(coef2) / coef1)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self.bias_corrected_lr(index), self._get_wd(index)
        mean, var = state
        _oo.adam_update(weight, grad, mean, var, lr=lr, beta1=self.beta1,
                        beta2=self.beta2, epsilon=self.epsilon, wd=wd,
                        rescale_grad=self.rescale_grad,
                        clip_gradient=self.clip_gradient or -1.0,
                        lazy_update=self.lazy_update)


@register
class Adamax(Optimizer):
    """Adamax (the infinity-norm Adam)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr /= (1. - self.beta1 ** t)
        m, u = state
        with torch.no_grad():
            w = weight._data
            g = _clip(grad._data * self.rescale_grad + wd * w,
                      self.clip_gradient)
            new_m = self.beta1 * m._data + (1 - self.beta1) * g
            new_u = torch.maximum(self.beta2 * u._data, torch.abs(g))
            m._data.copy_(new_m)
            u._data.copy_(new_u)
            w.sub_(lr * new_m / (new_u + 1e-8))


@register
class Nadam(Optimizer):
    """Nadam (Adam with Nesterov's momentum schedule)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        momentum_t = self.beta1 * (1. - 0.5 * 0.96 **
                                   (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1. - 0.5 * 0.96 **
                                     ((t + 1) * self.schedule_decay))
        self.m_schedule *= momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        with torch.no_grad():
            w = weight._data
            g = _clip(grad._data * self.rescale_grad + wd * w,
                      self.clip_gradient)
            grad_prime = g / (1. - self.m_schedule)
            new_m = self.beta1 * m._data + (1. - self.beta1) * g
            new_v = self.beta2 * v._data + (1. - self.beta2) * g * g
            m_t_prime = new_m / (1. - m_schedule_next)
            v_t_prime = new_v / (1. - self.beta2 ** t)
            m_t_bar = (1. - momentum_t) * grad_prime + \
                momentum_t_1 * m_t_prime
            m._data.copy_(new_m)
            v._data.copy_(new_v)
            w.sub_(lr * m_t_bar / (cores.sqrt(v_t_prime) + self.epsilon))


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        _oo.adagrad_update(weight, grad, state, lr=lr,
                           epsilon=self.float_stable_eps, wd=wd,
                           rescale_grad=self.rescale_grad,
                           clip_gradient=self.clip_gradient or -1.0)


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered`` is Graves' variant; ``clip_weights`` clamps
    the new weight."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(lr=lr, gamma1=self.gamma1, epsilon=self.epsilon, wd=wd,
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient or -1.0,
                  clip_weights=self.clip_weights or -1.0)
        if self.centered:
            n, g_mean, delta = state
            _oo.rmspropalex_update(weight, grad, n, g_mean, delta,
                                   gamma2=self.gamma2, **kw)
        else:
            _oo.rmsprop_update(weight, grad, state, **kw)


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        acc_g, acc_delta = state
        _oo.adadelta_update(weight, grad, acc_g, acc_delta, rho=self.rho,
                            epsilon=self.epsilon, wd=wd,
                            rescale_grad=self.rescale_grad,
                            clip_gradient=self.clip_gradient or -1.0)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))   # z, n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        z, n = state
        _oo.ftrl_update(weight, grad, z, n, lr=lr, lamda1=self.lamda1,
                        beta=self.beta, wd=wd,
                        rescale_grad=self.rescale_grad,
                        clip_gradient=self.clip_gradient or -1.0)


@register
class Signum(Optimizer):
    """Signum; with momentum 0 it is signSGD."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient or -1.0)
        if state is not None:
            _oo.signum_update(weight, grad, state, momentum=self.momentum,
                              wd_lh=self.wd_lh, **kw)
        else:
            _oo.signsgd_update(weight, grad, **kw)


SignSGD = Signum
# the class alias resolves by name too (the JAX registry has "signum" only)
_REGISTRY["signsgd"] = Signum


@register
class LAMB(Optimizer):
    """LAMB: the layer-wise trust ratio over an Adam direction, with
    optional bounds on ||w|| and optional bias correction."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros_like(weight, torch.float32),
                _zeros_like(weight, torch.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        mean, var = state
        g = _oo.lamb_update_phase1(
            weight, grad, mean, var, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, t=t, bias_correction=self.bias_correction,
            wd=wd, rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient or -1.0)
        with torch.no_grad():
            r1 = NDArray(torch.linalg.vector_norm(weight._data))
            r2 = NDArray(torch.linalg.vector_norm(g._data))
        _oo.lamb_update_phase2(weight, g, r1, r2, lr=lr,
                               lower_bound=self.lower_bound or -1.0,
                               upper_bound=self.upper_bound or -1.0)


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (its noise from the port's
    device generator)."""

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        _oo.sgld_update(weight, grad, lr=lr, wd=wd,
                        rescale_grad=self.rescale_grad,
                        clip_gradient=self.clip_gradient or -1.0)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD, kept for the API (one device
    has no delay to compensate)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_zeros_like(weight), weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, prev = state
        with torch.no_grad():
            w = weight._data
            g = _clip(grad._data * self.rescale_grad, self.clip_gradient)
            d = -lr * (g + wd * w + self.lamda * g * g * (w - prev._data))
            if mom is not None:
                new_mom = self.momentum * mom._data + d
                mom._data.copy_(new_mom)
                d = new_mom
            prev._data.copy_(w)
            w.add_(d)


@register
class FTML(Optimizer):
    """Follow The Moving Leader (Zheng & Kwok 2017)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))           # d, v, z

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        d, v, z = state
        with torch.no_grad():
            w = weight._data
            g = _clip(grad._data * self.rescale_grad, self.clip_gradient)
            g = g + wd * w
            v_t = self.beta2 * v._data + (1 - self.beta2) * g * g
            d_t = (1 - self.beta1 ** t) / lr * (
                cores.sqrt(v_t / (1 - self.beta2 ** t)) + self.epsilon)
            sigma = d_t - self.beta1 * d._data
            z_t = self.beta1 * z._data + (1 - self.beta1) * g - sigma * w
            d._data.copy_(d_t)
            v._data.copy_(v_t)
            z._data.copy_(z_t)
            w.copy_(-z_t / d_t)


@register
class LARS(Optimizer):
    """Layer-wise Adaptive Rate Scaling SGD (You et al. 2017): the trust
    ratio eta ||w|| / (||g|| + wd ||w|| + epsilon) scales lr before a
    momentum-SGD step."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            w = weight._data
            g = _clip(grad._data * self.rescale_grad, self.clip_gradient)
            w_norm = torch.linalg.vector_norm(w)
            g_norm = torch.linalg.vector_norm(g)
            ratio = torch.where(
                (w_norm > 0) & (g_norm > 0),
                self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon),
                torch.ones_like(w_norm))
            step = (lr * ratio) * (g + wd * w)
            if state is not None:
                m_t = self.momentum * state._data + step
                state._data.copy_(m_t)
                w.sub_(m_t)
            else:
                w.sub_(step)


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one accumulated scalar per row: history[i] +=
    mean(grad[i]^2); w[i] -= lr g[i] / sqrt(history[i] + eps)."""

    def __init__(self, learning_rate=0.01, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        shape = (weight.shape[0],) + (1,) * (len(weight.shape) - 1)
        return NDArray(torch.zeros(shape, dtype=weight._data.dtype,
                                   device=weight._data.device))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        if self._get_wd(index):
            raise MXNetError("GroupAdaGrad does not support weight decay "
                             "(reference parity)")
        with torch.no_grad():
            g = _clip(grad._data * self.rescale_grad, self.clip_gradient)
            dims = tuple(range(1, g.dim()))
            hist = state._data + torch.mean(g * g, dim=dims, keepdim=True) \
                if dims else state._data + g * g
            state._data.copy_(hist)
            weight._data.sub_(lr * g / cores.sqrt(hist + self.epsilon))


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (Loshchilov & Hutter 2019)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        coef1, coef2 = 1 - self.beta1 ** t, 1 - self.beta2 ** t
        mean, var = state
        with torch.no_grad():
            w = weight._data
            g = _clip(grad._data * self.rescale_grad, self.clip_gradient)
            cores.adamw(w, g, mean._data, var._data, lr, wd, self.beta1,
                        self.beta2, self.epsilon, _scalar(coef1, w),
                        _scalar(coef2, w))


@register
class Test(Optimizer):
    """w -= lr grad rescaled (the reference's unit-test optimizer)."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight._data.sub_(self.lr * grad._data * self.rescale_grad)


class Updater:
    """Applies an optimizer per index, creating each index's state at its
    first update."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer)
                            if dump_optimizer else self.states)

    def set_states(self, states):
        obj = pickle.loads(states)
        if isinstance(obj, tuple):
            self.states, self.optimizer = obj
        else:
            self.states = obj


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
