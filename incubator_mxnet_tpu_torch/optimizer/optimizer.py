"""Optimizers of the eager Gluon ``Trainer`` (counterpart of
``incubator_mxnet_tpu/optimizer/optimizer.py``): the ``Optimizer`` base
with the reference's bookkeeping (learning rate and schedule, per-index
lr/wd multipliers, ``rescale_grad``, ``clip_gradient``, per-index update
counts), ``register``/``create``, ``Updater``/``get_updater`` and
``Adam``, whose update is ``cores.prep_grad`` + ``cores.adam`` on the
tensors in place.  The reference's other optimizers are refused by name
until they are ported (ROADMAP Queue A item 11)."""
from __future__ import annotations

import math
import pickle

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from . import cores

__all__ = ["Optimizer", "Adam", "create", "register", "get_updater",
           "Updater"]

_REGISTRY = {}
# the JAX package's other optimizers, refused by name
_NOT_PORTED = ("sgd", "nag", "adamax", "nadam", "adagrad", "rmsprop",
               "adadelta", "ftrl", "ftml", "signum", "signsgd", "lamb",
               "lars", "adamw", "groupadagrad", "sgld", "dcasgd", "test")


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key in _NOT_PORTED:
        raise MXNetError(f"optimizer {name!r} is not ported yet (ROADMAP "
                         f"Queue A item 11); have {sorted(_REGISTRY)}")
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
        if multi_precision:
            raise MXNetError("multi_precision master weights are not "
                             "ported (bf16/fp16 training: ROADMAP Queue A "
                             "item 13)")
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
        self.multi_precision = False
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
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
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


def _zeros_like(weight: NDArray) -> NDArray:
    return NDArray(torch.zeros_like(weight._data, requires_grad=False))


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
        clip = self.clip_gradient
        with torch.no_grad():
            w = weight._data
            g = cores.prep_grad(grad._data, self.rescale_grad,
                                clip if clip is not None and clip > 0
                                else None, wd if wd else None, w)
            cores.adam(w, g, mean._data, var._data, lr, self.beta1,
                       self.beta2, self.epsilon)


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
