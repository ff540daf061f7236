"""Functional optimizers for the train step (counterpart of
``incubator_mxnet_tpu/parallel/optim.py``): ``sgd``, ``nag``, ``adam``,
``adamw``, ``rmsprop``, ``adagrad`` and ``lamb``.  ``init(params)`` builds
the state; ``update(params, grads, state, step)`` applies one step in
place, ``step`` 1-based, a 0-d int32 tensor on the device (the JAX
update's traced step); with ``nonfinite`` (``fused.all_finite``'s device
flag) a set flag skips the step (the gradients are zeroed, nothing else
is written), the guard of ``CompiledLoop(skip_nonfinite=True)``.

Every learning rate, bias correction and ``lr_schedule(step)`` is computed
on the device from the step tensor, as the JAX update computes them from
the traced step, so a CUDA graph of the step replays with each step's
values.  ``lr_schedule`` is a function of the step tensor that must return
a 0-d tensor on the step's device: a Python number would be frozen into a
captured graph at its capture-time value, so it raises
:class:`MXNetError`.  The updates are the whole-tree kernels of
``optimizer/fused.py``: K8 (adam), K9 (the elementwise rules) and K10
(lamb) on the card, the per-leaf loops on the CPU.

16-bit parameters (a cast net) take the JAX step's dtypes, rule by rule.
A hyperparameter the JAX update takes as a Python number (sgd's, nag's,
rmsprop's and adagrad's lr without a schedule) is weak-typed there: the
step stays in the parameters' dtype (the kernels' 16-bit instances).  A
fp32 value computed from the traced step (adam's bias-corrected lr_t,
adamw's and lamb's bias corrections, any ``lr_schedule``) promotes: the
first step writes fp32 values and keeps bf16 moments (the promoting
instance; ``update`` returns the new fp32 parameters, which the train step
puts into the net), and the next step, where JAX adds fp32 terms to the
bf16 moments, reads the moments as fp32 (exact) and is the fp32 step but
for the moments' decay constants, which JAX rounds to bf16
(``cores.moments``).  Both follow XLA's arithmetic in the JAX step
(``optimizer/cores.py``).  On a float16 net the promoting step raises
:class:`MXNetError` (``optimizer/fused.py`` ``_mode``).
``FunctionalOptimizer.promotes`` says whether a rule does this."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..base import MXNetError
from ..optimizer import cores, fused

__all__ = ["FunctionalOptimizer", "sgd", "nag", "adam", "adamw", "rmsprop",
           "adagrad", "lamb", "bias_corrected_lr", "scheduled_lr",
           "create"]


class FunctionalOptimizer(NamedTuple):
    """(init, update) pair; ``elementwise`` marks per-element rules (LAMB's
    per-leaf trust ratio is not); ``promotes`` marks rules whose fp32
    hyperparameters promote 16-bit parameters to fp32, as in the JAX
    step.  ``update(params, grads, state, step, nonfinite=None)`` returns
    (the new parameters, the new state): the same tensors, updated in
    place, where no dtype changes."""
    init: Any
    update: Any
    elementwise: bool = True
    promotes: bool = False


def scheduled_lr(learning_rate, step, lr_schedule=None) -> torch.Tensor:
    """The step's learning rate as a 0-d fp32 tensor on the step's device:
    ``lr_schedule(step)`` when a schedule is given (it must return a 0-d
    tensor on that device), else ``learning_rate`` rounded to fp32."""
    if lr_schedule is None:
        return torch.full((), float(learning_rate), dtype=torch.float32,
                          device=step.device)
    lr = lr_schedule(step)
    if not isinstance(lr, torch.Tensor) or lr.dim() != 0 \
            or lr.device != step.device or not lr.is_floating_point():
        got = (f"{lr.dtype} {tuple(lr.shape)} on {lr.device}"
               if isinstance(lr, torch.Tensor) else type(lr).__name__)
        raise MXNetError(
            f"lr_schedule(step) must return a 0-d floating tensor on the "
            f"step's device {step.device}, computed from the step tensor, "
            f"got {got}: a host number would be frozen into the captured "
            f"step at its capture-time value")
    return lr.to(torch.float32)


def _coefs(step, beta1, beta2):
    """(1 - beta1^t, 1 - beta2^t) in fp32 on the device."""
    t = step.to(torch.float32)
    return 1.0 - beta1 ** t, 1.0 - beta2 ** t


def bias_corrected_lr(learning_rate, beta1, beta2, step,
                      lr_schedule=None) -> torch.Tensor:
    """Adam's lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t) at the 0-d
    int32 ``step`` tensor, as a 0-d fp32 tensor on its device: computed
    in fp32 on the device, as the JAX update computes it from the traced
    step.  ``lr`` is ``lr_schedule(step)`` when a schedule is given."""
    lr = scheduled_lr(learning_rate, step, lr_schedule) \
        if lr_schedule is not None else learning_rate
    t = step.to(torch.float32)
    coef = cores.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
    return lr * coef


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def _follow(params, state):
    """The state slots read in their parameters' dtype, and the 16-bit
    dtype they had (None where they had the parameters'): after a
    promoting step the parameters are fp32 and the moments still bf16;
    JAX adds fp32 terms to them there, the port reads them as fp32
    (exact) once and runs the fp32 step with the decay constants the JAX
    step rounds to bf16 (``cores.moments``' ``moments_dtype``)."""
    was = None
    out = {}
    for k, leaves in state.items():
        out[k] = []
        for s, p in zip(leaves, params):
            if s.dtype != p.dtype:
                was = s.dtype
                s = s.to(p.dtype)
            out[k].append(s)
    return out, was


def sgd(learning_rate=0.01, momentum=0.0, wd=0.0, lr_schedule=None,
        rescale_grad=1.0, clip_gradient=None):
    """SGD, with momentum when ``momentum`` != 0 (state ``mom``): K9's
    ``sgd``/``sgd_mom`` instance."""

    def init(params):
        if momentum == 0.0:
            return {}
        return {"mom": _zeros(params)}

    def update(params, grads, state, step, nonfinite=None):
        hp = scheduled_lr(learning_rate, step, lr_schedule).reshape(1)
        state, was = _follow(params, state)
        rule, slots = ("sgd", []) if momentum == 0.0 \
            else ("sgd_mom", [state["mom"]])
        new = fused.multi_tensor_update(
            rule, params, grads, slots, hp, momentum=momentum,
            rescale=rescale_grad, clip=clip_gradient, wd=wd,
            nonfinite=nonfinite, promote=lr_schedule is not None)
        return new, state
    return FunctionalOptimizer(init, update,
                               promotes=lr_schedule is not None)


def nag(learning_rate=0.01, momentum=0.9, wd=0.0, lr_schedule=None,
        rescale_grad=1.0, clip_gradient=None):
    """Nesterov momentum SGD: K9's ``nag`` instance."""

    def init(params):
        return {"mom": _zeros(params)}

    def update(params, grads, state, step, nonfinite=None):
        hp = scheduled_lr(learning_rate, step, lr_schedule).reshape(1)
        state, was = _follow(params, state)
        new = fused.multi_tensor_update(
            "nag", params, grads, [state["mom"]], hp, momentum=momentum,
            rescale=rescale_grad, clip=clip_gradient, wd=wd,
            nonfinite=nonfinite, promote=lr_schedule is not None)
        return new, state
    return FunctionalOptimizer(init, update,
                               promotes=lr_schedule is not None)


def adam(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
         lr_schedule=None, rescale_grad=1.0, clip_gradient=None):
    """Adam as the JAX package's: wd folds into the gradient before the
    moments, and the bias correction folds into lr, computed in fp32 on
    the device from the step tensor.  The update is K8 on the card."""

    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(params, grads, state, step, nonfinite=None):
        lr_t = bias_corrected_lr(learning_rate, beta1, beta2, step,
                                 lr_schedule)
        state, was = _follow(params, state)
        new = fused.adam_update(params, grads, state["m"], state["v"], lr_t,
                                beta1, beta2, epsilon, rescale_grad,
                                clip_gradient, wd, nonfinite=nonfinite,
                                promote=True, moments_dtype=was)
        return new, state
    return FunctionalOptimizer(init, update, promotes=True)


def adamw(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
          wd=0.0, lr_schedule=None, rescale_grad=1.0, clip_gradient=None):
    """AdamW (decoupled weight decay): K9's ``adamw`` instance, with lr
    and the bias correction's denominators computed on the device."""

    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(params, grads, state, step, nonfinite=None):
        lr = scheduled_lr(learning_rate, step, lr_schedule)
        hp = torch.stack([lr, *_coefs(step, beta1, beta2)])
        state, was = _follow(params, state)
        new = fused.multi_tensor_update(
            "adamw", params, grads, [state["m"], state["v"]], hp,
            beta1=beta1, beta2=beta2, epsilon=epsilon, rescale=rescale_grad,
            clip=clip_gradient, wd=wd, nonfinite=nonfinite, promote=True,
            moments_dtype=was)
        return new, state
    return FunctionalOptimizer(init, update, promotes=True)


def rmsprop(learning_rate=0.001, gamma1=0.9, epsilon=1e-8, wd=0.0,
            lr_schedule=None, rescale_grad=1.0, clip_gradient=None):
    """Non-centered RMSProp: K9's ``rmsprop`` instance."""

    def init(params):
        return {"n": _zeros(params)}

    def update(params, grads, state, step, nonfinite=None):
        hp = scheduled_lr(learning_rate, step, lr_schedule).reshape(1)
        state, was = _follow(params, state)
        new = fused.multi_tensor_update(
            "rmsprop", params, grads, [state["n"]], hp, gamma1=gamma1,
            epsilon=epsilon, rescale=rescale_grad, clip=clip_gradient,
            wd=wd, nonfinite=nonfinite, promote=lr_schedule is not None)
        return new, state
    return FunctionalOptimizer(init, update,
                               promotes=lr_schedule is not None)


def adagrad(learning_rate=0.01, epsilon=1e-7, wd=0.0, lr_schedule=None,
            rescale_grad=1.0, clip_gradient=None):
    """AdaGrad (decoupled wd, epsilon inside the sqrt): K9's ``adagrad``
    instance."""

    def init(params):
        return {"h": _zeros(params)}

    def update(params, grads, state, step, nonfinite=None):
        hp = scheduled_lr(learning_rate, step, lr_schedule).reshape(1)
        state, was = _follow(params, state)
        new = fused.multi_tensor_update(
            "adagrad", params, grads, [state["h"]], hp, epsilon=epsilon,
            rescale=rescale_grad, clip=clip_gradient, wd=wd,
            nonfinite=nonfinite, promote=lr_schedule is not None)
        return new, state
    return FunctionalOptimizer(init, update,
                               promotes=lr_schedule is not None)


def lamb(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-6, wd=0.0,
         lr_schedule=None, rescale_grad=1.0, clip_gradient=None):
    """LAMB with the per-leaf trust ratio: K10, with lr and the bias
    correction's denominators computed on the device.  Not elementwise."""

    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(params, grads, state, step, nonfinite=None):
        lr = scheduled_lr(learning_rate, step, lr_schedule)
        hp = torch.stack([lr, *_coefs(step, beta1, beta2)])
        state, was = _follow(params, state)
        new = fused.lamb_update(params, grads, state["m"], state["v"], hp,
                                beta1, beta2, epsilon, rescale_grad,
                                clip_gradient, wd, nonfinite=nonfinite,
                                promote=True, moments_dtype=was)
        return new, state
    return FunctionalOptimizer(init, update, elementwise=False,
                               promotes=True)


_REGISTRY = {"sgd": sgd, "nag": nag, "adam": adam, "adamw": adamw,
             "rmsprop": rmsprop, "adagrad": adagrad, "lamb": lamb}


def create(name, **kwargs) -> FunctionalOptimizer:
    if isinstance(name, FunctionalOptimizer):
        return name
    if name not in _REGISTRY:
        raise MXNetError(f"unknown functional optimizer {name!r} "
                         f"(have {sorted(_REGISTRY)}); momentum= maps onto "
                         "sgd")
    if name == "sgd" and "momentum" not in kwargs:
        kwargs.setdefault("momentum", 0.0)
    return _REGISTRY[name](**kwargs)
