"""The whole-tree optimizer update (counterpart of
``incubator_mxnet_tpu/optimizer/fused.py``, whose one donated ``jax.jit``
program updates every parameter in one dispatch).

Three updates apply one step of a rule to every leaf of a parameter list
in place, each with two versions, chosen by where the tensors lie:

* :func:`adam_update` (Adam): kernel K8 ``kernels/csrc/
  multi_tensor_adam.cu``;
* :func:`multi_tensor_update` (sgd, sgd with momentum, nag, adamw,
  rmsprop, adagrad): kernel K9 ``kernels/csrc/multi_tensor_update.cu``,
  the rule a template parameter;
* :func:`lamb_update` (LAMB): kernel K10 ``kernels/csrc/
  multi_tensor_lamb.cu``, two launches (the moments and the per-chunk
  norm partials, then the per-leaf trust ratio and the weights).

The plain version of each, the per-leaf loop of ``optimizer/cores.py``,
runs on CPU tensors (and is the reference a kernel is held to: K8 and K9
bit for bit, K10 within its tolerance, its norms being sums in another
order).  On CUDA tensors the kernel runs or the call raises; there is no
fallback.  Each kernel call adds the launches it made to
``launch_counts[<kernel>]`` (one per 512 leaves; K10 two).  The
learning rate (and AdamW's and LAMB's bias-correction denominators) is
read from device memory, so a CUDA graph that computes it from the step on
the device replays with each step's value.

:func:`all_finite` is the ``skip_nonfinite`` guard's check: one launch
of K8's source's all-finite kernel over every gradient leaf on the card,
which sets a device flag that a guarded update of any of the three reads
before any write (no host sync); a per-leaf ``isfinite().all()`` loop on
the CPU.

:class:`FusedUpdater` is the Gluon ``Trainer``'s whole-tree update (the
JAX package's, without ZeRO-1) for the seven rules the JAX package fuses,
with the health plane's per-leaf stats around it under
``MXNET_HEALTH_PLANE=1`` (``health.StepStats``; the weights come out bit
for bit as with the plane off);
:func:`functional_twin` maps an eager optimizer onto its
``parallel.optim`` rule."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from ..base import MXNetError
from .. import health as _health
from ..kernels import _build
from ..kernels.flash_attention import launched as _launched
from .. import telemetry as _telemetry
from . import cores
from .optimizer import (NAG, SGD, AdaGrad, Adam, AdamW, LAMB, RMSProp)

__all__ = ["adam_update", "multi_tensor_update", "lamb_update",
           "all_finite", "FusedUpdater", "functional_twin"]

# the rules the whole-tree update takes, by exact type (NAG subclasses
# SGD with another rule); any other optimizer runs the per-parameter loop
_RULES = {SGD: "sgd", NAG: "nag", Adam: "adam", AdamW: "adamw",
          RMSProp: "rmsprop", AdaGrad: "adagrad", LAMB: "lamb"}

_RESCALE, _CLIP, _WD = 1, 2, 4     # the kernels' stage flags
_CHUNK = 16384                     # elements per block of K8-K10


def _stages(rescale, clip, wd):
    """(rescale, clip, wd), each None where ``parallel.optim._prep`` skips
    the stage: rescale 1, clip None or 0, wd 0."""
    return (rescale if float(rescale) != 1.0 else None,
            clip if clip else None, wd if wd else None)


def _plain_adam_update(params, grads, ms, vs, lr_t, beta1, beta2, epsilon,
                       rescale, clip, wd, nonfinite=None):
    r, c, d = _stages(rescale, clip, wd)
    with torch.no_grad():
        if nonfinite is not None and bool(nonfinite):
            for g in grads:
                g.zero_()
            return
        for w, g, m, v in zip(params, grads, ms, vs):
            cores.adam(w, cores.prep_grad(g, r, c, d, w), m, v, lr_t,
                       beta1, beta2, epsilon)


def _check_tree(what, dev, params, grads, states):
    for i, leaf in enumerate(zip(params, grads, *states)):
        shape = leaf[0].shape
        for t in leaf:
            if t.device != dev or t.dtype != torch.float32 \
                    or not t.is_contiguous() or t.shape != shape:
                raise MXNetError(
                    f"{what}: leaf {i} must be contiguous fp32 tensors of "
                    f"shape {tuple(shape)} on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")


def _check_flag(dev, flag):
    if flag.device != dev or flag.dtype != torch.int32 or flag.numel() != 1:
        raise MXNetError(f"the nonfinite flag must be one int32 on {dev}, "
                         f"got {flag.dtype} {tuple(flag.shape)} on "
                         f"{flag.device}")


def _multi_tensor_adam_cuda(params, grads, ms, vs, lr_t, beta1, beta2,
                            epsilon, rescale, clip, wd, nonfinite=None):
    dev = params[0].device
    _check_tree("multi_tensor_adam", dev, params, grads, (ms, vs))
    if lr_t.device != dev or lr_t.dtype != torch.float32 or lr_t.dim():
        raise MXNetError(f"multi_tensor_adam: lr_t must be a 0-d fp32 "
                         f"tensor on {dev}, got {lr_t.dtype} "
                         f"{tuple(lr_t.shape)} on {lr_t.device}")
    if nonfinite is not None:
        _check_flag(dev, nonfinite)
    r, c, d = _stages(rescale, clip, wd)
    flags = (_RESCALE if r is not None else 0) \
        | (_CLIP if c is not None else 0) | (_WD if d is not None else 0)
    # (w, g, m, v, numel) per leaf; the entry point reads it before it
    # returns (the launch carries the table as its parameter)
    table = _np.array([(w.data_ptr(), g.data_ptr(), m.data_ptr(),
                        v.data_ptr(), w.numel())
                       for w, g, m, v in zip(params, grads, ms, vs)],
                      dtype=_np.int64).reshape(-1, 5)
    lib = _build.library("multi_tensor_adam")
    launches = _np.zeros(1, dtype=_np.int32)   # the entry point adds to it
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the constants as torch's scalar ops see them: Python doubles
        # (1 - beta1 included) rounded once to fp32
        rc = lib.mx_multi_tensor_adam(
            table.ctypes.data, len(table), lr_t.data_ptr(), float(beta1),
            float(beta2), float(1 - beta1), float(1 - beta2),
            float(epsilon), float(r or 1.0), float(c or 0.0),
            float(d or 0.0), flags,
            None if nonfinite is None else nonfinite.data_ptr(),
            launches.ctypes.data, stream)
    _launched("multi_tensor_adam", lib, rc, launches)


def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], lr_t: torch.Tensor, beta1=0.9,
                beta2=0.999, epsilon=1e-8, rescale=1.0, clip=None,
                wd=0.0, nonfinite: Optional[torch.Tensor] = None) -> None:
    """One Adam step of every leaf, in place: per leaf rescale -> clip ->
    fold ``wd * w`` into the gradient (each stage skipped as
    ``parallel.optim`` skips it), then ``cores.adam`` at ``lr_t``, the
    bias-corrected learning rate as a 0-d fp32 tensor on the leaves'
    device.  CPU leaves take the plain per-leaf loop; CUDA leaves one
    launch of K8.  With ``nonfinite`` (:func:`all_finite`'s flag) a set
    flag skips the step: the gradients are zeroed and nothing else is
    written."""
    n = len(params)
    if not (len(grads) == len(ms) == len(vs) == n):
        raise MXNetError(f"adam_update: {n} params, {len(grads)} grads, "
                         f"{len(ms)} m and {len(vs)} v leaves")
    if n == 0:
        return
    kind = params[0].device.type
    if kind == "cpu":
        _plain_adam_update(params, grads, ms, vs, lr_t, beta1, beta2,
                           epsilon, rescale, clip, wd, nonfinite)
    elif kind == "cuda":
        _multi_tensor_adam_cuda(params, grads, ms, vs, lr_t, beta1, beta2,
                                epsilon, rescale, clip, wd, nonfinite)
    else:
        raise MXNetError(f"adam_update: unsupported device "
                         f"{params[0].device}")


# ---------------------------------------------------------------------------
# K9: the elementwise rules
# ---------------------------------------------------------------------------
# K9's rule numbers, and the state slots each rule keeps per leaf
RULES = {"sgd": 0, "sgd_mom": 1, "nag": 2, "adamw": 3, "rmsprop": 4,
         "adagrad": 5}
_SLOTS = {"sgd": 0, "sgd_mom": 1, "nag": 1, "adamw": 2, "rmsprop": 1,
          "adagrad": 1}
# the rules whose wd folds into the gradient (a stage, skipped at wd 0);
# adamw and adagrad apply it decoupled, at any wd
_FOLD_WD = ("sgd", "sgd_mom", "nag", "rmsprop")


def _check_hp(dev, hp, need, what):
    if hp.device != dev or hp.dtype != torch.float32 or hp.dim() != 1 \
            or hp.numel() < need or not hp.is_contiguous():
        raise MXNetError(f"{what}: hp must be a contiguous 1-d fp32 tensor "
                         f"of at least {need} values on {dev}, got "
                         f"{hp.dtype} {tuple(hp.shape)} on {hp.device}")


def _plain_update(rule, params, grads, states, hp, momentum, beta1, beta2,
                  gamma1, epsilon, rescale, clip, wd, nonfinite=None):
    r, c, d = _stages(rescale, clip, wd)
    fold = d if rule in _FOLD_WD else None
    with torch.no_grad():
        if nonfinite is not None and bool(nonfinite):
            for g in grads:
                g.zero_()
            return
        lr = hp[0]
        for k, (w, g) in enumerate(zip(params, grads)):
            s = [st[k] for st in states]
            gp = cores.prep_grad(g, r, c, fold, w)
            if rule == "sgd":
                cores.sgd(w, gp, lr)
            elif rule == "sgd_mom":
                cores.sgd_momentum(w, gp, s[0], lr, momentum)
            elif rule == "nag":
                cores.nag_momentum(w, gp, s[0], lr, momentum)
            elif rule == "adamw":
                cores.adamw(w, gp, s[0], s[1], lr, wd, beta1, beta2,
                            epsilon, hp[1], hp[2])
            elif rule == "rmsprop":
                cores.rmsprop(w, gp, s[0], lr, gamma1, epsilon)
            else:
                cores.adagrad(w, gp, s[0], lr, epsilon, wd)


def _multi_tensor_update_cuda(rule, params, grads, states, hp, momentum,
                              beta1, beta2, gamma1, epsilon, rescale, clip,
                              wd, nonfinite=None):
    dev = params[0].device
    what = f"multi_tensor_update[{rule}]"
    _check_tree(what, dev, params, grads, states)
    _check_hp(dev, hp, 3 if rule == "adamw" else 1, what)
    if nonfinite is not None:
        _check_flag(dev, nonfinite)
    r, c, d = _stages(rescale, clip, wd)
    fold = d if rule in _FOLD_WD else None
    flags = (_RESCALE if r is not None else 0) \
        | (_CLIP if c is not None else 0) | (_WD if fold is not None else 0)
    # the rule's constants as torch's scalar ops see them: Python doubles
    # (1 - beta and 1 - gamma included) rounded once to fp32
    if rule in ("sgd_mom", "nag"):
        a, b, oma, omb = momentum, 0.0, 0.0, 0.0
    elif rule == "adamw":
        a, b, oma, omb = beta1, beta2, 1 - beta1, 1 - beta2
    elif rule == "rmsprop":
        a, b, oma, omb = gamma1, 0.0, 1 - gamma1, 0.0
    else:
        a = b = oma = omb = 0.0
    table = _np.array([(w.data_ptr(), g.data_ptr())
                       + tuple(st[k].data_ptr() for st in states)
                       + (w.numel(),)
                       for k, (w, g) in enumerate(zip(params, grads))],
                      dtype=_np.int64).reshape(len(params), -1)
    lib = _build.library("multi_tensor_update")
    launches = _np.zeros(1, dtype=_np.int32)   # the entry point adds to it
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mx_multi_tensor_update(
            RULES[rule], table.ctypes.data, len(table), hp.data_ptr(),
            float(a), float(b), float(oma), float(omb), float(epsilon),
            float(r or 1.0), float(c or 0.0), float(wd or 0.0), flags,
            None if nonfinite is None else nonfinite.data_ptr(),
            launches.ctypes.data, stream)
    _launched("multi_tensor_update", lib, rc, launches, what)


def multi_tensor_update(rule: str, params: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor],
                        states: Sequence[Sequence[torch.Tensor]],
                        hp: torch.Tensor, momentum=0.0, beta1=0.9,
                        beta2=0.999, gamma1=0.9, epsilon=1e-8, rescale=1.0,
                        clip=None, wd=0.0,
                        nonfinite: Optional[torch.Tensor] = None) -> None:
    """One step of an elementwise rule over every leaf, in place:
    ``rule`` is ``sgd``, ``sgd_mom``, ``nag``, ``adamw``, ``rmsprop`` or
    ``adagrad``; ``states`` the rule's state slots, each a list with one
    tensor per leaf (none for ``sgd``; the momenta, or adamw's m and v, or
    rmsprop's n, or adagrad's history).  ``hp`` is a 1-d fp32 tensor on
    the leaves' device: ``hp[0]`` the learning rate and, for adamw,
    ``hp[1]``/``hp[2]`` the bias correction's denominators.  Per leaf:
    rescale -> clip -> (sgd, nag, rmsprop: fold ``wd * w``, skipped at wd
    0) -> the rule of ``optimizer.cores``.  CPU leaves take the plain
    per-leaf loop; CUDA leaves one launch of K9.  With ``nonfinite`` a set
    flag skips the step: the gradients are zeroed and nothing else is
    written."""
    if rule not in RULES:
        raise MXNetError(f"multi_tensor_update: unknown rule {rule!r} (have "
                         f"{sorted(RULES)})")
    n = len(params)
    if len(grads) != n or len(states) != _SLOTS[rule] \
            or any(len(st) != n for st in states):
        raise MXNetError(f"multi_tensor_update[{rule}]: {n} params, "
                         f"{len(grads)} grads and state slots of lengths "
                         f"{[len(st) for st in states]} (the rule keeps "
                         f"{_SLOTS[rule]} slots)")
    if n == 0:
        return
    kind = params[0].device.type
    args = (rule, params, grads, states, hp, momentum, beta1, beta2, gamma1,
            epsilon, rescale, clip, wd, nonfinite)
    if kind == "cpu":
        _plain_update(*args)
    elif kind == "cuda":
        _multi_tensor_update_cuda(*args)
    else:
        raise MXNetError(f"multi_tensor_update: unsupported device "
                         f"{params[0].device}")


# ---------------------------------------------------------------------------
# K10: LAMB
# ---------------------------------------------------------------------------
def _plain_lamb_update(params, grads, ms, vs, hp, beta1, beta2, epsilon,
                       rescale, clip, wd, lower_bound, upper_bound,
                       nonfinite=None):
    r, c, _ = _stages(rescale, clip, 0.0)
    with torch.no_grad():
        if nonfinite is not None and bool(nonfinite):
            for g in grads:
                g.zero_()
            return
        for w, g, m, v in zip(params, grads, ms, vs):
            u = cores.lamb_direction(w, cores.prep_grad(g, r, c), m, v,
                                     beta1, beta2, epsilon, wd, hp[1],
                                     hp[2])
            cores.lamb_apply(w, u, hp[0], lower_bound, upper_bound)


def _chunks(numel):
    return -(-numel // _CHUNK)


def _multi_tensor_lamb_cuda(params, grads, ms, vs, hp, beta1, beta2,
                            epsilon, rescale, clip, wd, lower_bound,
                            upper_bound, nonfinite=None):
    dev = params[0].device
    _check_tree("multi_tensor_lamb", dev, params, grads, (ms, vs))
    _check_hp(dev, hp, 3, "multi_tensor_lamb")
    if nonfinite is not None:
        _check_flag(dev, nonfinite)
    r, c, _ = _stages(rescale, clip, 0.0)
    flags = (_RESCALE if r is not None else 0) \
        | (_CLIP if c is not None else 0)
    table = _np.array([(w.data_ptr(), g.data_ptr(), m.data_ptr(),
                        v.data_ptr(), w.numel())
                       for w, g, m, v in zip(params, grads, ms, vs)],
                      dtype=_np.int64).reshape(-1, 5)
    # two fp64 partial sums per chunk (each batch of leaves reuses it)
    partials = torch.empty(2 * max(1, sum(_chunks(w.numel())
                                          for w in params)),
                           dtype=torch.float64, device=dev)
    lib = _build.library("multi_tensor_lamb")
    launches = _np.zeros(1, dtype=_np.int32)   # the entry point adds to it
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mx_multi_tensor_lamb(
            table.ctypes.data, len(table), hp.data_ptr(),
            partials.data_ptr(), float(beta1), float(beta2),
            float(1 - beta1), float(1 - beta2), float(epsilon),
            float(r or 1.0), float(c or 0.0), float(wd or 0.0),
            float(lower_bound or -1.0), float(upper_bound or -1.0), flags,
            None if nonfinite is None else nonfinite.data_ptr(),
            launches.ctypes.data, stream)
    _launched("multi_tensor_lamb", lib, rc, launches)


def lamb_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], hp: torch.Tensor, beta1=0.9,
                beta2=0.999, epsilon=1e-6, rescale=1.0, clip=None, wd=0.0,
                lower_bound=None, upper_bound=None,
                nonfinite: Optional[torch.Tensor] = None) -> None:
    """One LAMB step of every leaf, in place: per leaf rescale -> clip
    (wd is decoupled), the moments, the direction u = m / c1 /
    (sqrt(v / c2) + epsilon) + wd w, and w -= lr ratio u with ratio =
    ||w|| / ||u|| (||w|| clamped to the bounds given) where both norms are
    > 0, else 1.  ``hp`` is a 1-d fp32 tensor on the leaves' device of
    (lr, c1, c2): c1 = 1 - beta1^t and c2 = 1 - beta2^t, or 1 and 1
    without bias correction.  CPU leaves take the plain per-leaf loop
    (``cores.lamb_direction`` + ``cores.lamb_apply``); CUDA leaves one
    call of K10 (two launches).  With ``nonfinite`` a set flag skips the
    step: the gradients are zeroed and nothing else is written."""
    n = len(params)
    if not (len(grads) == len(ms) == len(vs) == n):
        raise MXNetError(f"lamb_update: {n} params, {len(grads)} grads, "
                         f"{len(ms)} m and {len(vs)} v leaves")
    if n == 0:
        return
    kind = params[0].device.type
    args = (params, grads, ms, vs, hp, beta1, beta2, epsilon, rescale,
            clip, wd, lower_bound, upper_bound, nonfinite)
    if kind == "cpu":
        _plain_lamb_update(*args)
    elif kind == "cuda":
        _multi_tensor_lamb_cuda(*args)
    else:
        raise MXNetError(f"lamb_update: unsupported device "
                         f"{params[0].device}")


# ---------------------------------------------------------------------------
# the skip_nonfinite guard's check
# ---------------------------------------------------------------------------
def _plain_all_finite(grads, flag):
    with torch.no_grad():
        for g in grads:
            if not bool(torch.isfinite(g).all()):
                flag.fill_(1)
                break
    return flag


def _all_finite_cuda(grads, flag):
    dev = grads[0].device
    _check_flag(dev, flag)
    for i, g in enumerate(grads):
        if g.device != dev or g.dtype != torch.float32 \
                or not g.is_contiguous():
            raise MXNetError(f"all_finite: leaf {i} must be a contiguous "
                             f"fp32 tensor on {dev}, got {g.dtype} on "
                             f"{g.device}")
    # (0, g, numel): the update kernels' table without the weights
    table = _np.array([(0, g.data_ptr(), g.numel()) for g in grads],
                      dtype=_np.int64).reshape(-1, 3)
    lib = _build.library("multi_tensor_adam")
    launches = _np.zeros(1, dtype=_np.int32)   # the entry point adds to it
    with torch.cuda.device(dev):
        flag.zero_()
        rc = lib.mx_all_finite(table.ctypes.data, len(table),
                               flag.data_ptr(), launches.ctypes.data,
                               torch.cuda.current_stream(dev).cuda_stream)
    _launched("all_finite", lib, rc, launches)
    return flag


def all_finite(grads: Sequence[torch.Tensor],
               flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A 1-element int32 flag on the leaves' device: 1 where any leaf
    holds a NaN or an Inf, else 0.  CUDA leaves: one launch of the
    all-finite kernel into ``flag`` (zeroed first; a new tensor when
    None), no host sync.  CPU leaves: the per-leaf ``isfinite().all()``
    loop."""
    if not grads:
        raise MXNetError("all_finite needs at least one leaf")
    dev = grads[0].device
    if flag is None:
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        return _all_finite_cuda(grads, flag)
    if dev.type != "cpu":
        raise MXNetError(f"all_finite: unsupported device {dev}")
    flag.zero_()
    return _plain_all_finite(grads, flag)


# ---------------------------------------------------------------------------
# FusedUpdater: the Gluon Trainer's whole-tree update
# ---------------------------------------------------------------------------
class _Flag:
    """A guarded step's skip flag on its way to the host
    (``cuda_graphs.HostCopy``: a non-blocking copy behind an event)."""

    def __init__(self, flag: torch.Tensor):
        from ..cuda_graphs import HostCopy
        self._copy = HostCopy(flag)

    def is_ready(self) -> bool:
        return self._copy.ready()

    def skipped(self) -> bool:
        """Whether the step was skipped (waits for the copy)."""
        return bool(int(self._copy.wait()[0][0]))


class FusedUpdater:
    """Whole-tree twin of :class:`.optimizer.Updater` for the seven rules
    the JAX package fuses (``_RULES``: SGD, NAG, Adam, AdamW, RMSProp,
    AdaGrad, LAMB).

    Shares the wrapped Updater's ``states`` and ``optimizer`` (read at
    every step, so ``load_states`` swapping them keeps working) and
    leaves the per-parameter loop usable at any time: :meth:`step`
    returns ``(False, None)`` where the update is outside its envelope —
    any other optimizer, a centered or ``clip_weights`` RMSProp, or two
    parameters over one buffer, where the JAX package's does; and, in the
    port, a leaf that is not a contiguous fp32 tensor on the first leaf's
    device (the kernels take fp32 only).  On the card the last two raise
    :class:`MXNetError` instead: there the loop is the plain version,
    which runs only when the Trainer was built with ``fused=False``.

    Host bookkeeping follows the eager classes: every count advances
    before any lr is read; lr (Adam: bias-corrected in Python doubles),
    wd and AdamW's and LAMB's bias-correction denominators round to fp32
    once, as the JAX fused update's (n,) vectors do.  Leaves are grouped
    by those values, one kernel call per group: K8 for Adam, K9 for the
    elementwise rules, K10 for LAMB."""

    def __init__(self, updater):
        self._updater = updater
        self._hp: Optional[torch.Tensor] = None     # (groups, 3) per step
        self._flag: Optional[torch.Tensor] = None   # the guard's flag
        # the health plane: per-leaf stats around the update, drained by a
        # monitor created at the first step (names from the leaves)
        self._health = None
        self._stats = None

    def _health_of(self, updatable, ws):
        """(monitor, stats buffers) for ``updatable``, or (None, None) with
        the plane off; the buffers are rebuilt when the leaves change."""
        if not _health.enabled():
            return None, None
        if self._health is None:
            self._health = _health.HealthMonitor(
                [p.name for _, p in updatable], src="fused")
        shapes = [tuple(w.shape) for w in ws]
        if self._stats is None or self._stats.shapes != shapes \
                or self._stats.buffer.device != ws[0].device:
            self._stats = _health.StepStats(ws, rows=1, loss=False)
        return self._health, self._stats

    def _buffers(self, dev, groups):
        if self._hp is None or self._hp.device != dev \
                or self._hp.shape[0] < groups:
            self._hp = torch.zeros((max(groups, 4), 3), dtype=torch.float32,
                                   device=dev)
            self._flag = torch.zeros(1, dtype=torch.int32, device=dev)
        return self._hp, self._flag

    @staticmethod
    def _rule(opt) -> Optional[str]:
        """The kernel rule of ``opt``, or None outside the envelope."""
        rule = _RULES.get(type(opt))
        if rule == "rmsprop" and (opt.centered or opt.clip_weights):
            return None
        if rule in ("sgd", "nag"):
            if opt.momentum == 0.0:
                return "sgd"      # no state: both are plain SGD
            return "sgd_mom" if rule == "sgd" else "nag"
        return rule

    def step(self, updatable, guard: bool) -> Tuple[bool, Optional[_Flag]]:
        """One update of ``updatable`` (a list of ``(index, Parameter)``).
        Returns ``(handled, flag)``: ``handled`` False means the caller
        runs the per-parameter loop instead; ``flag`` (only with
        ``guard``) reads back whether the step was skipped."""
        opt = self._updater.optimizer
        rule = self._rule(opt)
        if rule is None:
            return False, None
        if not updatable:
            return True, None
        ws_nd = [p.data() for _, p in updatable]
        gs_nd = [p.grad() for _, p in updatable]
        ws = [w._data for w in ws_nd]
        gs = [g._data for g in gs_nd]
        dev = ws[0].device
        names = [p.name for _, p in updatable] * 2
        for name, t in zip(names, ws + gs):
            if t.device != dev or t.dtype != torch.float32 \
                    or not t.is_contiguous():
                if dev.type == "cuda":
                    raise MXNetError(
                        f"the fused update takes contiguous fp32 leaves on "
                        f"{dev}; {name} has a {t.dtype} tensor on "
                        f"{t.device}: cast it to float32 or build the "
                        f"Trainer with fused=False")
                return False, None
        ptrs = [t.data_ptr() for t in ws + gs]
        if len(set(ptrs)) != len(ptrs):
            if dev.type == "cuda":
                raise MXNetError(
                    "the fused update cannot take two parameters over one "
                    "buffer; build the Trainer with fused=False")
            return False, None
        states = self._updater.states
        for (i, _), w in zip(updatable, ws_nd):
            if i not in states:
                states[i] = opt.create_state_multi_precision(i, w)
        # host bookkeeping in the eager order: every count advances before
        # any lr is read
        for i, _ in updatable:
            opt._update_count(i)
        groups: Dict[tuple, List[int]] = {}
        for k, (i, _) in enumerate(updatable):
            groups.setdefault(self._group_key(opt, rule, i), []).append(k)
        hp, flag = self._buffers(dev, len(groups))
        if guard:
            all_finite(gs, flag)
        else:
            flag = None
        monitor, stats = self._health_of(updatable, ws)
        if stats is not None:
            # the raw gradients, before a skipped step's kernel zeroes them
            stats.before(0, ws, gs)
        clip = opt.clip_gradient
        clip = clip if clip is not None and clip > 0 else None
        with torch.no_grad():
            for j, (key, ks) in enumerate(groups.items()):
                lr, wd = key[0], key[1]
                hp[j, 0].fill_(lr)
                if len(key) == 4:     # adamw, lamb: c1 and c2
                    hp[j, 1].fill_(key[2])
                    hp[j, 2].fill_(key[3])
                w_g = ([ws[k] for k in ks], [gs[k] for k in ks])
                slots = self._slots(states, updatable, ks)
                if rule == "adam":
                    adam_update(*w_g, *slots, hp[j, 0], opt.beta1,
                                opt.beta2, opt.epsilon, opt.rescale_grad,
                                clip, wd, nonfinite=flag)
                elif rule == "lamb":
                    lamb_update(*w_g, *slots, hp[j], opt.beta1, opt.beta2,
                                opt.epsilon, opt.rescale_grad, clip, wd,
                                opt.lower_bound, opt.upper_bound,
                                nonfinite=flag)
                else:
                    multi_tensor_update(
                        rule, *w_g, slots, hp[j],
                        momentum=getattr(opt, "momentum", 0.0),
                        beta1=getattr(opt, "beta1", 0.9),
                        beta2=getattr(opt, "beta2", 0.999),
                        gamma1=getattr(opt, "gamma1", 0.9),
                        epsilon=(opt.float_stable_eps if rule == "adagrad"
                                 else getattr(opt, "epsilon", 1e-8)),
                        rescale=opt.rescale_grad, clip=clip, wd=wd,
                        nonfinite=flag)
        if stats is not None:
            stats.after(0, ws)
            # the fused path never sees the loss: grad and update stats
            monitor.submit(opt.num_update - 1, 1, stats.rows_of(1))
        _telemetry.counter(
            "mxtpu_optimizer_fused_updates",
            "whole-tree fused optimizer updates").inc(site="fused_update")
        _telemetry.gauge(
            "mxtpu_optimizer_dispatches_per_step",
            "optimizer-update launches in the last trainer step (one per "
            "group fused; one per parameter in the loop)").set(len(groups))
        _telemetry.gauge(
            "mxtpu_optimizer_state_bytes",
            "optimizer-state bytes of the trainer (the whole tree: one "
            "device)").set(sum(
                s._data.numel() * s._data.element_size()
                for i, _ in updatable for s in _state_list(states[i])))
        return True, (_Flag(flag) if guard else None)

    @staticmethod
    def _group_key(opt, rule, i) -> tuple:
        """(lr, wd[, c1, c2]) of parameter ``i`` as the fp32 values its
        kernel reads."""
        def f32(x):
            return float(_np.float32(x))
        if rule == "adam":
            return f32(opt.bias_corrected_lr(i)), f32(opt._get_wd(i))
        lr, wd = f32(opt._get_lr(i)), f32(opt._get_wd(i))
        if rule == "adamw" or (rule == "lamb" and opt.bias_correction):
            t = opt._index_update_count[i]
            return lr, wd, f32(1. - opt.beta1 ** t), f32(1. - opt.beta2 ** t)
        if rule == "lamb":
            return lr, wd, 1.0, 1.0
        return lr, wd

    @staticmethod
    def _slots(states, updatable, ks) -> List[List[torch.Tensor]]:
        """The state slots of the leaves ``ks``: one list per slot."""
        per_leaf = [_state_list(states[updatable[k][0]]) for k in ks]
        return [[leaf[j]._data for leaf in per_leaf]
                for j in range(len(per_leaf[0]))]


def _state_list(state) -> list:
    """A parameter's state (None, an NDArray or a tuple of them) as a
    list of NDArrays."""
    if state is None:
        return []
    return list(state) if isinstance(state, tuple) else [state]


def functional_twin(optimizer):
    """The ``parallel.optim`` rule matching an eager optimizer instance
    (the bridge ``SPMDTrainer`` uses to take over a model configured for
    the eager ``Trainer``).  Raises :class:`MXNetError` where the eager
    configuration carries host-side per-step behaviour a device-side
    update cannot reproduce: an ``lr_scheduler`` (pass ``lr_schedule=``, a
    function of the step tensor, to the functional rule instead), a
    centered or ``clip_weights`` RMSProp, LAMB bounds or
    ``bias_correction=False``, or an optimizer outside the seven rules.
    ``rescale_grad`` and ``clip_gradient`` carry over as constants."""
    from ..parallel import optim as _fopt      # parallel imports this module
    rule = _RULES.get(type(optimizer))
    if rule is None:
        raise MXNetError(
            f"no functional twin for {type(optimizer).__name__} — pass a "
            "parallel.optim optimizer explicitly")
    if getattr(optimizer, "lr_scheduler", None) is not None:
        raise MXNetError(
            "functional_twin cannot capture a host-side lr_scheduler — pass "
            "lr_schedule= (a step tensor -> lr tensor function) to the "
            "functional optimizer instead")
    kw = dict(learning_rate=optimizer.lr, wd=optimizer.wd,
              rescale_grad=float(optimizer.rescale_grad),
              clip_gradient=optimizer.clip_gradient or None)
    if rule in ("sgd", "nag"):
        kw["momentum"] = optimizer.momentum
    elif rule in ("adam", "adamw"):
        kw.update(beta1=optimizer.beta1, beta2=optimizer.beta2,
                  epsilon=optimizer.epsilon)
    elif rule == "lamb":
        if optimizer.lower_bound is not None or \
                optimizer.upper_bound is not None or \
                not optimizer.bias_correction:
            raise MXNetError(
                "functional_twin: LAMB trust-ratio bounds / "
                "bias_correction=False are outside the functional envelope")
        kw.update(beta1=optimizer.beta1, beta2=optimizer.beta2,
                  epsilon=optimizer.epsilon)
    elif rule == "rmsprop":
        if optimizer.centered or optimizer.clip_weights:
            raise MXNetError(
                "functional_twin: centered / clip_weights RMSProp is "
                "outside the functional envelope")
        kw.update(gamma1=optimizer.gamma1, epsilon=optimizer.epsilon)
    else:                                       # adagrad
        kw["epsilon"] = optimizer.float_stable_eps
    return _fopt.create(rule, **kw)
