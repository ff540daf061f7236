"""The whole-tree optimizer update (counterpart of
``incubator_mxnet_tpu/optimizer/fused.py``, whose one donated ``jax.jit``
program updates every parameter in one dispatch).

:func:`adam_update` applies one Adam step to every leaf of a parameter
list in place.  It has two versions, chosen by where the tensors lie:

* the plain version, the per-leaf loop of ``cores.prep_grad`` +
  ``cores.adam``, for CPU tensors (and the reference the kernel is held
  to);
* kernel K8 ``kernels/csrc/multi_tensor_adam.cu`` for CUDA tensors: every
  leaf in one launch, bit for bit the plain version's arithmetic, reading
  the bias-corrected learning rate from the device.  There is no fallback:
  on CUDA tensors the kernel runs or the call raises.  Each call adds one
  to ``launch_counts["multi_tensor_adam"]``.

:func:`all_finite` is the ``skip_nonfinite`` guard's check: one launch
of the same source's all-finite kernel over every gradient leaf on the
card, which sets a device flag that a guarded :func:`adam_update` reads
before any write (no host sync); a per-leaf ``isfinite().all()`` loop on
the CPU.

:class:`FusedUpdater` is the Gluon ``Trainer``'s whole-tree update (the
JAX package's, without ZeRO-1) for the Adam rule: per-parameter lr/wd
multipliers and Adam's bias correction in Python doubles as the eager
``Adam`` computes them, leaves grouped by the resulting (lr, wd), one K8
launch per group, the guard on the device, and skipped steps counted
from an asynchronous readback of its flag."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from ..base import MXNetError
from ..kernels import _build
from ..kernels.flash_attention import _count
from .. import telemetry as _telemetry
from . import cores

__all__ = ["adam_update", "all_finite", "FusedUpdater"]

_RESCALE, _CLIP, _WD = 1, 2, 4     # K8's stage flags (kRescale, kClip, kWd)


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


def _check_leaves(dev, params, grads, ms, vs, lr_t):
    if lr_t.device != dev or lr_t.dtype != torch.float32 or lr_t.dim():
        raise MXNetError(f"multi_tensor_adam: lr_t must be a 0-d fp32 "
                         f"tensor on {dev}, got {lr_t.dtype} "
                         f"{tuple(lr_t.shape)} on {lr_t.device}")
    for i, leaf in enumerate(zip(params, grads, ms, vs)):
        shape = leaf[0].shape
        for what, t in zip(("param", "grad", "m", "v"), leaf):
            if t.device != dev or t.dtype != torch.float32 \
                    or not t.is_contiguous() or t.shape != shape:
                raise MXNetError(
                    f"multi_tensor_adam: leaf {i}'s {what} must be a "
                    f"contiguous fp32 tensor of shape {tuple(shape)} on "
                    f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_flag(dev, flag):
    if flag.device != dev or flag.dtype != torch.int32 or flag.numel() != 1:
        raise MXNetError(f"the nonfinite flag must be one int32 on {dev}, "
                         f"got {flag.dtype} {tuple(flag.shape)} on "
                         f"{flag.device}")


def _multi_tensor_adam_cuda(params, grads, ms, vs, lr_t, beta1, beta2,
                            epsilon, rescale, clip, wd, nonfinite=None):
    dev = params[0].device
    _check_leaves(dev, params, grads, ms, vs, lr_t)
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the constants as torch's scalar ops see them: Python doubles
        # (1 - beta1 included) rounded once to fp32
        rc = lib.mx_multi_tensor_adam(
            table.ctypes.data, len(table), lr_t.data_ptr(), float(beta1),
            float(beta2), float(1 - beta1), float(1 - beta2),
            float(epsilon), float(r or 1.0), float(c or 0.0),
            float(d or 0.0), flags,
            None if nonfinite is None else nonfinite.data_ptr(), stream)
    if rc != 0:
        raise MXNetError(f"multi_tensor_adam kernel launch failed: "
                         f"{lib.mx_error_string(rc).decode()} (code {rc})")
    _count("multi_tensor_adam")


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
    table = _np.array([(g.data_ptr(), g.numel()) for g in grads],
                      dtype=_np.int64).reshape(-1, 2)
    lib = _build.library("multi_tensor_adam")
    with torch.cuda.device(dev):
        flag.zero_()
        rc = lib.mx_all_finite(table.ctypes.data, len(table),
                               flag.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise MXNetError(f"all_finite kernel launch failed: "
                         f"{lib.mx_error_string(rc).decode()} (code {rc})")
    _count("all_finite")
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
    """A guarded step's skip flag on its way to the host: a non-blocking
    copy into pinned memory and an event behind it (on the CPU, the value
    itself)."""

    def __init__(self, flag: torch.Tensor):
        if flag.is_cuda:
            self._host = torch.empty(1, dtype=torch.int32, pin_memory=True)
            self._host.copy_(flag, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = flag.clone(), None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def skipped(self) -> bool:
        """Whether the step was skipped (waits for the copy)."""
        if self._event is not None:
            self._event.synchronize()
        return bool(int(self._host[0]))


class FusedUpdater:
    """Whole-tree twin of :class:`.optimizer.Updater` for the Adam rule.

    Shares the wrapped Updater's ``states`` and ``optimizer`` (read at
    every step, so ``load_states`` swapping them keeps working) and
    leaves the per-parameter loop usable at any time: :meth:`step`
    returns ``(False, None)`` where the update is outside its envelope —
    an optimizer other than Adam, or two parameters over one buffer,
    where the JAX package's does; and, in the port, a leaf that is not a
    contiguous fp32 tensor on the first leaf's device (K8 takes fp32
    only).  On the card the last two raise :class:`MXNetError` instead:
    there the loop is the plain version, which runs only when the
    Trainer was built with ``fused=False``."""

    def __init__(self, updater):
        self._updater = updater
        self._lr: Optional[torch.Tensor] = None     # one slot per group
        self._flag: Optional[torch.Tensor] = None   # the guard's flag

    def _buffers(self, dev, groups):
        if self._lr is None or self._lr.device != dev \
                or self._lr.numel() < groups:
            self._lr = torch.zeros(max(groups, 4), dtype=torch.float32,
                                   device=dev)
            self._flag = torch.zeros(1, dtype=torch.int32, device=dev)
        return self._lr, self._flag

    def step(self, updatable, guard: bool) -> Tuple[bool, Optional[_Flag]]:
        """One update of ``updatable`` (a list of ``(index, Parameter)``).
        Returns ``(handled, flag)``: ``handled`` False means the caller
        runs the per-parameter loop instead; ``flag`` (only with
        ``guard``) reads back whether the step was skipped."""
        from .optimizer import Adam
        opt = self._updater.optimizer
        if type(opt) is not Adam:
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
                        f"the fused update (K8) takes contiguous fp32 "
                        f"leaves on {dev}; {name} has a {t.dtype} "
                        f"tensor on {t.device}: cast it to float32 or "
                        f"build the Trainer with fused=False")
                return False, None
        ptrs = [t.data_ptr() for t in ws + gs]
        if len(set(ptrs)) != len(ptrs):
            if dev.type == "cuda":
                raise MXNetError(
                    "the fused update (K8) cannot take two parameters "
                    "over one buffer; build the Trainer with fused=False")
            return False, None
        states = self._updater.states
        for (i, _), w in zip(updatable, ws_nd):
            if i not in states:
                states[i] = opt.create_state_multi_precision(i, w)
        # host bookkeeping in the eager order: every count advances before
        # any lr is read; lr and wd round to fp32 once, as the JAX fused
        # update's (n,) vectors do
        for i, _ in updatable:
            opt._update_count(i)
        groups: Dict[Tuple[float, float], List[int]] = {}
        for k, (i, _) in enumerate(updatable):
            key = (float(_np.float32(opt.bias_corrected_lr(i))),
                   float(_np.float32(opt._get_wd(i))))
            groups.setdefault(key, []).append(k)
        lr_slots, flag = self._buffers(dev, len(groups))
        if guard:
            all_finite(gs, flag)
        else:
            flag = None
        clip = opt.clip_gradient
        with torch.no_grad():
            for j, ((lr, wd), ks) in enumerate(groups.items()):
                lr_t = lr_slots[j]
                lr_t.fill_(lr)
                adam_update([ws[k] for k in ks], [gs[k] for k in ks],
                            [states[updatable[k][0]][0]._data for k in ks],
                            [states[updatable[k][0]][1]._data for k in ks],
                            lr_t, opt.beta1, opt.beta2, opt.epsilon,
                            opt.rescale_grad,
                            clip if clip is not None and clip > 0 else None,
                            wd, nonfinite=flag)
        _telemetry.counter(
            "mxtpu_optimizer_fused_updates",
            "whole-tree fused optimizer updates").inc(site="fused_update")
        _telemetry.gauge(
            "mxtpu_optimizer_dispatches_per_step",
            "optimizer-update launches in the last trainer step (one per "
            "(lr, wd) group fused; one per parameter in the loop)").set(
            len(groups))
        _telemetry.gauge(
            "mxtpu_optimizer_state_bytes",
            "optimizer-state bytes of the trainer (the whole tree: one "
            "device)").set(sum(
                s._data.numel() * s._data.element_size()
                for i, _ in updatable for s in states[i]))
        return True, (_Flag(flag) if guard else None)
