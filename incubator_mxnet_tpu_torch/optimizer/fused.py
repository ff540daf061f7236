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
``launch_counts[<kernel>]`` (``"<kernel>.<instance>"`` for a 16-bit
instance; one per 512 leaves; K10 two).  The
learning rate (and AdamW's and LAMB's bias-correction denominators) is
read from device memory, so a CUDA graph that computes it from the step on
the device replays with each step's value.  K8 and K9 take fp32, bf16 and
fp16 leaves (the instance by the leaves' dtype and the call's mode:
``promote`` for the train step's first step of a cast net, ``masters``
for ``multi_precision``; see ``_PREC``); K10 takes fp32.

:func:`all_finite` is the ``skip_nonfinite`` guard's check: one launch
of K8's source's all-finite kernel over every gradient leaf on the card,
which sets a device flag that a guarded update of any of the three reads
before any write (no host sync); a per-leaf ``isfinite().all()`` loop on
the CPU.  :func:`half_pair_check` is a test, on the card, of the packed
two-element arithmetic K8's and K9's 16-bit instances run on.

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
from ..kernels.flash_attention import DTYPE_CODES as _DTYPE_CODES
from ..kernels.flash_attention import DTYPE_NAMES as _NAMES
from ..kernels.flash_attention import instance_of as _instance_of
from ..kernels.flash_attention import launched as _launched
from .. import telemetry as _telemetry
from . import cores
from .optimizer import (NAG, SGD, AdaGrad, Adam, AdamW, LAMB, RMSProp)

__all__ = ["adam_update", "multi_tensor_update", "lamb_update",
           "half_pair_check",
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


# The instances of K8's and K9's kernel body (multi_tensor_common.cuh
# PrecId), by the leaves' dtype and the call's mode:
# * "plain": every leaf and the arithmetic in the leaves' dtype (fp32, or
#   16-bit with lr and the constants rounded to it: the Gluon update of a
#   cast net, and the rules that keep a cast net's dtype in the train
#   step);
# * "promote": bf16 leaves whose fp32 hyperparameters promote the new
#   weights to fp32 (the train step's adam and adamw on a cast net, as in
#   the JAX step): the moments stay bf16, the new weights are new fp32
#   tensors (fp16 is refused: _mode);
# * "master": multi_precision, fp32 masters and state over fp16 gradients,
#   the masters rounded into the fp16 weights.
_PREC = {("plain", torch.float32): 0, ("plain", torch.bfloat16): 1,
         ("plain", torch.float16): 2, ("promote", torch.bfloat16): 3,
         ("master", torch.float16): 5}
# each instance's launches count under "<kernel>.<instance>" (the fp32
# one under the kernel's own name): the dtype's name, after the mode's
_INSTANCE = {code: _instance_of(dt) if mode == "plain"
             else f"{mode}_{_NAMES[dt]}" for (mode, dt), code in _PREC.items()}


# why the promoting step of a fp16 net is refused (tools/
# jax_half_update_rounding.py measures both points on the CPU)
FP16_PROMOTION = (
    "the promoting step of a float16 net (fp32 hyperparameters over fp16 "
    "weights: adam, adamw and lamb in SPMDTrainer) is refused: "
    "(1 - beta2) g^2 underflows fp16 and the step divides by epsilon "
    "there, in the reference too, whose values then follow its backend's "
    "fp16 arithmetic (fused multiply-adds); cast to bfloat16, or use "
    "gluon.Trainer with multi_precision=True; ROADMAP")


def _mode(what, params, promote, masters, rule="adam") -> str:
    if masters is not None:
        return "master"
    if promote and params and params[0].dtype in cores.HALF:
        if rule not in PROMOTING:
            raise MXNetError(
                f"{what}: no promoting {rule} step (16-bit weights with "
                f"fp32 hyperparameters, an lr_schedule on a cast net: the "
                f"JAX step promotes them to fp32); ROADMAP")
        if params[0].dtype == torch.float16:
            raise MXNetError(f"{what}: {FP16_PROMOTION}")
        return "promote"
    return "plain"


def _decay(beta, moments_dtype):
    """A moment's decay constant as the JAX step types it: rounded to the
    moments' earlier 16-bit dtype where they are read at fp32 (the step
    after a promoting one; ``cores.moments``)."""
    return float(beta if moments_dtype is None
                 else cores.weak(beta, moments_dtype))


def _hp(h, w, mode):
    """A device hyperparameter (0-d fp32) as the instance types it: rounded
    to a 16-bit leaf's dtype in the plain mode (as the JAX fused update
    casts it), fp32 otherwise."""
    return h.to(w.dtype) if mode == "plain" and w.dtype in cores.HALF \
        else h


def _zero_grads(grads):
    for g in grads:
        g.zero_()


def _plain_adam_update(params, grads, ms, vs, lr_t, beta1, beta2, epsilon,
                       rescale, clip, wd, nonfinite=None, promote=False,
                       masters=None, moments_dtype=None):
    r, c, d = _stages(rescale, clip, wd)
    mode = _mode("adam_update", params, promote, masters)
    with torch.no_grad():
        if nonfinite is not None and bool(nonfinite):
            _zero_grads(grads)
            return list(params)
        out = []
        for k, (w, g, m, v) in enumerate(zip(params, grads, ms, vs)):
            tw = masters[k] if masters is not None else w
            gk = g.float() if masters is not None else g
            nw, _, _ = cores.adam(tw, cores.prep_grad(gk, r, c, d, tw), m, v,
                                  _hp(lr_t, tw, mode), beta1, beta2, epsilon,
                                  moments_dtype)
            if masters is not None:
                w.copy_(nw)
                nw = w
            out.append(nw)
        return out


def _check_tree(what, dev, mode, params, grads, states, masters=None):
    """Every leaf contiguous, of one shape, on ``dev``, with the dtypes of
    an instance: one dtype of fp32, bf16, fp16 ("plain"), one 16-bit dtype
    ("promote"), fp16 weights and gradients over fp32 masters and state
    ("master").  Returns the instance's number."""
    dt = params[0].dtype
    key = (mode, dt)
    if key not in _PREC and dt not in _NAMES:
        dt = torch.float32      # not a kernel dtype: report the fp32 one
        key = (mode, dt)
    if key not in _PREC:
        raise MXNetError(
            f"{what}: no kernel instance for {dt} leaves in the {mode} mode "
            f"(have {sorted((m, str(t)) for m, t in _PREC)})")
    fp32 = torch.float32
    for i, leaf in enumerate(zip(params, grads, *states)):
        shape = leaf[0].shape
        want = [dt, dt] + [fp32 if mode == "master" else dt] * len(states)
        if masters is not None:
            leaf = leaf + (masters[i],)
            want.append(fp32)
        for t, w in zip(leaf, want):
            if t.device != dev or t.dtype != w or not t.is_contiguous() \
                    or t.shape != shape:
                raise MXNetError(
                    f"{what}: leaf {i} must be contiguous {_NAMES[w]} "
                    f"tensors of shape {tuple(shape)} on {dev} (the {mode} "
                    f"instance over {_NAMES[dt]} weights), got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    return _PREC[key]


def _check_flag(dev, flag):
    if flag.device != dev or flag.dtype != torch.int32 or flag.numel() != 1:
        raise MXNetError(f"the nonfinite flag must be one int32 on {dev}, "
                         f"got {flag.dtype} {tuple(flag.shape)} on "
                         f"{flag.device}")


def _table(params, grads, states, mode, masters):
    """The kernels' leaf table, rows of (w, g, states..., wo, numel) as
    int64, and the new weights: ``params`` themselves, or the new fp32
    tensors the promoting instance writes (its wo)."""
    rows, out = [], []
    for k, (w, g) in enumerate(zip(params, grads)):
        if mode == "promote":
            nw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
            tw, wo = w, nw.data_ptr()
        elif mode == "master":
            nw, tw, wo = w, masters[k], w.data_ptr()
        else:
            nw, tw, wo = w, w, 0
        rows.append((tw.data_ptr(), g.data_ptr())
                    + tuple(st[k].data_ptr() for st in states)
                    + (wo, w.numel()))
        out.append(nw)
    table = _np.array(rows, dtype=_np.int64).reshape(len(params), -1)
    return table, out


def _multi_tensor_adam_cuda(params, grads, ms, vs, lr_t, beta1, beta2,
                            epsilon, rescale, clip, wd, nonfinite=None,
                            promote=False, masters=None, moments_dtype=None):
    dev = params[0].device
    mode = _mode("multi_tensor_adam", params, promote, masters)
    prec = _check_tree("multi_tensor_adam", dev, mode, params, grads,
                       (ms, vs), masters)
    if lr_t.device != dev or lr_t.dtype != torch.float32 or lr_t.dim():
        raise MXNetError(f"multi_tensor_adam: lr_t must be a 0-d fp32 "
                         f"tensor on {dev}, got {lr_t.dtype} "
                         f"{tuple(lr_t.shape)} on {lr_t.device}")
    if nonfinite is not None:
        _check_flag(dev, nonfinite)
    r, c, d = _stages(rescale, clip, wd)
    flags = (_RESCALE if r is not None else 0) \
        | (_CLIP if c is not None else 0) | (_WD if d is not None else 0)
    # (w, g, m, v, wo, numel) per leaf; the entry point reads it before it
    # returns (the launch carries the table as its parameter)
    table, out = _table(params, grads, (ms, vs), mode, masters)
    lib = _build.library("multi_tensor_adam")
    launches = _np.zeros(1, dtype=_np.int32)   # the entry point adds to it
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the constants as torch's scalar ops see them: Python doubles
        # (1 - beta1 included) rounded once to fp32
        rc = lib.mx_multi_tensor_adam(
            prec, table.ctypes.data, len(table), lr_t.data_ptr(),
            _decay(beta1, moments_dtype), _decay(beta2, moments_dtype),
            float(1 - beta1), float(1 - beta2),
            float(epsilon), float(r or 1.0), float(c or 0.0),
            float(d or 0.0), flags,
            None if nonfinite is None else nonfinite.data_ptr(),
            launches.ctypes.data, stream)
    _launched("multi_tensor_adam", lib, rc, launches,
              instance=_INSTANCE[prec])
    return out


def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], lr_t: torch.Tensor, beta1=0.9,
                beta2=0.999, epsilon=1e-8, rescale=1.0, clip=None,
                wd=0.0, nonfinite: Optional[torch.Tensor] = None,
                promote: bool = False,
                masters: Optional[Sequence[torch.Tensor]] = None,
                moments_dtype: Optional[torch.dtype] = None
                ) -> List[torch.Tensor]:
    """One Adam step of every leaf: per leaf rescale -> clip -> fold
    ``wd * w`` into the gradient (each stage skipped as ``parallel.optim``
    skips it), then ``cores.adam`` at ``lr_t``, the bias-corrected
    learning rate as a 0-d fp32 tensor on the leaves' device.  CPU leaves
    take the plain per-leaf loop; CUDA leaves one launch of K8.  With
    ``nonfinite`` (:func:`all_finite`'s flag) a set flag skips the step:
    the gradients are zeroed and nothing else is written.

    Leaves of one dtype (fp32, bf16, fp16) update in place in that dtype
    (``lr_t`` rounded to a 16-bit one).  ``promote`` (bf16 leaves):
    ``lr_t`` is a fp32 value that promotes them, as in the JAX train step:
    the moments update in place in bf16 and the new weights are new fp32
    tensors (fp16 leaves raise: ``_mode``).  ``masters``
    (multi_precision): fp32 master weights the update runs on, over fp16
    gradients and fp32 state; ``params`` (fp16) receive the masters
    rounded.  ``moments_dtype``: the step after a promoting one, whose
    fp32 moments were bf16 in the JAX step (``cores.moments``).  Returns
    the new weights: ``params`` themselves, or the new fp32 tensors where
    promoted."""
    n = len(params)
    if not (len(grads) == len(ms) == len(vs) == n) or \
            (masters is not None and len(masters) != n):
        raise MXNetError(f"adam_update: {n} params, {len(grads)} grads, "
                         f"{len(ms)} m and {len(vs)} v leaves")
    if n == 0:
        return []
    kind = params[0].device.type
    args = (params, grads, ms, vs, lr_t, beta1, beta2, epsilon, rescale,
            clip, wd, nonfinite, promote, masters, moments_dtype)
    if kind == "cpu":
        return _plain_adam_update(*args)
    if kind == "cuda":
        return _multi_tensor_adam_cuda(*args)
    raise MXNetError(f"adam_update: unsupported device {params[0].device}")


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
# the rules with a promoting step on a bf16 net (lamb's on the CPU only:
# K10 takes fp32); the others keep a cast net's dtype in the JAX step, and
# an lr_schedule, which would promote them, is refused on a cast net
PROMOTING = ("adam", "adamw", "lamb")


def _check_hp(dev, hp, need, what):
    if hp.device != dev or hp.dtype != torch.float32 or hp.dim() != 1 \
            or hp.numel() < need or not hp.is_contiguous():
        raise MXNetError(f"{what}: hp must be a contiguous 1-d fp32 tensor "
                         f"of at least {need} values on {dev}, got "
                         f"{hp.dtype} {tuple(hp.shape)} on {hp.device}")


def _plain_update(rule, params, grads, states, hp, momentum, beta1, beta2,
                  gamma1, epsilon, rescale, clip, wd, nonfinite=None,
                  promote=False, masters=None, moments_dtype=None):
    r, c, d = _stages(rescale, clip, wd)
    fold = d if rule in _FOLD_WD else None
    mode = _mode(f"multi_tensor_update[{rule}]", params, promote, masters,
                 rule)
    with torch.no_grad():
        if nonfinite is not None and bool(nonfinite):
            _zero_grads(grads)
            return list(params)
        out = []
        for k, (w, g) in enumerate(zip(params, grads)):
            s = [st[k] for st in states]
            tw = masters[k] if masters is not None else w
            gk = g.float() if masters is not None else g
            gp = cores.prep_grad(gk, r, c, fold, tw)
            lr = _hp(hp[0], tw, mode)
            if rule == "sgd":
                nw = cores.sgd(tw, gp, lr)
            elif rule == "sgd_mom":
                nw, _ = cores.sgd_momentum(tw, gp, s[0], lr, momentum)
            elif rule == "nag":
                nw, _ = cores.nag_momentum(tw, gp, s[0], lr, momentum)
            elif rule == "adamw":
                nw, _, _ = cores.adamw(tw, gp, s[0], s[1], lr, wd, beta1,
                                       beta2, epsilon, _hp(hp[1], tw, mode),
                                       _hp(hp[2], tw, mode), moments_dtype)
            elif rule == "rmsprop":
                nw, _ = cores.rmsprop(tw, gp, s[0], lr, gamma1, epsilon)
            else:
                nw, _ = cores.adagrad(tw, gp, s[0], lr, epsilon, wd)
            if masters is not None:
                w.copy_(nw)
                nw = w
            out.append(nw)
        return out


def _multi_tensor_update_cuda(rule, params, grads, states, hp, momentum,
                              beta1, beta2, gamma1, epsilon, rescale, clip,
                              wd, nonfinite=None, promote=False,
                              masters=None, moments_dtype=None):
    dev = params[0].device
    what = f"multi_tensor_update[{rule}]"
    mode = _mode(what, params, promote, masters, rule)
    prec = _check_tree(what, dev, mode, params, grads, states, masters)
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
        a, b = _decay(beta1, moments_dtype), _decay(beta2, moments_dtype)
        oma, omb = 1 - beta1, 1 - beta2
    elif rule == "rmsprop":
        a, b, oma, omb = gamma1, 0.0, 1 - gamma1, 0.0
    else:
        a = b = oma = omb = 0.0
    table, out = _table(params, grads, states, mode, masters)
    lib = _build.library("multi_tensor_update")
    launches = _np.zeros(1, dtype=_np.int32)   # the entry point adds to it
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mx_multi_tensor_update(
            RULES[rule], prec, table.ctypes.data, len(table), hp.data_ptr(),
            float(a), float(b), float(oma), float(omb), float(epsilon),
            float(r or 1.0), float(c or 0.0), float(wd or 0.0), flags,
            None if nonfinite is None else nonfinite.data_ptr(),
            launches.ctypes.data, stream)
    _launched("multi_tensor_update", lib, rc, launches, what,
              instance=_INSTANCE[prec])
    return out


def multi_tensor_update(rule: str, params: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor],
                        states: Sequence[Sequence[torch.Tensor]],
                        hp: torch.Tensor, momentum=0.0, beta1=0.9,
                        beta2=0.999, gamma1=0.9, epsilon=1e-8, rescale=1.0,
                        clip=None, wd=0.0,
                        nonfinite: Optional[torch.Tensor] = None,
                        promote: bool = False,
                        masters: Optional[Sequence[torch.Tensor]] = None,
                        moments_dtype: Optional[torch.dtype] = None
                        ) -> List[torch.Tensor]:
    """One step of an elementwise rule over every leaf: ``rule`` is
    ``sgd``, ``sgd_mom``, ``nag``, ``adamw``, ``rmsprop`` or ``adagrad``;
    ``states`` the rule's state slots, each a list with one tensor per
    leaf (none for ``sgd``; the momenta, or adamw's m and v, or rmsprop's
    n, or adagrad's history).  ``hp`` is a 1-d fp32 tensor on the leaves'
    device: ``hp[0]`` the learning rate and, for adamw, ``hp[1]``/``hp[2]``
    the bias correction's denominators.  Per leaf: rescale -> clip ->
    (sgd, nag, rmsprop: fold ``wd * w``, skipped at wd 0) -> the rule of
    ``optimizer.cores``.  CPU leaves take the plain per-leaf loop; CUDA
    leaves one launch of K9.  With ``nonfinite`` a set flag skips the
    step: the gradients are zeroed and nothing else is written.
    ``promote``, ``masters`` and ``moments_dtype`` (adamw) as
    :func:`adam_update`'s (a promoting step: adamw only).  Returns the new
    weights."""
    if rule not in RULES:
        raise MXNetError(f"multi_tensor_update: unknown rule {rule!r} (have "
                         f"{sorted(RULES)})")
    n = len(params)
    if len(grads) != n or len(states) != _SLOTS[rule] \
            or any(len(st) != n for st in states) \
            or (masters is not None and len(masters) != n):
        raise MXNetError(f"multi_tensor_update[{rule}]: {n} params, "
                         f"{len(grads)} grads and state slots of lengths "
                         f"{[len(st) for st in states]} (the rule keeps "
                         f"{_SLOTS[rule]} slots)")
    if n == 0:
        return []
    kind = params[0].device.type
    args = (rule, params, grads, states, hp, momentum, beta1, beta2, gamma1,
            epsilon, rescale, clip, wd, nonfinite, promote, masters,
            moments_dtype)
    if kind == "cpu":
        return _plain_update(*args)
    if kind == "cuda":
        return _multi_tensor_update_cuda(*args)
    raise MXNetError(f"multi_tensor_update: unsupported device "
                     f"{params[0].device}")


# The packed operations of K8's and K9's 16-bit instances (two elements
# per instruction, multi_tensor_common.cuh ``V2``), by their code in
# ``mx_half_pair_check``: +, -, *, the packed rounding of two floats, and
# / (``quot16``, two lanes in fp32 and one packed rounding)
PAIR_OPS = {"add": 0, "sub": 1, "mul": 2, "pack": 3, "div": 4}


def half_pair_check(op: str, dtype: torch.dtype,
                    device="cuda:0") -> Tuple[int, Optional[int]]:
    """Hold one packed operation of the 16-bit update instances to the
    scalar path on the card, over every case: for ``add``, ``sub``,
    ``mul`` and ``div`` every pair of ``dtype`` (bf16 or fp16) operands,
    in each lane, against the fp32 operation (``__fdiv_rn`` for ``div``)
    rounded to ``dtype``; for ``pack`` every fp32 value against its scalar
    rounding.  Returns (cases that differ,
    the smallest such 32-bit case or None): equal bits, or NaN on both
    sides, agree.  A test of the card's instructions, with no plain
    version: other devices raise."""
    dev = torch.device(device)
    if op not in PAIR_OPS:
        raise MXNetError(f"half_pair_check: unknown op {op!r} (have "
                         f"{sorted(PAIR_OPS)})")
    if dtype not in cores.HALF:
        raise MXNetError(f"half_pair_check: {dtype} is not a 16-bit type")
    if dev.type != "cuda":
        raise MXNetError(f"half_pair_check: checks the card's packed "
                         f"instructions; no plain version on {dev}")
    out = torch.tensor([0, -1], dtype=torch.int64, device=dev)
    lib = _build.library("multi_tensor_update")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mx_half_pair_check(_PREC[("plain", dtype)], PAIR_OPS[op],
                                    out.data_ptr(), stream)
    if rc:
        raise MXNetError(f"half_pair_check: launch failed: "
                         f"{lib.mx_error_string(rc).decode()}")
    n, first = (int(v) for v in out.cpu())
    return n, (first & 0xffffffff if n else None)


# ---------------------------------------------------------------------------
# K10: LAMB
# ---------------------------------------------------------------------------
def _plain_lamb_update(params, grads, ms, vs, hp, beta1, beta2, epsilon,
                       rescale, clip, wd, lower_bound, upper_bound,
                       nonfinite=None, promote=False, moments_dtype=None):
    r, c, _ = _stages(rescale, clip, 0.0)
    mode = _mode("lamb_update", params, promote, None, "lamb")
    with torch.no_grad():
        if nonfinite is not None and bool(nonfinite):
            _zero_grads(grads)
            return list(params)
        out = []
        for w, g, m, v in zip(params, grads, ms, vs):
            u = cores.lamb_direction(w, cores.prep_grad(g, r, c), m, v,
                                     beta1, beta2, epsilon, wd,
                                     _hp(hp[1], w, mode), _hp(hp[2], w, mode),
                                     moments_dtype)
            out.append(cores.lamb_apply(w, u, _hp(hp[0], w, mode),
                                        lower_bound, upper_bound))
        return out


def _chunks(numel):
    return -(-numel // _CHUNK)


def _multi_tensor_lamb_cuda(params, grads, ms, vs, hp, beta1, beta2,
                            epsilon, rescale, clip, wd, lower_bound,
                            upper_bound, nonfinite=None, promote=False,
                            moments_dtype=None):
    dev = params[0].device
    if params[0].dtype != torch.float32:
        raise MXNetError(
            f"multi_tensor_lamb: K10 takes fp32 leaves only, got "
            f"{params[0].dtype}: LAMB on a cast net is not ported to the "
            f"card yet (ROADMAP: K10 at 16 bits)")
    _check_tree("multi_tensor_lamb", dev, "plain", params, grads, (ms, vs))
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
            partials.data_ptr(), _decay(beta1, moments_dtype),
            _decay(beta2, moments_dtype), float(1 - beta1),
            float(1 - beta2), float(epsilon),
            float(r or 1.0), float(c or 0.0), float(wd or 0.0),
            float(lower_bound or -1.0), float(upper_bound or -1.0), flags,
            None if nonfinite is None else nonfinite.data_ptr(),
            launches.ctypes.data, stream)
    _launched("multi_tensor_lamb", lib, rc, launches)
    return list(params)


def lamb_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], hp: torch.Tensor, beta1=0.9,
                beta2=0.999, epsilon=1e-6, rescale=1.0, clip=None, wd=0.0,
                lower_bound=None, upper_bound=None,
                nonfinite: Optional[torch.Tensor] = None,
                promote: bool = False,
                moments_dtype: Optional[torch.dtype] = None
                ) -> List[torch.Tensor]:
    """One LAMB step of every leaf, in place: per leaf rescale -> clip
    (wd is decoupled), the moments, the direction u = m / c1 /
    (sqrt(v / c2) + epsilon) + wd w, and w -= lr ratio u with ratio =
    ||w|| / ||u|| (||w|| clamped to the bounds given) where both norms are
    > 0, else 1.  ``hp`` is a 1-d fp32 tensor on the leaves' device of
    (lr, c1, c2): c1 = 1 - beta1^t and c2 = 1 - beta2^t, or 1 and 1
    without bias correction.  CPU leaves take the plain per-leaf loop
    (``cores.lamb_direction`` + ``cores.lamb_apply``); CUDA leaves one
    call of K10 (two launches).  With ``nonfinite`` a set flag skips the
    step: the gradients are zeroed and nothing else is written.
    ``promote`` and ``moments_dtype`` as :func:`adam_update`'s; K10 takes
    fp32 leaves only (bf16 leaves run the plain version on the CPU and
    raise on the card).
    Returns the new weights."""
    n = len(params)
    if not (len(grads) == len(ms) == len(vs) == n):
        raise MXNetError(f"lamb_update: {n} params, {len(grads)} grads, "
                         f"{len(ms)} m and {len(vs)} v leaves")
    if n == 0:
        return []
    kind = params[0].device.type
    args = (params, grads, ms, vs, hp, beta1, beta2, epsilon, rescale,
            clip, wd, lower_bound, upper_bound, nonfinite, promote,
            moments_dtype)
    if kind == "cpu":
        return _plain_lamb_update(*args)
    if kind == "cuda":
        return _multi_tensor_lamb_cuda(*args)
    raise MXNetError(f"lamb_update: unsupported device {params[0].device}")


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
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for i, g in enumerate(grads):
        if g.device != dev or g.dtype not in _DTYPE_CODES \
                or not g.is_contiguous():
            raise MXNetError(f"all_finite: leaf {i} must be a contiguous "
                             f"fp32, bf16 or fp16 tensor on {dev}, got "
                             f"{g.dtype} on {g.device}")
        by_dtype.setdefault(g.dtype, []).append(g)
    lib = _build.library("multi_tensor_adam")
    with torch.cuda.device(dev):
        flag.zero_()
        stream = torch.cuda.current_stream(dev).cuda_stream
        # one launch per dtype of the tree (a cast net: one)
        for dt, leaves in by_dtype.items():
            # (0, g, numel): the update kernels' table without the weights
            table = _np.array([(0, g.data_ptr(), g.numel()) for g in leaves],
                              dtype=_np.int64).reshape(-1, 3)
            launches = _np.zeros(1, dtype=_np.int32)   # added to by it
            code = _DTYPE_CODES[dt]
            rc = lib.mx_all_finite(code, table.ctypes.data, len(table),
                                   flag.data_ptr(), launches.ctypes.data,
                                   stream)
            _launched("all_finite", lib, rc, launches,
                      instance=_instance_of(dt))
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
    port, a leaf that is not a contiguous fp32, bf16 or fp16 tensor on the
    first leaf's device, or LAMB over 16-bit leaves (K10 takes fp32 only).
    On the card the last three raise :class:`MXNetError` instead: there
    the loop is the plain version, which runs only when the Trainer was
    built with ``fused=False``.

    16-bit leaves update in their own dtype, lr, wd and the constants
    rounded to it, as the JAX fused update casts its traced scalars to the
    weight's dtype (K8's and K9's 16-bit instances); with
    ``multi_precision`` an fp16 leaf's update runs in fp32 on its master
    weights (the state's first element) and writes the fp16 weight from
    them (the multi_precision instance).

    Host bookkeeping follows the eager classes: every count advances
    before any lr is read; lr (Adam: bias-corrected in Python doubles),
    wd and AdamW's and LAMB's bias-correction denominators round to fp32
    once, as the JAX fused update's (n,) vectors do.  Leaves are grouped
    by those values and by the leaves' dtype and precision mode, one
    kernel call per group: K8 for Adam, K9 for the elementwise rules, K10
    for LAMB."""

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
        names = [p.name for _, p in updatable]
        for name, w, g in zip(names, ws, gs):
            for t in (w, g):
                if t.device != dev or t.dtype not in _DTYPE_CODES \
                        or t.dtype != w.dtype or not t.is_contiguous():
                    if dev.type == "cuda":
                        raise MXNetError(
                            f"the fused update takes contiguous fp32, bf16 "
                            f"or fp16 leaves on {dev}, a gradient of its "
                            f"weight's dtype; {name} has a {t.dtype} "
                            f"tensor on {t.device}: cast it or build the "
                            f"Trainer with fused=False")
                    return False, None
            if rule == "lamb" and w.dtype != torch.float32:
                if dev.type == "cuda":
                    raise MXNetError(
                        f"the fused LAMB update takes fp32 leaves only; "
                        f"{name} is {w.dtype} (K10 at 16 bits: ROADMAP): "
                        f"build the Trainer with fused=False")
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
        # the leaves whose update runs on fp32 masters (JAX's mp_pattern)
        mp = [bool(opt.multi_precision and w.dtype == torch.float16)
              for w in ws]
        groups: Dict[tuple, List[int]] = {}
        for k, (i, _) in enumerate(updatable):
            key = self._group_key(opt, rule, i) + (ws[k].dtype, mp[k])
            groups.setdefault(key, []).append(k)
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
                if len(key) == 6:     # adamw, lamb: c1 and c2
                    hp[j, 1].fill_(key[2])
                    hp[j, 2].fill_(key[3])
                w_g = ([ws[k] for k in ks], [gs[k] for k in ks])
                slots, masters = self._slots(states, updatable, ks, key[-1])
                if rule == "adam":
                    adam_update(*w_g, *slots, hp[j, 0], opt.beta1,
                                opt.beta2, opt.epsilon, opt.rescale_grad,
                                clip, wd, nonfinite=flag, masters=masters)
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
                        nonfinite=flag, masters=masters)
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
    def _slots(states, updatable, ks, mp):
        """The state slots of the leaves ``ks`` (one list per slot) and,
        for ``mp`` leaves, whose state is (master, inner state), their
        masters (else None)."""
        raw = [states[updatable[k][0]] for k in ks]
        masters = [st[0]._data for st in raw] if mp else None
        per_leaf = [_state_list(st[1] if mp else st) for st in raw]
        return ([[leaf[j]._data for leaf in per_leaf]
                 for j in range(len(per_leaf[0]))], masters)


def _state_list(state) -> list:
    """A parameter's state (None, an NDArray or a tuple of them, nested
    once for multi_precision's (master, inner state)) as a flat list of
    NDArrays."""
    if state is None:
        return []
    if isinstance(state, tuple):
        return [x for st in state for x in _state_list(st)]
    return [state]


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
