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

``FusedUpdater``, the Gluon ``Trainer``'s glue (multi-precision masters,
per-parameter lr/wd multipliers, the ``skip_nonfinite`` guard), is not
ported: it waits for the eager Trainer (ROADMAP Queue A item 10)."""
from __future__ import annotations

from typing import Sequence

import numpy as _np
import torch

from ..base import MXNetError
from ..kernels import _build
from ..kernels.flash_attention import _count
from . import cores

__all__ = ["adam_update"]

_RESCALE, _CLIP, _WD = 1, 2, 4     # K8's stage flags (kRescale, kClip, kWd)


def _stages(rescale, clip, wd):
    """(rescale, clip, wd), each None where ``parallel.optim._prep`` skips
    the stage: rescale 1, clip None or 0, wd 0."""
    return (rescale if float(rescale) != 1.0 else None,
            clip if clip else None, wd if wd else None)


def _plain_adam_update(params, grads, ms, vs, lr_t, beta1, beta2, epsilon,
                       rescale, clip, wd):
    r, c, d = _stages(rescale, clip, wd)
    with torch.no_grad():
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


def _multi_tensor_adam_cuda(params, grads, ms, vs, lr_t, beta1, beta2,
                            epsilon, rescale, clip, wd):
    dev = params[0].device
    _check_leaves(dev, params, grads, ms, vs, lr_t)
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
            float(d or 0.0), flags, stream)
    if rc != 0:
        raise MXNetError(f"multi_tensor_adam kernel launch failed: "
                         f"{lib.mx_error_string(rc).decode()} (code {rc})")
    _count("multi_tensor_adam")


def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], lr_t: torch.Tensor, beta1=0.9,
                beta2=0.999, epsilon=1e-8, rescale=1.0, clip=None,
                wd=0.0) -> None:
    """One Adam step of every leaf, in place: per leaf rescale -> clip ->
    fold ``wd * w`` into the gradient (each stage skipped as
    ``parallel.optim`` skips it), then ``cores.adam`` at ``lr_t``, the
    bias-corrected learning rate as a 0-d fp32 tensor on the leaves'
    device.  CPU leaves take the plain per-leaf loop; CUDA leaves one
    launch of K8."""
    n = len(params)
    if not (len(grads) == len(ms) == len(vs) == n):
        raise MXNetError(f"adam_update: {n} params, {len(grads)} grads, "
                         f"{len(ms)} m and {len(vs)} v leaves")
    if n == 0:
        return
    kind = params[0].device.type
    if kind == "cpu":
        _plain_adam_update(params, grads, ms, vs, lr_t, beta1, beta2,
                           epsilon, rescale, clip, wd)
    elif kind == "cuda":
        _multi_tensor_adam_cuda(params, grads, ms, vs, lr_t, beta1, beta2,
                                epsilon, rescale, clip, wd)
    else:
        raise MXNetError(f"adam_update: unsupported device "
                         f"{params[0].device}")
