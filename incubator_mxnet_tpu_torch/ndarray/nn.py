"""The normalisation ops of the reference's ``ndarray/nn.py``
(``incubator_mxnet_tpu/ndarray/nn.py``) in the PyTorch port:
``BatchNorm``, ``InstanceNorm`` and ``GroupNorm``, over NDArrays, and the
tensor functions the Gluon layers call.

They are XLA ops in the JAX package, not Pallas kernels: plain PyTorch is
their port.  The arithmetic is JAX's, not ``F.batch_norm``'s: the batch
variance is the biased mean of squared deviations, the output is
``(x - mean) * (gamma / sqrt(var + eps)) + beta``, ``fix_gamma`` uses
ones for gamma, ``use_global_stats`` normalises with the moving
statistics, and any ``axis`` is the channel axis.  The op returns the
batch statistics with ``output_mean_var`` and never updates the moving
ones: the layer does, through ``gluon.block.update_aux``."""
from __future__ import annotations

import torch

from ..base import MXNetError
from .ndarray import _invoke

__all__ = ["BatchNorm", "InstanceNorm", "GroupNorm", "batch_norm",
           "instance_norm", "group_norm"]


def _channel_shape(x, ax):
    return tuple(x.shape[ax] if i == ax else 1 for i in range(x.dim()))


def batch_norm(x, gamma, beta, moving_mean=None, moving_var=None,
               eps=1e-5, fix_gamma=True, use_global_stats=False, axis=1):
    """(out, mean, var) over tensors: the batch statistics over every axis
    but ``axis``, or with ``use_global_stats`` the moving ones (returned
    as they are)."""
    ax = axis if axis >= 0 else x.dim() + axis
    if not 0 <= ax < x.dim():
        raise MXNetError(f"BatchNorm: axis {axis} out of range for "
                         f"{x.dim()} dimensions")
    bshape = _channel_shape(x, ax)
    red = tuple(i for i in range(x.dim()) if i != ax)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if use_global_stats:
        mean, var = moving_mean, moving_var
    else:
        mean = x.mean(dim=red)
        var = ((x - mean.reshape(bshape)) ** 2).mean(dim=red)
    inv = 1.0 / torch.sqrt(var + eps)
    out = (x - mean.reshape(bshape)) * (g * inv).reshape(bshape) \
        + beta.reshape(bshape)
    return out, mean, var


def instance_norm(x, gamma, beta, eps=1e-3):
    """Normalise each (n, c) over the spatial axes (2 onwards)."""
    axes = tuple(range(2, x.dim()))
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


def group_norm(x, gamma, beta, num_groups=1, eps=1e-5):
    """Normalise each of ``num_groups`` channel groups of each sample."""
    n, c = x.shape[0], x.shape[1]
    if c % num_groups:
        raise MXNetError(f"GroupNorm: {c} channels do not split into "
                         f"{num_groups} groups")
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=axes, keepdim=True)
    out = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


def BatchNorm(data, gamma, beta, moving_mean=None, moving_var=None,
              eps=1e-5, momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, **_ignored):
    """Batch normalisation (the reference's op; ``momentum`` is the
    layer's business).  With ``output_mean_var``: [out, mean, var]."""
    if use_global_stats:
        if moving_mean is None or moving_var is None:
            raise MXNetError("BatchNorm: use_global_stats needs moving_mean "
                             "and moving_var")
        res = _invoke(lambda x, g, b, mm, mv: batch_norm(
            x, g, b, mm, mv, eps, fix_gamma, True, axis),
            [data, gamma, beta, moving_mean, moving_var], name="BatchNorm")
    else:
        res = _invoke(lambda x, g, b: batch_norm(
            x, g, b, None, None, eps, fix_gamma, False, axis),
            [data, gamma, beta], name="BatchNorm")
    return res if output_mean_var else res[0]


def InstanceNorm(data, gamma, beta, eps=1e-3, **_ignored):
    return _invoke(lambda x, g, b: instance_norm(x, g, b, eps),
                   [data, gamma, beta], name="InstanceNorm")


def GroupNorm(data, gamma, beta, num_groups=1, eps=1e-5, **_ignored):
    return _invoke(lambda x, g, b: group_norm(x, g, b, num_groups, eps),
                   [data, gamma, beta], name="GroupNorm")
