"""``nd.random``: samplers over the device generators of
:mod:`..random` (counterpart of ``incubator_mxnet_tpu/ndarray/random.py``:
``uniform``, ``normal``, ``randn``, ``randint``)."""
from __future__ import annotations

import torch

from .. import random as _random
from .ndarray import NDArray, _device, torch_dtype

__all__ = ["uniform", "normal", "randn", "randint"]


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None, **kw):
    dev = _device(ctx)
    u = torch.rand(_shape(shape), generator=_random.generator(dev),
                   device=dev, dtype=torch_dtype(dtype))
    return NDArray(low + (high - low) * u)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None, **kw):
    dev = _device(ctx)
    z = torch.randn(_shape(shape), generator=_random.generator(dev),
                    device=dev, dtype=torch_dtype(dtype))
    return NDArray(loc + scale * z)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape, dtype=dtype, ctx=ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, **kw):
    dev = _device(ctx)
    return NDArray(torch.randint(low, high, _shape(shape),
                                 generator=_random.generator(dev),
                                 device=dev, dtype=torch_dtype(dtype)))
