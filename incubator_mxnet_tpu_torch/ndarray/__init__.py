"""``nd``: the eager NDArray API of the PyTorch port (counterpart of
``incubator_mxnet_tpu/ndarray/``): the array, its creation functions, the
op subset of :mod:`.ops`, the optimizer update ops of
:mod:`.optimizer_ops`, ``random`` and the ``.params`` byte format."""
from .ndarray import (NDArray, arange, array, concatenate, empty, eye, full,
                      linspace, ones, waitall, zeros)
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from . import ops as op  # noqa: F401
from .nn import BatchNorm, GroupNorm, InstanceNorm
from .optimizer_ops import *  # noqa: F401,F403
from .optimizer_ops import __all__ as _opt_all
from . import random, utils  # noqa: F401
from .utils import load, load_frombuffer, save

__all__ = (["NDArray", "array", "zeros", "ones", "empty", "full", "arange",
            "eye", "linspace", "concatenate", "waitall", "random", "op",
            "utils", "save", "load", "load_frombuffer", "BatchNorm",
            "InstanceNorm", "GroupNorm"] + list(_ops_all)
           + list(_opt_all))
