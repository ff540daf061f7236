"""Random number state (counterpart of ``incubator_mxnet_tpu/random.py``).

Each device has one explicit ``torch.Generator``, created at first use and
seeded from the last :func:`seed` (``MXNET_SEED`` at import, else 0).
``seed(s)`` reseeds every device; ``seed(s, ctx)`` one.  Host randomness
(weight initializers) draws from the CPU generator through
:func:`numpy_rng`, so a seed gives the same weights on the CPU and on the
card.  JAX's threefry stream is not reproduced: a seed gives other
numbers here than in the JAX package."""
from __future__ import annotations

import threading

import numpy as _np
import torch

from .base import getenv_int
from .context import as_context

__all__ = ["seed", "generator", "numpy_rng"]

_lock = threading.Lock()
_seed = getenv_int("MXNET_SEED", 0)
_gens: dict = {}            # torch.device -> torch.Generator


def seed(seed_state: int, ctx="all") -> None:
    """Reseed every device's generator (``ctx='all'``) or one device's."""
    global _seed
    with _lock:
        if ctx == "all":
            _seed = int(seed_state)
            _gens.clear()
        else:
            dev = as_context(ctx).device
            g = torch.Generator(device=dev)
            g.manual_seed(int(seed_state))
            _gens[dev] = g


def generator(ctx=None) -> torch.Generator:
    """The generator of ``ctx``'s device (default: the current
    context)."""
    dev = as_context(ctx).device
    with _lock:
        g = _gens.get(dev)
        if g is None:
            g = _gens[dev] = torch.Generator(device=dev)
            g.manual_seed(_seed)
        return g


def numpy_rng() -> _np.random.RandomState:
    """A numpy ``RandomState`` seeded by a draw from the CPU generator:
    host randomness that follows :func:`seed`."""
    s = int(torch.randint(0, 2 ** 31 - 1, (1,),
                          generator=generator("cpu")))
    return _np.random.RandomState(s)
