"""Random number state (counterpart of ``incubator_mxnet_tpu/random.py``).

Each device has one explicit ``torch.Generator``, created at first use and
seeded from the last :func:`seed` (``MXNET_SEED`` at import, else 0).
``seed(s)`` reseeds every device; ``seed(s, ctx)`` one.  Host randomness
(weight initializers) draws from the CPU generator through
:func:`numpy_rng`, so a seed gives the same weights on the CPU and on the
card; dropout masks (``nd.dropout``, ``gluon.nn.Dropout``) draw from the
generator of their input's device.  JAX's threefry stream is not
reproduced: a seed gives other numbers here than in the JAX package.

A device's generator stays the same object for the life of the process:
:func:`seed` and :func:`set_state` change its state in place.  A CUDA
graph registers the generator of its device when it is captured
(``cuda_graphs.capture``), and each replay then draws from its state at
that moment, as an eager run would, and advances it.

:func:`get_state`/:func:`set_state` snapshot and restore every device's
generator, the seed new generators take, and numpy's global generator
(``np.random``, which data pipelines draw from) in a JSON-safe form: the
checkpoint manifest's ``rng``."""
from __future__ import annotations

import base64
import threading

import numpy as _np
import torch

from .base import getenv_int
from .context import as_context

__all__ = ["seed", "generator", "numpy_rng", "get_state", "set_state"]

_lock = threading.Lock()
_seed = getenv_int("MXNET_SEED", 0)
_gens: dict = {}            # torch.device -> torch.Generator


def seed(seed_state: int, ctx="all") -> None:
    """Reseed every device's generator (``ctx='all'``; the generators made
    later take this seed too) or one device's."""
    global _seed
    with _lock:
        if ctx == "all":
            _seed = int(seed_state)
            for g in _gens.values():
                g.manual_seed(_seed)
        else:
            _get(as_context(ctx).device).manual_seed(int(seed_state))


def _get(dev: torch.device) -> torch.Generator:
    """``dev``'s generator, made and seeded now if it is the first use;
    the caller holds ``_lock``."""
    g = _gens.get(dev)
    if g is None:
        g = _gens[dev] = torch.Generator(device=dev)
        g.manual_seed(_seed)
    return g


def generator(ctx=None) -> torch.Generator:
    """The generator of ``ctx``'s device (default: the current
    context)."""
    dev = as_context(ctx).device
    with _lock:
        return _get(dev)


def numpy_rng() -> _np.random.RandomState:
    """A numpy ``RandomState`` seeded by a draw from the CPU generator:
    host randomness that follows :func:`seed`."""
    s = int(torch.randint(0, 2 ** 31 - 1, (1,),
                          generator=generator("cpu")))
    return _np.random.RandomState(s)


def _device_name(dev: torch.device) -> str:
    return f"{dev.type}:{dev.index or 0}"


def get_state() -> dict:
    """A JSON-safe snapshot of the random state: the seed new generators
    take, each device generator's state (base64 of its bytes, keyed
    ``"cpu:0"``/``"cuda:i"``) and numpy's global generator."""
    with _lock:
        gens = {_device_name(dev): base64.b64encode(
            g.get_state().numpy().tobytes()).decode("ascii")
            for dev, g in _gens.items()}
        seed_now = _seed
    kind, keys, pos, has_gauss, cached = _np.random.get_state()
    return {"format": "torch", "seed": seed_now, "generators": gens,
            "numpy": {"kind": kind, "keys": [int(k) for k in keys],
                      "pos": int(pos), "has_gauss": int(has_gauss),
                      "cached_gaussian": float(cached)}}


def set_state(state: dict) -> None:
    """Restore a :func:`get_state` snapshot, in place: each generator of
    the snapshot takes its state, and one absent from it the snapshot's
    seed, as if it were made after it (the captured picture comes back
    exactly).  A snapshot of the JAX package's key streams is refused by
    name."""
    from .base import MXNetError
    if not isinstance(state, dict) or state.get("format") != "torch":
        raise MXNetError(
            "random.set_state: not a state of the PyTorch port (a JAX "
            "package key-stream snapshot holds threefry keys, which the "
            "port's generators cannot take)")
    global _seed
    gens = {}
    for name, data in state["generators"].items():
        kind, _, idx = name.partition(":")
        dev = torch.device(kind, int(idx or 0)) if kind == "cuda" \
            else torch.device("cpu")
        gens[dev] = torch.frombuffer(bytearray(base64.b64decode(data)),
                                     dtype=torch.uint8)
    np_state = state["numpy"]
    _np.random.set_state((np_state["kind"],
                          _np.array(np_state["keys"], dtype=_np.uint32),
                          np_state["pos"], np_state["has_gauss"],
                          np_state["cached_gaussian"]))
    with _lock:
        _seed = int(state["seed"])
        for dev in set(_gens) | set(gens):
            g = _get(dev)
            if dev in gens:
                g.set_state(gens[dev])
            else:
                g.manual_seed(_seed)
