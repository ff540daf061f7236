"""Base utilities of the PyTorch port: the framework error and the
environment-variable config plane (a copy of ``incubator_mxnet_tpu/base.py``'s
``MXNetError`` and ``getenv*`` helpers, so the port never imports the JAX
package)."""
from __future__ import annotations

import os

__all__ = ["MXNetError", "getenv", "getenv_int", "getenv_float",
           "getenv_bool"]


class MXNetError(RuntimeError):
    """Error raised by the framework (name kept for API parity with
    ``mxnet.base.MXNetError``)."""


def getenv(name: str, default=None):
    """Read a config env var.  ``name`` is the canonical MXNET_* name; the
    MXTPU_* spelling takes precedence when present."""
    alt = name.replace("MXNET_", "MXTPU_", 1) if name.startswith("MXNET_") else None
    if alt is not None and alt in os.environ:
        return os.environ[alt]
    return os.environ.get(name, default)


def getenv_int(name: str, default: int = 0) -> int:
    v = getenv(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise MXNetError(f"env var {name} must be an int, got {v!r}")


def getenv_float(name: str, default: float = 0.0) -> float:
    v = getenv(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        raise MXNetError(f"env var {name} must be a number, got {v!r}")


def getenv_bool(name: str, default: bool = False) -> bool:
    v = getenv(name)
    if v is None or v == "":
        return default
    return str(v).lower() not in ("0", "false", "off", "no", "")
