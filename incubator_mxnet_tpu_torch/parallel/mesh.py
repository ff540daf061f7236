"""Device meshes (counterpart of ``incubator_mxnet_tpu/parallel/mesh.py``).
Only the one-device mesh is ported: ``make_mesh({"data": 1})`` (or
``{"data": -1}`` over one device).  Any mesh over more than one device
raises."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """Named axes over one device: ``axis_names``, ``shape`` (axis ->
    size, every size 1) and ``device``."""

    def __init__(self, axis_names: Tuple[str, ...], device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = {a: 1 for a in self.axis_names}
        self.device = device

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """A mesh with named ``axes`` ({name: size}; -1 for "all the rest")
    over ``devices`` (default ``[cuda:0]``).  Every axis must come to size
    1 over one device."""
    devs = [resolve_device(None)] if devices is None \
        else [resolve_device(d) for d in devices]
    sizes = {a: (len(devs) if s == -1 else int(s)) for a, s in axes.items()}
    if len(devs) != 1 or any(s != 1 for s in sizes.values()):
        raise MXNetError(f"mesh {sizes} over {len(devs)} device(s) is not "
                         "ported: only a one-device mesh, e.g. "
                         "make_mesh({'data': 1})")
    return Mesh(tuple(axes), devs[0])
