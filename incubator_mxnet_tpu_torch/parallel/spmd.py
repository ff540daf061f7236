"""The train step on one device (counterpart of
``incubator_mxnet_tpu/parallel/spmd.py``'s ``SPMDTrainer``, to the
semantics of its ``_make_loss_of``, ``_build_step`` and ``_step_impl``).

One :meth:`SPMDTrainer.step` is the forward of the net over the batch, the
loss block over every output of the net and the label, the mean of that
loss, the backward and the functional optimizer's update of every
trainable parameter, in place.  It returns the loss as a 0-d tensor on the
device without waiting for it.  The step count is 1-based.  Pipelining,
ZeRO-1, gradient accumulation, sharding rules and the health plane are
not ported: asking for any of them raises :class:`MXNetError`."""
from __future__ import annotations

from typing import Dict

import numpy as _np
import torch

from ..base import MXNetError, getenv_bool
from ..gluon.nn import mx_named_parameters
from . import optim as fopt

__all__ = ["SPMDTrainer"]


def _not_ported(what):
    raise MXNetError(f"SPMDTrainer: {what} is not ported yet (one device, "
                     "no sharding, one batch per step)")


class SPMDTrainer:
    """Compile-free train step of a net, a loss block and a functional
    optimizer over a one-device mesh::

        mesh = parallel.make_mesh({"data": 1})
        trainer = SPMDTrainer(net, loss_fn, "adam",
                              {"learning_rate": 1e-4}, mesh=mesh)
        loss = trainer.step(ids, types, labels)   # no host sync

    The net's parameters must live on the mesh's device; the step updates
    them in place."""

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, data_axis="data", sharding_rules=None,
                 extra_input_shardings=None, donate=True,
                 shard_optimizer_state=False, zero1=None,
                 pipeline_axis=None, pipeline_microbatches=None,
                 pipeline_schedule=None, accum_steps=None):
        if pipeline_axis is not None or pipeline_microbatches is not None \
                or pipeline_schedule is not None:
            _not_ported("pipelining (pipeline_axis)")
        if zero1 or (zero1 is None and getenv_bool("MXNET_ZERO1")):
            _not_ported("ZeRO-1 (zero1)")
        if shard_optimizer_state:
            _not_ported("shard_optimizer_state")
        if sharding_rules is not None or extra_input_shardings is not None:
            _not_ported("sharding rules")
        if accum_steps not in (None, 1):
            _not_ported("gradient accumulation (accum_steps)")
        if getenv_bool("MXNET_HEALTH_PLANE"):
            _not_ported("the health plane (MXNET_HEALTH_PLANE)")
        if mesh is None:
            raise MXNetError("SPMDTrainer needs a mesh (parallel.make_mesh)")
        if data_axis not in mesh.axis_names:
            raise MXNetError(f"data axis {data_axis!r} not in the mesh's "
                             f"axes {mesh.axis_names}")
        self._net = net
        self._loss = loss_fn
        self._mesh = mesh
        self._data_axis = data_axis
        self._opt = fopt.create(optimizer, **(optimizer_params or {}))
        named = mx_named_parameters(net)
        for name, p in named:
            if p.device != mesh.device:
                raise MXNetError(f"parameter {name} is on {p.device}, the "
                                 f"mesh on {mesh.device}")
        self._trainable = [(n, p) for n, p in named if p.requires_grad]
        self._opt_state = self._opt.init([p for _, p in self._trainable])
        self._step_count = 0

    @property
    def mesh(self):
        return self._mesh

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """``{MXNet name: parameter}`` of the trainable parameters (the
        net's own tensors, updated in place by each step)."""
        return {n: p for n, p in self._trainable}

    def _place(self, arr):
        """A batch array (numpy or tensor) as a tensor on the device."""
        if isinstance(arr, torch.Tensor):
            return arr.to(self._mesh.device)
        return torch.from_numpy(_np.ascontiguousarray(arr)).to(
            self._mesh.device)

    def _loss_and_grads(self, *batch):
        """The step's loss and the gradient of every trainable parameter
        (in :attr:`params` order), without the update.  The net runs in
        training mode, as under ``autograd.record``."""
        *xs, label = (self._place(b) for b in batch)
        params = [p for _, p in self._trainable]
        was_training = self._net.training
        self._net.train()
        try:
            outs = self._net(*xs)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            # multi-output nets (MLM + NSP heads) pass every output to the
            # loss block: loss(out0, out1, ..., label)
            loss = self._loss(*outs, label).mean()
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            self._net.train(was_training)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss.detach(), grads

    def step(self, *batch) -> torch.Tensor:
        """One train step over ``batch`` = (*inputs, label); returns the
        mean loss as a 0-d tensor on the device (no host sync)."""
        loss, grads = self._loss_and_grads(*batch)
        self._step_count += 1
        self._opt.update([p for _, p in self._trainable], grads,
                         self._opt_state, self._step_count)
        return loss

    def sync_to_block(self):
        """Nothing to copy: the step updates the net's parameters in
        place (kept for the JAX package's API)."""
