"""Gluon ``Trainer`` (counterpart of ``incubator_mxnet_tpu/gluon/trainer.py``)
on one device.

``step(batch_size)`` rescales the gradients by ``1/batch_size`` and
applies the optimizer to every parameter whose ``grad_req`` is not
'null'.  By default (``fused``, or ``MXNET_FUSED_OPTIMIZER``) that is
:class:`..optimizer.fused.FusedUpdater`: for Adam one K8 launch per
(lr, wd) group on the card; otherwise the per-parameter ``Updater``
loop.  With ``skip_nonfinite`` (or ``MXNET_SKIP_NONFINITE``) a step whose
gradients hold a NaN or an Inf changes no parameter or state and zeroes
the gradients; on the fused path the check and the gating run on the
device, and the skipped step is counted (``mxtpu_skipped_steps``) when
its flag's asynchronous copy has landed, or at
:meth:`sync_nonfinite_guard`.

On one device there is nothing to aggregate: kvstore ``"device"``,
``"local"`` and None are accepted and ``allreduce_grads`` does nothing.
A distributed store, ``update_on_kvstore``, gradient compression and
ZeRO-1 are refused by name (ROADMAP Queue A item 14)."""
from __future__ import annotations

import time as _time

import torch

from ..base import MXNetError, getenv_bool
from .. import fault as _fault
from .. import optimizer as opt_mod
from .. import telemetry as _telemetry
from ..optimizer.fused import FusedUpdater
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_STORES = ("device", "local", None)


def _not_ported(what):
    raise MXNetError(f"Trainer: {what} is not ported yet (one device; "
                     "ROADMAP Queue A item 14)")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, skip_nonfinite=None, fused=None,
                 zero1=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError(
                "params must be a ParameterDict / list of Parameters")
        if kvstore not in _LOCAL_STORES:
            _not_ported(f"kvstore {kvstore!r}")
        if update_on_kvstore:
            _not_ported("update_on_kvstore")
        if compression_params:
            _not_ported("gradient compression")
        if zero1 or (zero1 is None and getenv_bool("MXNET_ZERO1")):
            _not_ported("ZeRO-1 (zero1 / MXNET_ZERO1)")
        if getenv_bool("MXNET_HEALTH_PLANE"):
            raise MXNetError("Trainer: the health plane (MXNET_HEALTH_PLANE) "
                             "is not ported yet (ROADMAP Queue A item 13)")
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p!r}")
        self._params = list(params)
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._skip_nonfinite = getenv_bool("MXNET_SKIP_NONFINITE", False) \
            if skip_nonfinite is None else bool(skip_nonfinite)
        self._fused_requested = getenv_bool("MXNET_FUSED_OPTIMIZER", True) \
            if fused is None else bool(fused)
        self._fused = FusedUpdater(self._updaters) \
            if self._fused_requested else None
        self._updatable = [(i, p) for i, p in enumerate(self._params)
                           if p.grad_req != "null"]
        # guarded fused steps whose skip flag is still on its way back
        self._pending_nonfinite = []

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: p for i, p in enumerate(self._params)}
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and set(optimizer_params) != {"rescale_grad"}:
                raise MXNetError(
                    "optimizer_params must be None when optimizer is an "
                    "Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             param_dict=param_dict,
                                             **optimizer_params)
        self._updaters = opt_mod.get_updater(self._optimizer)

    # ------------------------------------------------------------------
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # ------------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """One optimization step with the gradients rescaled by
        ``1/batch_size``.  Its time is the host's dispatch time: the
        update itself runs on the device behind it."""
        observe = bool(_telemetry.TRAINER.subscribers)
        t0 = _time.perf_counter() if observe else 0.0
        with _telemetry.trace_span("trainer.step", cat="trainer",
                                   batch_size=batch_size):
            self._drain_nonfinite(block=False)
            self._optimizer.rescale_grad = self._scale / batch_size
            self._allreduce_grads()
            if _fault.take("trainer.grad", "nonfinite"):
                self._poison_grads()
            with _telemetry.trace_span("trainer.update", cat="trainer"):
                self._apply(guard=self._skip_nonfinite)
        if observe:
            _telemetry.TRAINER.publish(
                phase="step", seconds=_time.perf_counter() - t0)

    def _drain_nonfinite(self, block=False):
        """Count the skipped steps among the guarded fused steps whose
        flag has come back (all of them, waiting, with ``block``)."""
        keep = []
        for flag in self._pending_nonfinite:
            if not block and not flag.is_ready():
                keep.append(flag)
                continue
            if flag.skipped():
                _telemetry.FAULT.publish(site="trainer.step",
                                         event="skipped_step")
        self._pending_nonfinite = keep

    def sync_nonfinite_guard(self):
        """Wait for every pending guard flag, so ``mxtpu_skipped_steps``
        is exact.  The training loop never needs it; a monitor does."""
        self._drain_nonfinite(block=True)

    def _grads_nonfinite(self) -> bool:
        grads = [p.grad()._data for _, p in self._updatable]
        if not grads:
            return False
        return not bool(torch.stack(
            [torch.isfinite(g).all() for g in grads]).all())

    def _poison_grads(self):
        """Make the first gradient NaN (fault site ``trainer.grad``): the
        deterministic test hook behind the skip guard."""
        if self._updatable:
            self._updatable[0][1].grad()._data.fill_(float("nan"))

    def allreduce_grads(self):
        self._allreduce_grads()

    def _allreduce_grads(self):
        """One device: every gradient is already the whole batch's."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer update alone (no guard), gradients rescaled by
        ``1/batch_size``."""
        observe = bool(_telemetry.TRAINER.subscribers)
        t0 = _time.perf_counter() if observe else 0.0
        with _telemetry.trace_span("trainer.update", cat="trainer"):
            self._optimizer.rescale_grad = self._scale / batch_size
            self._apply(guard=False)
        if observe:
            _telemetry.TRAINER.publish(
                phase="update", seconds=_time.perf_counter() - t0)

    def _apply(self, guard):
        """The fused update where it takes the parameters, else the
        per-parameter loop (with the guard as a host check)."""
        if self._fused is not None:
            done, flag = self._fused.step(self._updatable, guard=guard)
            if done:
                if flag is not None:
                    self._pending_nonfinite.append(flag)
                return
        if guard and self._grads_nonfinite():
            _telemetry.FAULT.publish(site="trainer.step",
                                     event="skipped_step")
            for _, p in self._updatable:
                p.zero_grad()
            return
        for i, p in self._updatable:
            self._updaters(i, p.grad(), p.data())
        _telemetry.gauge("mxtpu_optimizer_dispatches_per_step").set(
            len(self._updatable))

    # ------------------------------------------------------------------
    def get_states(self) -> bytes:
        """The updater's states and the optimizer, pickled."""
        return self._updaters.get_states(dump_optimizer=True)

    def set_states(self, states: bytes):
        """Restore states from :meth:`get_states`."""
        self._updaters.set_states(states)
        self._optimizer = self._updaters.optimizer
        self._optimizer.param_dict = {i: p for i, p in
                                      enumerate(self._params)}

    def save_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self.get_states())

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self.set_states(f.read())
