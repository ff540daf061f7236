"""Asynchronous, preemption-safe checkpointing (counterpart of
``incubator_mxnet_tpu/checkpoint.py``, copied and moved onto the port's
arrays, Trainer and random state):

* **async**: the device-to-host copy happens on the caller's thread (the
  arrays must be snapshotted before the next step changes them), the
  file write on a background thread;
* **atomic**: writes go to a temp file + ``os.replace``;
* **full training state**: ``save(step, params, trainer=..., epoch=...)``
  also snapshots the Trainer's updater and optimizer states and the
  random state (``random.get_state``: every device generator and numpy's),
  committed by a manifest written LAST, so a checkpoint without its
  manifest is incomplete by definition;
* **retried storage**: every publish runs under ``fault.retry_call``
  (site ``checkpoint.write``);
* **retention**: keep the last k checkpoints (default 3), seeded from all
  steps already on disk; orphaned ``*.tmp-<pid>`` files are swept at
  startup;
* **resume**: ``latest_checkpoint``, ``latest_resumable_step``,
  ``restore``, ``restore_full`` and ``restore_into``.

Format: the ``.params`` file is the reference's byte format
(``ndarray/utils.py``), so the JAX package reads the port's and the port
reads the JAX package's.  The ``.states`` file (the Trainer's pickled
states) and the manifest's ``rng`` are the port's own: the manifest names
its writer, and ``restore_into`` refuses a full-state checkpoint written
by the JAX package by name before it touches anything (its ``.states``
pickle holds JAX objects).  ``scaler=`` is refused by name: ``LossScaler``
is ``contrib/amp`` (ROADMAP Queue A item 17)."""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Dict, List, Optional

import numpy as _np

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["AsyncCheckpointer", "latest_checkpoint", "all_checkpoints",
           "latest_resumable_step"]

MANIFEST_FORMAT = 1
WRITER = "incubator_mxnet_tpu_torch"


def _no_scaler(scaler):
    if scaler is not None:
        raise MXNetError("checkpoint: scaler= is not ported (LossScaler is "
                         "contrib/amp, ROADMAP Queue A item 17)")


def _step_path(prefix: str, step: int) -> str:
    return f"{prefix}-{step:07d}.params"


def _states_path(prefix: str, step: int) -> str:
    return f"{prefix}-{step:07d}.states"


def _meta_path(prefix: str, step: int) -> str:
    return f"{prefix}-{step:07d}.meta.json"


def _scan(prefix: str, suffix: str) -> List[int]:
    """Steps for which ``<prefix>-NNNNNNN<suffix>`` exists, sorted."""
    d = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix)
    # exact-prefix anchor: 'm' must not match 'model-*'; 7+ digits so
    # steps >= 10^7 (which format wider than the zero-padding) still parse
    pat = re.compile(rf"^{re.escape(base)}-(\d{{7,}}){re.escape(suffix)}$")
    if not os.path.isdir(d):
        return []
    steps = []
    for name in os.listdir(d):
        m = pat.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def all_checkpoints(prefix: str) -> List[int]:
    """All complete checkpoint steps for ``prefix``, sorted ascending."""
    return _scan(prefix, ".params")


def latest_checkpoint(prefix: str) -> Optional[int]:
    """Newest complete checkpoint step for ``prefix``, or None."""
    steps = all_checkpoints(prefix)
    return steps[-1] if steps else None


def latest_resumable_step(prefix: str) -> Optional[int]:
    """Newest step with a COMMITTED full-state checkpoint: the manifest
    (written last) and the params file it points at must both exist, so
    a write interrupted anywhere short of the manifest publish is
    invisible here."""
    have_params = set(all_checkpoints(prefix))
    for step in reversed(_scan(prefix, ".meta.json")):
        if step in have_params:
            return step
    return None


class AsyncCheckpointer:
    """Background checkpoint writer.

    Usage::

        ckpt = AsyncCheckpointer("ckpt/model", keep=3)
        for step, batch in enumerate(loader):
            ...train...
            if step % 500 == 0:
                ckpt.save(step, {name: p.data() for name, p in params},
                          trainer=trainer)
        ckpt.wait_until_finished()    # before exit
    """

    def __init__(self, prefix: str, keep: int = 3):
        d = os.path.dirname(prefix)
        if d:
            os.makedirs(d, exist_ok=True)
        self._prefix = prefix
        self._keep = max(1, int(keep))
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._sweep_orphans()
        # seed retention from EVERY step already on disk — a restarted
        # run must keep GC-ing its predecessor's checkpoints past `keep`
        self._saved_steps: List[int] = all_checkpoints(prefix)

    def _sweep_orphans(self):
        """Remove ``*.tmp-<pid>`` leftovers of a write that a preemption
        interrupted before its atomic os.replace — otherwise a
        repeatedly-preempted run leaks temp files without bound."""
        d = os.path.dirname(self._prefix) or "."
        base = os.path.basename(self._prefix)
        pat = re.compile(
            rf"^{re.escape(base)}-\d{{7,}}"
            rf"\.(?:params|states|meta\.json)\.tmp-\d+$")
        if not os.path.isdir(d):
            return
        for name in os.listdir(d):
            if pat.match(name):
                try:
                    os.unlink(os.path.join(d, name))
                except OSError:
                    pass

    # ------------------------------------------------------------------
    def save(self, step: int, params: Dict[str, NDArray], trainer=None,
             scaler=None, epoch: Optional[int] = None,
             extra: Optional[dict] = None):
        """Snapshot ``params`` (name -> NDArray, tensor or array; and
        optionally the full training state) and write asynchronously.
        Raises any error from the PREVIOUS save (errors never vanish
        silently).

        With only ``(step, params)`` this writes the single ``.params``
        file.  Passing ``trainer`` / ``epoch`` / ``extra`` upgrades it to
        a full-state checkpoint: the Trainer's updater and optimizer
        states (``Trainer.get_states()``), the random state and ``extra``
        are captured ON THIS THREAD and committed by a ``.meta.json``
        manifest published after all data files.  ``scaler`` raises."""
        _no_scaler(scaler)
        self.wait_until_finished()
        # snapshot on the caller's thread: after return the trainer may
        # mutate the arrays freely
        snap = {}
        for k, v in params.items():
            if isinstance(v, NDArray):
                v = v._data
            if isinstance(v, torch.Tensor):
                # a bf16 leaf stays a tensor: it is written as its raw 16
                # bits (numpy has no bfloat16)
                v = v.detach().cpu().clone()
                snap[k] = v if v.dtype == torch.bfloat16 else v.numpy()
            else:
                snap[k] = _np.asarray(v).copy()
        states = trainer.get_states() if trainer is not None else None
        manifest = None
        if trainer is not None or epoch is not None or extra is not None:
            from . import random as _random
            manifest = {
                "format": MANIFEST_FORMAT,
                "writer": WRITER,
                "step": int(step),
                "rng": _random.get_state(),
                "files": {
                    "params": os.path.basename(
                        _step_path(self._prefix, step)),
                },
            }
            if epoch is not None:
                manifest["epoch"] = int(epoch)
            if states is not None:
                manifest["files"]["states"] = os.path.basename(
                    _states_path(self._prefix, step))
            if extra is not None:
                manifest["extra"] = extra
        self._thread = threading.Thread(
            target=self._write, args=(step, snap, states, manifest),
            daemon=True)
        self._thread.start()

    def save_sync(self, step: int, params: Dict[str, NDArray],
                  **kwargs) -> None:
        """:meth:`save` + :meth:`wait_until_finished` in one call — the
        emergency/preemption path.  A SIGTERM'd training loop (see
        ``lifecycle.shutdown_requested`` and docs/robustness.md) calls
        this at a STEP BOUNDARY so the snapshot is a consistent,
        bit-identically resumable state, and blocks until the manifest
        is committed before exiting."""
        self.save(step, params, **kwargs)
        self.wait_until_finished()

    def _publish(self, path: str, write_fn):
        """tmp-write + atomic rename, with transient storage errors
        absorbed by retry (the injection site fires before any bytes are
        written, so a retried attempt replays cleanly)."""
        from . import fault as _fault
        tmp = f"{path}.tmp-{os.getpid()}"

        def attempt():
            _fault.inject("checkpoint.write")
            write_fn(tmp)
            os.replace(tmp, path)    # atomic publish

        _fault.retry_call(attempt, site="checkpoint.write")

    def _write(self, step: int, snap: Dict[str, _np.ndarray],
               states: Optional[bytes], manifest: Optional[dict]):
        try:
            from .ndarray import utils as nd_utils
            # host numpy straight into the container format — no
            # host->device->host round trip on the background thread
            self._publish(_step_path(self._prefix, step),
                          lambda tmp: nd_utils.save(tmp, snap))
            if states is not None:
                def write_states(tmp, _b=states):
                    with open(tmp, "wb") as f:
                        f.write(_b)
                self._publish(_states_path(self._prefix, step),
                              write_states)
            if manifest is not None:
                # the COMMIT record: published last, so every file it
                # names is already in place when it becomes visible
                def write_meta(tmp, _m=manifest):
                    with open(tmp, "w") as f:
                        json.dump(_m, f, indent=1)
                self._publish(_meta_path(self._prefix, step), write_meta)
            self._saved_steps.append(step)
            self._gc()
        except BaseException as e:   # surfaced on the next save()/wait
            self._error = e

    def _gc(self):
        self._saved_steps.sort()
        while len(self._saved_steps) > self._keep:
            step = self._saved_steps.pop(0)
            for path in (_meta_path(self._prefix, step),
                         _states_path(self._prefix, step),
                         _step_path(self._prefix, step)):
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def wait_until_finished(self):
        """Block until the in-flight write completes; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise MXNetError(f"async checkpoint write failed: {err}") \
                from err

    # ------------------------------------------------------------------
    def restore(self, step: Optional[int] = None,
                ctx=None) -> Dict[str, NDArray]:
        """Load the params at ``step`` (default: newest) onto ``ctx``
        (default: the current context)."""
        from .ndarray import utils as nd_utils
        if step is None:
            step = latest_checkpoint(self._prefix)
            if step is None:
                raise MXNetError(
                    f"no checkpoint found for prefix {self._prefix!r}")
        return nd_utils.load(_step_path(self._prefix, step), ctx=ctx)

    def latest_resumable_step(self) -> Optional[int]:
        return latest_resumable_step(self._prefix)

    def restore_full(self, step: Optional[int] = None, ctx=None) -> dict:
        """Load a full-state checkpoint: the parsed manifest plus
        ``params`` (name -> NDArray on ``ctx``, default the current
        context) and raw ``trainer_states`` bytes (None when the
        checkpoint carried no trainer)."""
        from .ndarray import utils as nd_utils
        if step is None:
            step = self.latest_resumable_step()
            if step is None:
                raise MXNetError(
                    f"no resumable (full-state) checkpoint for prefix "
                    f"{self._prefix!r}")
        meta = _meta_path(self._prefix, step)
        try:
            with open(meta) as f:
                state = json.load(f)
        except OSError as e:
            raise MXNetError(
                f"checkpoint step {step} has no manifest {meta!r} — not "
                f"a full-state checkpoint (use restore())") from e
        state["params"] = nd_utils.load(_step_path(self._prefix, step),
                                        ctx=ctx)
        state["trainer_states"] = None
        if state.get("files", {}).get("states"):
            with open(_states_path(self._prefix, step), "rb") as f:
                state["trainer_states"] = f.read()
        return state

    def restore_into(self, params=None, trainer=None, scaler=None,
                     step: Optional[int] = None) -> Optional[int]:
        """Rehydrate a killed run from the newest complete full-state
        checkpoint (or ``step``): copy the saved arrays into ``params`` (a
        ParameterDict / name -> Parameter mapping), restore the Trainer's
        updater and optimizer states and the random state.  Returns the
        restored step, or None when no full-state checkpoint exists.  A
        checkpoint the port did not write raises :class:`MXNetError`
        before anything is restored."""
        _no_scaler(scaler)
        if step is None:
            step = self.latest_resumable_step()
            if step is None:
                return None
        state = self.restore_full(step, ctx="cpu")
        if state.get("writer") != WRITER:
            raise MXNetError(
                f"checkpoint step {step} is a full-state checkpoint of the "
                f"JAX package (its manifest names no writer "
                f"{WRITER!r}): its .states pickle and rng hold JAX objects "
                f"the port cannot take; restore its parameters with "
                f"restore() instead")
        if params is not None:
            for name, arr in state["params"].items():
                if name in params:
                    params[name].set_data(arr)
        if trainer is not None and state.get("trainer_states"):
            trainer.set_states(state["trainer_states"])
        if state.get("rng"):
            from . import random as _random
            _random.set_state(state["rng"])
        return step
