"""``CompiledLoop``: k train steps as one program (counterpart of
``incubator_mxnet_tpu/parallel/loop.py``, whose chunk is one donated
``lax.scan`` program).

On the card a chunk of k steps is one CUDA graph per (k, batch key),
captured in the trainer's graph pool:

* the graph holds k static input slots, views of one device buffer,
  filled before each replay by one staged copy (the k batches packed into
  one pinned host buffer, one non-blocking copy) or, for batches already
  on the card (``run(prefetch=True)``: :class:`~..io.DevicePrefetcher`),
  by device copies on the consumer's stream after it waited for the
  prefetcher's copy;
* inside it, each inner step advances the device step counter, so
  ``lr_schedule(step)`` sees the inner step's own value, as the traced
  counter of the JAX scan does;
* with ``skip_nonfinite=True`` each inner step resets and sets the
  all-finite flag inside the graph and hands it to the update kernel
  (K8, K9 or K10), which skips the step where it is set; the skipped
  count is a device int32 summed in the graph and drained after the
  chunk through a recorded event (FAULT ``skipped_step`` events, no host
  sync on the hot path);
* with the health plane on, each inner step writes its stats into row i
  of a (k, n) buffer, handed to the ``HealthMonitor`` once per chunk.

A chunk's first run is eager on a side stream (the real k steps), then
the graph is captured; the work is applied once.  A chunk equals k
:meth:`~.spmd.SPMDTrainer.step` calls bit for bit: the same kernels in
the same order, the same RNG draws per inner step.  On the CPU the chunk
body runs uncaptured.

A cast net runs in 16 bits where the rule keeps its dtypes (sgd, nag,
rmsprop, adagrad without a schedule).  A rule that promotes them (adam,
adamw, lamb, or any ``lr_schedule``) would change the dtypes of the
values between a chunk's steps, which a chunk cannot carry: the JAX scan
raises there (its carry's input and output types differ), and so does
:meth:`CompiledLoop.step_chunk`, naming the dtype change.

Checkpoint and resume: :meth:`CompiledLoop.get_states` and
:meth:`CompiledLoop.set_states` round-trip the step counter, the skipped
count and the optimizer state through ``AsyncCheckpointer(trainer=...)``,
so a run saved mid-chunk (step 6 of k = 4) resumes bit for bit."""
from __future__ import annotations

import pickle
import time as _time
from typing import Dict, List

import numpy as _np
import torch

from ..base import MXNetError, getenv_int
from .. import telemetry as _telemetry
from ..cuda_graphs import HostCopy
from ..io.prefetch import DevicePrefetcher
from .spmd import SPMDTrainer, _as_tensor

__all__ = ["CompiledLoop"]

_ALIGN = 16     # bytes: each slot's offset in the staged buffer


class _ChunkProgram:
    """One (k, batch key) chunk on the card: its k x nb static input slots
    (typed views of one device byte buffer, with a pinned host twin for
    the one staged copy), the event after their last refill, and once
    captured the graph, its outputs ((k,) losses, the int32 skipped
    count) and the kernel launches it holds."""

    def __init__(self, kc, shapes, device, dtypes=()):
        self.key = shapes           # the batch key, for messages
        self.dtypes = dtypes        # the values' and the state's dtypes
        self.kc = kc
        offs, total = [], 0
        for _ in range(kc):
            row = []
            for shape, dtype in shapes:
                row.append(total)
                nb = int(_np.prod(shape, dtype=_np.int64)) \
                    * torch.empty((), dtype=dtype).element_size()
                total += -(-nb // _ALIGN) * _ALIGN
            offs.append(row)
        total = max(total, _ALIGN)
        self.dbuf = torch.empty(total, dtype=torch.uint8, device=device)
        self.hbuf = torch.empty(total, dtype=torch.uint8, pin_memory=True)

        def views(buf):
            return [[_typed(buf, off, shape, dtype)
                     for off, (shape, dtype) in zip(row, shapes)]
                    for row in offs]
        self.slots = views(self.dbuf)
        self.host = views(self.hbuf)
        self.copied = torch.cuda.Event()
        self.graph = None
        self.error = None
        self.loss = None            # the captured (losses, skipped)
        self.tally: Dict[str, int] = {}
        self.replays = 0
        self.flops = 0.0

    def stage(self, batches) -> None:
        """Fill the slots from ``batches`` (kc lists of tensors): host
        arrays through the pinned buffer and one copy, device tensors by
        device copies.  The pinned buffer is rewritten only once the card
        has read its previous contents."""
        self.copied.synchronize()
        flat_src = [t for row in batches for t in row]
        flat_dst = [t for row in self.slots for t in row]
        if all(t.device.type == "cpu" for t in flat_src):
            for h, t in zip((t for row in self.host for t in row), flat_src):
                h.copy_(t)
            self.dbuf.copy_(self.hbuf, non_blocking=True)
        else:
            torch._foreach_copy_(flat_dst, [t.to(d.device, non_blocking=True)
                                            for t, d in zip(flat_src,
                                                            flat_dst)])
        self.copied.record()


def _typed(buf, off, shape, dtype):
    nb = int(_np.prod(shape, dtype=_np.int64)) \
        * torch.empty((), dtype=dtype).element_size()
    return buf[off:off + nb].view(dtype).view(shape)


class CompiledLoop(SPMDTrainer):
    """``loop_steps`` train steps as one program::

        loop = CompiledLoop(net, loss_fn, "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9},
                            loop_steps=8, mesh=mesh)
        losses = loop.run(batches)      # prefetch + chunked dispatch

    or chunks by hand with :meth:`step_chunk`.  ``step`` (inherited) still
    works, and a k-chunk equals k single steps bit for bit."""

    _site = "loop"

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 loop_steps=None, skip_nonfinite=False, **kwargs):
        self.loop_steps = int(loop_steps) if loop_steps is not None \
            else getenv_int("MXNET_LOOP_STEPS", 8)
        if self.loop_steps < 1:
            raise MXNetError(f"loop_steps={self.loop_steps} must be >= 1")
        super().__init__(net, loss_fn, optimizer, optimizer_params,
                         **kwargs)
        if self._accum != 1:
            raise MXNetError(
                "CompiledLoop does not compose with accum_steps yet — "
                "fold the accumulation into loop_steps instead")
        self._skip_nonfinite = bool(skip_nonfinite)
        self._skipped_total = 0
        # device skip counts, one per guarded chunk, drained when their
        # copy has landed: no host sync on the hot path
        self._pending_skipped: List[HostCopy] = []
        self._flag = torch.zeros(1, dtype=torch.int32,
                                 device=self._mesh.device)
        self._chunks: Dict[tuple, _ChunkProgram] = {}

    def _stat_rows(self) -> int:
        return self.loop_steps

    # ------------------------------------------------------------------
    def _chunk_body(self, inputs):
        """``len(inputs)`` train steps on device tensors, each with its own
        step count, guard and stat row: what a chunk graph captures.
        Returns ((k,) losses in the loss's dtype, the int32 count of
        skipped steps)."""
        dev = self._mesh.device
        kc = len(inputs)
        losses = None
        skipped = torch.zeros((), dtype=torch.int32, device=dev)
        guard = self._flag if self._skip_nonfinite else None
        for i, xs in enumerate(inputs):
            # the flag is reset inside each inner step's check, so a
            # skipped step never leaks into the next one
            loss = self._train_step(xs, row=i, guard=guard)
            if losses is None:     # in the loss's dtype, as the scan's
                losses = torch.empty(kc, dtype=loss.dtype, device=dev)
            losses[i].copy_(loss)
            if guard is not None:
                skipped.add_(guard[0])
            del loss
        return losses, skipped

    # ------------------------------------------------------------------
    def step_chunk(self, batches):
        """Run ``len(batches)`` consecutive train steps as one program.
        ``batches`` is a sequence of per-step batch tuples (what
        :meth:`step` takes, one shape).  Returns the (k,) per-step losses
        as a tensor on the device, without waiting for them."""
        kc = len(batches)
        if kc == 0:
            raise MXNetError("step_chunk needs at least one batch")
        nb = len(batches[0])
        if nb < 2 or any(len(b) != nb for b in batches):
            raise MXNetError("step_chunk takes batches of (*inputs, label), "
                             "each with the same number of arrays")
        self._refuse_promotion()
        observe = bool(_telemetry.TRAINER.subscribers)
        t0 = _time.perf_counter()
        cuda = self._mesh.device.type == "cuda"
        step0 = self._step_count
        with _telemetry.trace_span("loop.chunk", cat="trainer"):
            with _telemetry.trace_span("loop.place", cat="transfer"):
                arrs = [[_as_tensor(a) for a in b] for b in batches]
                keys = {self._build_key(row) for row in arrs}
                if len(keys) != 1:
                    raise MXNetError("step_chunk: every batch of a chunk "
                                     "must have the same shapes and dtypes")
                bkey = keys.pop()
                dkey = self._dtype_key()
                key = (kc, nb) + bkey
                if cuda:
                    # as SPMDTrainer's: replaced at other dtypes
                    prog = self._chunks.get(key)
                    if prog is None or prog.dtypes != dkey:
                        prog = self._chunks[key] = _ChunkProgram(
                            kc, bkey, self._mesh.device, dkey)
                    if prog.error is not None and not self._eager:
                        raise MXNetError(prog.error)
                    prog.stage(arrs)
                else:
                    inputs = [[self._place(a) for a in row] for row in arrs]
            self._step_count += kc
            if not cuda:
                losses, skipped = self._cpu_run(
                    key + (dkey,), lambda: self._chunk_body(inputs))
            elif self._eager:
                losses, skipped = self._chunk_body(prog.slots)
            elif prog.graph is None:
                losses, skipped = self._first_run(
                    prog, lambda: self._chunk_body(prog.slots),
                    f"a chunk of {kc} steps")
            else:
                self._replay(prog)
                # the graph's outputs are overwritten by the next replay
                losses, skipped = prog.loss[0].clone(), prog.loss[1]
            if self._health is not None:
                self._health.submit(step0, kc, self._stats.rows_of(kc))
        self._ledger.record(_time.perf_counter() - t0)
        # k steps rode one dispatch: the ledger's "loop" row grows by one
        # while the step counter grows by k
        _telemetry.gauge("mxtpu_optimizer_dispatches_per_step").set(
            1.0 / kc)
        if self._skip_nonfinite:
            self._pending_skipped.append(HostCopy(skipped))
            self._drain_skipped(block=False)
        if observe:
            dt = _time.perf_counter() - t0
            _telemetry.TRAINER.publish(phase="step", seconds=dt, steps=kc,
                                       event=self._boundary_event())
            _telemetry.TRAINER.publish(phase="chunk", seconds=dt, steps=kc)
        return losses

    def _refuse_promotion(self) -> None:
        """Raise where the rule would change the values' dtypes inside a
        chunk (the JAX scan's carry-type error)."""
        dts = {p.dtype for _, p in self._trainable}
        half = sorted(str(d).replace("torch.", "") for d in dts
                      if d in (torch.bfloat16, torch.float16))
        if half and self._opt.promotes:
            raise MXNetError(
                f"CompiledLoop: the update promotes the {', '.join(half)} "
                f"values to float32 (its fp32 learning rate or bias "
                f"corrections, as in the JAX step), so a step's carry "
                f"output (float32) would differ from its input "
                f"({', '.join(half)}); a chunk keeps one dtype: use a rule "
                f"that keeps the net's dtype, or SPMDTrainer.step")

    def run(self, data, steps=None, prefetch=True, buffers=None):
        """Chunked training over an iterable of batch tuples (a list, a
        generator, a data loader or a :class:`DevicePrefetcher`).  With
        ``prefetch`` the iterable is wrapped in a ``DevicePrefetcher`` on
        the trainer's device, so fetching and placing the next batches
        overlaps the current chunk.  ``steps`` caps the number of steps
        (None: until the data ends); a short tail runs as a smaller chunk.
        Returns the per-step losses as a numpy array (the only host sync,
        at the end; a bf16 net's as their exact fp32 values)."""
        owned = None
        if prefetch and not isinstance(data, DevicePrefetcher):
            owned = DevicePrefetcher(data, buffers=buffers,
                                     device=self._mesh.device)
            source = iter(owned)
        else:
            source = iter(data)
        losses = []
        done = 0
        try:
            while steps is None or done < steps:
                want = self.loop_steps if steps is None \
                    else min(self.loop_steps, steps - done)
                chunk = []
                with _telemetry.trace_span("loop.next_batch",
                                           cat="dataloader"):
                    for _ in range(want):
                        try:
                            chunk.append(next(source))
                        except StopIteration:
                            break
                if not chunk:
                    break
                losses.append(self.step_chunk(chunk))
                done += len(chunk)
        finally:
            if owned is not None:
                owned.close()
        if self._skip_nonfinite:
            self.sync_nonfinite_guard()
        self.sync_health()
        if not losses:
            return _np.zeros((0,), _np.float32)
        out = torch.cat(losses).cpu()
        # numpy has no bfloat16: a bf16 net's losses come back as their
        # exact fp32 values
        return (out.float() if out.dtype == torch.bfloat16 else out).numpy()

    def reload_params(self):
        super().reload_params()
        self._chunks.clear()

    # ------------------------------------------------------------------
    # the non-finite guard's count, drained at chunk boundaries
    def _drain_skipped(self, block=False):
        rest = []
        for count in self._pending_skipped:
            if block or count.ready():
                n = int(count.wait()[0])
                if n:
                    self._skipped_total += n
                    for _ in range(n):
                        _telemetry.FAULT.publish(site="loop.step",
                                                 event="skipped_step")
            else:
                rest.append(count)
        self._pending_skipped = rest

    def sync_nonfinite_guard(self):
        """Wait for every pending chunk's skip count; returns the skipped
        steps so far."""
        self._drain_skipped(block=True)
        return self._skipped_total

    @property
    def skipped_steps(self):
        """Skipped (non-finite) steps drained so far: exact after
        :meth:`sync_nonfinite_guard`."""
        return self._skipped_total

    # ------------------------------------------------------------------
    # the checkpoint protocol (AsyncCheckpointer trainer=)
    def get_states(self) -> bytes:
        """The loop's progress and optimizer state, for
        ``AsyncCheckpointer.save(..., trainer=loop)``."""
        self._drain_skipped(block=True)
        state = {name: [t.detach().cpu().numpy().copy() for t in leaves]
                 for name, leaves in self._opt_state.items()}
        return pickle.dumps({"loop": 1, "step": self._step_count,
                             "skipped": self._skipped_total,
                             "opt_state": state})

    def set_states(self, data: bytes) -> None:
        """Restore :meth:`get_states` (``restore_into(..., trainer=loop)``
        calls it), in place: captured programs keep their addresses.  Call
        :meth:`reload_params` after the checkpoint wrote the restored
        weights into the net."""
        st = pickle.loads(data)
        if not isinstance(st, dict) or st.get("loop") != 1:
            raise MXNetError(
                "checkpoint trainer states are not a CompiledLoop blob "
                "(saved from a different trainer type?)")
        saved = st["opt_state"]
        if sorted(saved) != sorted(self._opt_state) or any(
                len(saved[k]) != len(v) for k, v in self._opt_state.items()):
            raise MXNetError("checkpoint optimizer state does not match this "
                             "loop's optimizer")
        with torch.no_grad():
            for name, leaves in self._opt_state.items():
                for t, a in zip(leaves, saved[name]):
                    if tuple(t.shape) != tuple(a.shape):
                        raise MXNetError(
                            f"checkpoint optimizer state {name}: shape "
                            f"{tuple(a.shape)} != {tuple(t.shape)}")
                    t.copy_(torch.from_numpy(_np.ascontiguousarray(a)))
            self._step_count = int(st["step"])
            self._step_dev.fill_(self._step_count)
        self._skipped_total = int(st.get("skipped", 0))
        self._pending_skipped = []
