"""The train step on one device (counterpart of
``incubator_mxnet_tpu/parallel/spmd.py``'s ``SPMDTrainer``, to the
semantics of its ``_make_loss_of``, ``_make_grad_fn``, ``_build_step``,
``_step_impl`` and ``_build_key``).

One :meth:`SPMDTrainer.step` is the forward of the net over the batch, the
loss block over every output of the net and the label, the mean of that
loss, the backward and the functional optimizer's update of every
trainable parameter, in place.  With ``accum_steps = k > 1`` the batch is
split into k interleaved microbatches (JAX's ``reshape(B // k, k, ...)``
and leading-axis swap); their gradients are summed, then divided by k,
and the loss is the mean of the k losses.  The step returns the loss as a
0-d tensor on the device without waiting for it.  The step count is
1-based and also lives on the device, where the update reads it.

On the card the JAX step's one program is one CUDA graph per batch key
(the shapes and dtypes of the batch arrays): the step counter, every
microbatch's forward and backward and the whole-tree update (one call of
kernel K8, K9 or K10, by the rule).  A key's first step runs eagerly on
a side stream (the real step, and the warm-up the capture needs); the
graph is captured right after it, which runs nothing, and every later
step of the key refills the key's static input buffers in place (from
pinned host memory) and replays the graph.  A failed capture raises
:class:`MXNetError` naming the key; there is no eager path on the card
after a key's first step.  All of a trainer's graphs share one memory
pool.  The CPU runs the same body uncaptured.

With ``MXNET_HEALTH_PLANE=1`` the step also writes the health plane's
statistics (``health.StepStats``: per-leaf gradient norms, the finite
mask, update ratios, the global norm and the loss) into static device
buffers as extra outputs of the captured step; at the step boundary the
trainer's ``HealthMonitor`` queues a non-blocking copy of them and folds
whatever copy has landed (a recorded event's ``query()``), so the hot
path never waits.  The parameters come out bit for bit as with the plane
off.

Each program's FLOPs are counted from shapes once, on the eager run that
precedes its capture (``cuda_graphs.counted``), and every later dispatch
publishes the stored count on the telemetry ``COST`` topic: the MFU
collector's feed.

A cast net (``net.cast("bfloat16")``) trains with the JAX step's dtypes
(``parallel.optim``): a rule that keeps them (sgd, nag, rmsprop, adagrad
without a schedule) runs every step in 16 bits; a rule that promotes them
(adam, adamw, lamb) writes fp32 values and bf16 moments at the first
step and makes everything fp32 at the second; on a float16 net its step
raises :class:`MXNetError` (``optimizer/fused.py`` ``FP16_PROMOTION``).  A program holds the
dtypes of the trainable values and of the optimizer state it was built
at, beside its batch key (a new dtype re-traces the JAX step), and one of
other dtypes is replaced, never replayed: a step whose run changes those
dtypes runs eagerly, kernels launched, and is never captured; the graph
is captured after the first step that leaves them as they were.

Pipelining, ZeRO-1 and sharding rules are not ported: asking for any of
them raises :class:`MXNetError`."""
from __future__ import annotations

import contextlib
import time
import weakref
from typing import Dict, List, Tuple

import numpy as _np
import torch

from .. import cuda_graphs as _graphs
from .. import health as _health
from .. import telemetry as _telemetry
from .. import telemetry_device as _tdev
from ..base import MXNetError, getenv_bool
from ..gluon.nn import mx_named_parameters
from ..kernels.flash_attention import add_launches
from ..optimizer import fused as _fused
from . import optim as fopt

__all__ = ["SPMDTrainer"]


def _not_ported(what):
    raise MXNetError(f"SPMDTrainer: {what} is not ported yet (one device, "
                     "no sharding)")


def microbatches(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a`` (B, ...) as k interleaved microbatches (k, B // k, ...):
    microbatch i holds rows i, i + k, i + 2k, ... (JAX ``mb_split``:
    ``reshape(B // k, k, ...).swapaxes(0, 1)``)."""
    return a.reshape(a.shape[0] // k, k, *a.shape[1:]).transpose(
        0, 1).contiguous()


def _as_tensor(arr) -> torch.Tensor:
    """A batch array (numpy or tensor) as a tensor, without a copy where
    it can be avoided."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(_np.ascontiguousarray(arr))


class _StepProgram:
    """One (batch key, dtype key) step on the card: its static input
    buffers (filled in place each step from pinned host buffers), the
    event after their last refill, and once captured the graph, its loss
    output and the kernel launches it holds."""

    def __init__(self, key, device, dtypes=()):
        self.key = key
        self.dtypes = dtypes
        self.inputs = [torch.empty(shape, dtype=dtype, device=device)
                       for shape, dtype in key]
        self.host = [torch.empty(shape, dtype=dtype, pin_memory=True)
                     for shape, dtype in key]
        self.copied = torch.cuda.Event()
        self.graph = None
        self.error = None       # why the capture failed, if it did
        self.loss = None
        self.tally: Dict[str, int] = {}
        self.replays = 0
        self.flops = 0.0        # per dispatch, counted on the eager run

    def stage(self, tensors) -> None:
        # the host buffers are rewritten only once the card has read them
        self.copied.synchronize()
        for host, dev, t in zip(self.host, self.inputs, tensors):
            if t.device.type == "cuda":
                dev.copy_(t)
            else:
                host.copy_(t)
                dev.copy_(host, non_blocking=True)
        self.copied.record()


class SPMDTrainer:
    """Train step of a net, a loss block and a functional optimizer over
    a one-device mesh::

        mesh = parallel.make_mesh({"data": 1})
        trainer = SPMDTrainer(net, loss_fn, "adam",
                              {"learning_rate": 1e-4}, mesh=mesh)
        loss = trainer.step(ids, types, labels)   # no host sync

    The net's parameters must live on the mesh's device; the step updates
    them in place.  After the caller replaces the net's parameter tensors,
    :meth:`reload_params` makes the next step use them."""

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
        if mesh is None:
            raise MXNetError("SPMDTrainer needs a mesh (parallel.make_mesh)")
        if data_axis not in mesh.axis_names:
            raise MXNetError(f"data axis {data_axis!r} not in the mesh's "
                             f"axes {mesh.axis_names}")
        self._accum = 1 if accum_steps is None else int(accum_steps)
        if self._accum < 1:
            raise MXNetError(f"accum_steps={accum_steps} must be >= 1")
        self._net = net
        self._loss = loss_fn
        self._mesh = mesh
        self._data_axis = data_axis
        self._opt = fopt.create(optimizer, **(optimizer_params or {}))
        self._trainable = self._read_params()
        self._opt_state = self._opt.init(self._param_list())
        self._step_count = 0
        # the step count the update reads, incremented inside the step
        self._step_dev = torch.zeros((), dtype=torch.int32,
                                     device=mesh.device)
        self._programs: Dict[tuple, _StepProgram] = {}
        self._graph_pool = None
        self._pool_bytes = 0
        self._eager = False
        self._cpu_flops: Dict[tuple, float] = {}
        # the health plane, read once here so programs never mix shapes
        self._health = self._stats = None
        if _health.enabled():
            self._health = _health.HealthMonitor(
                [n for n, _ in self._trainable], src=self._site)
            self._stats = _health.StepStats(self._param_list(),
                                            self._stat_rows())
        wref = weakref.ref(self)

        def captured():
            tr = wref()
            return 0 if tr is None else sum(
                p.graph is not None for p in tr._programs.values())

        def state_bytes():
            tr = wref()
            return 0 if tr is None else tr.optimizer_state_bytes()

        self._ledger = _telemetry.ledger_site(self._site, size_fn=captured)
        # device-plane attribution: this trainer's live optimizer state,
        # through a weakref so a discarded trainer's state is not kept
        _tdev.register_owner("optimizer", state_bytes)
        _telemetry.gauge(
            "mxtpu_optimizer_state_bytes",
            "optimizer-state bytes of the trainer (the whole tree: one "
            "device)").set(self.optimizer_state_bytes())

    #: the dispatch-ledger row, COST site and health source of this kind
    _site = "spmd"

    def _stat_rows(self) -> int:
        """Rows of the health plane's stat buffers: inner steps per
        dispatch."""
        return 1

    # ------------------------------------------------------------------
    @property
    def mesh(self):
        return self._mesh

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """``{MXNet name: parameter}`` of the trainable parameters (the
        net's own tensors, updated in place by each step)."""
        return {n: p for n, p in self._trainable}

    @property
    def accum_steps(self) -> int:
        return self._accum

    def optimizer_state_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for leaves in self._opt_state.values() for t in leaves)

    def graph_pool_bytes(self) -> int:
        """Bytes the captured steps' (and a ``CompiledLoop``'s chunks')
        shared pool added to the allocator's reserve (activations and
        workspaces held between steps)."""
        return self._pool_bytes

    def _read_params(self) -> List[Tuple[str, torch.Tensor]]:
        named = mx_named_parameters(self._net)
        for name, p in named:
            if p.device != self._mesh.device:
                raise MXNetError(f"parameter {name} is on {p.device}, the "
                                 f"mesh on {self._mesh.device}")
        return [(n, p) for n, p in named if p.requires_grad]

    def _param_list(self) -> List[torch.Tensor]:
        return [p for _, p in self._trainable]

    def _place(self, arr):
        """A batch array (numpy or tensor) as a tensor on the device."""
        return _as_tensor(arr).to(self._mesh.device)

    # ------------------------------------------------------------------
    def _loss_and_grads_of(self, xs, label):
        """The mean loss of one (micro)batch of device tensors and the
        gradient of every trainable parameter (in :attr:`params` order).
        The net runs in training mode, as under ``autograd.record``."""
        params = self._param_list()
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

    def _grad_of(self, inputs):
        """(loss, grads) of one full batch of device tensors (*xs, label):
        with ``accum_steps`` k > 1 the sum of the k microbatches' grads
        divided by k and the mean of their losses, as JAX ``grad_of``;
        each microbatch's activations are freed before the next runs."""
        k = self._accum
        if k == 1:
            *xs, label = inputs
            return self._loss_and_grads_of(xs, label)
        split = [microbatches(a, k) for a in inputs]
        loss_sum, g_sum = None, None
        for i in range(k):
            *xs, label = (a[i] for a in split)
            loss, grads = self._loss_and_grads_of(xs, label)
            if g_sum is None:
                loss_sum, g_sum = loss, grads
            else:
                loss_sum = loss_sum + loss
                for acc, g in zip(g_sum, grads):
                    acc.add_(g)
        return loss_sum / k, [g / k for g in g_sum]

    def _loss_and_grads(self, *batch):
        """The step's loss and gradients for ``batch`` = (*inputs, label),
        without the update (the reference tests and profiles read)."""
        return self._grad_of([self._place(b) for b in batch])

    def _train_step(self, inputs, row=0, guard=None):
        """One step on device tensors: the step counter, the loss and
        gradients, the health plane's stats (into row ``row``) around the
        update, and the update.  With ``guard`` (a 1-element int32 device
        flag) the all-finite check sets it where a gradient holds a NaN
        or an Inf, and the update skips the step there.  What a step's
        graph captures.  Returns the loss."""
        self._step_dev.add_(1)
        loss, grads = self._grad_of(inputs)
        params = self._param_list()
        if self._stats is not None:
            self._stats.before(row, params, grads)
        if guard is None:
            new, self._opt_state = self._opt.update(
                params, grads, self._opt_state, self._step_dev)
        else:
            _fused.all_finite(grads, guard)
            new, self._opt_state = self._opt.update(
                params, grads, self._opt_state, self._step_dev,
                nonfinite=guard)
        self._adopt(new)
        if self._stats is not None:
            self._stats.after(row, self._param_list(), loss)
        return loss

    def _adopt(self, new) -> None:
        """Put an update's new parameter tensors into the net where the
        update made new ones (a promoting rule's fp32 values), as the JAX
        trainer's values become fp32: each ``nn.Parameter`` keeps its
        identity and takes the new storage and dtype."""
        for (_, p), nw in zip(self._trainable, new):
            if nw is not p and nw.data_ptr() != p.data_ptr():
                p.data = nw

    def _dtype_key(self) -> tuple:
        """The dtypes of the trainable values and of the optimizer state:
        part of each program's key, as a new dtype re-traces the JAX
        step."""
        return (tuple(p.dtype for _, p in self._trainable),
                tuple((k, tuple(t.dtype for t in leaves))
                      for k, leaves in sorted(self._opt_state.items())))

    # ------------------------------------------------------------------
    def step(self, *batch) -> torch.Tensor:
        """One train step over ``batch`` = (*inputs, label); returns the
        mean loss as a 0-d tensor on the device (no host sync) that keeps
        its value after later steps."""
        observe = bool(_telemetry.TRAINER.subscribers)
        t0 = time.perf_counter() if observe else 0.0
        with _telemetry.trace_span("spmd.step", cat="trainer"):
            out = self._step_impl(*batch)
        if observe:
            _telemetry.TRAINER.publish(phase="step",
                                       seconds=time.perf_counter() - t0,
                                       event=self._boundary_event())
        return out

    def _boundary_event(self):
        """A timing event recorded at a step boundary on the card (the MFU
        window's device clock), None on the host."""
        if self._mesh.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._mesh.device))
        return ev

    def _publish_cost(self, flops: float, dtypes=()) -> None:
        """Publish a dispatch's FLOPs with the dtype of its GEMMs (the
        dtype most of the trainable values had when it started, from its
        dtype key): the MFU collector's peak follows it."""
        if flops and _telemetry.COST.subscribers:
            vals = list(dtypes[0]) if dtypes else []
            dtype = max(vals, key=vals.count) if vals else None
            _telemetry.COST.publish(where=self._site, flops=flops,
                                    dtype=dtype)

    def _cpu_run(self, key, body):
        """``body()`` on the host: the first run of a key counts its FLOPs
        (the host has no capture; every run publishes the count)."""
        flops = self._cpu_flops.get(key)
        if flops is None:
            out, flops = _graphs.counted(body)
            self._cpu_flops[key] = flops
        else:
            out = body()
        self._publish_cost(flops, key[-1])
        return out

    def _replay(self, prog):
        """One replay of ``prog``'s captured graph: its launches counted,
        its FLOPs published."""
        prog.graph.replay()
        add_launches(prog.tally)
        prog.replays += 1
        self._publish_cost(prog.flops, prog.dtypes)

    def _build_key(self, arrs) -> tuple:
        return tuple((tuple(a.shape), a.dtype) for a in arrs)

    def _step_impl(self, *batch):
        if len(batch) < 2:
            raise MXNetError("SPMDTrainer.step takes (*inputs, label)")
        t0 = time.perf_counter()
        cuda = self._mesh.device.type == "cuda"
        with _telemetry.trace_span("spmd.shard_batch", cat="transfer"):
            arrs = [_as_tensor(b) for b in batch]
            k = self._accum
            if k > 1:
                for a in arrs:
                    B = a.shape[0] if a.dim() else 0
                    if B == 0 or B % k:
                        raise MXNetError(
                            f"global batch {B} must divide by accum_steps "
                            f"{k} x data axis 1 for even microbatch "
                            "sharding")
            bkey = self._build_key(arrs)
            dkey = self._dtype_key()
            if self._opt.promotes and torch.float16 in dkey[0]:
                raise MXNetError(f"SPMDTrainer: {_fused.FP16_PROMOTION}")
            key = (bkey, dkey)
            if cuda:
                # one program per batch key, for the dtypes it was built
                # at: a dtype change never goes back, so a program of
                # other dtypes is replaced, never replayed
                prog = self._programs.get(bkey)
                if prog is None or prog.dtypes != dkey:
                    prog = self._programs[bkey] = _StepProgram(
                        bkey, self._mesh.device, dkey)
                if prog.error is not None and not self._eager:
                    raise MXNetError(prog.error)
                prog.stage(arrs)
            else:
                inputs = [self._place(a) for a in arrs]
        self._step_count += 1
        if not cuda:
            loss = self._cpu_run(key, lambda: self._train_step(inputs))
        elif self._eager:
            loss = self._train_step(prog.inputs)
        elif prog.graph is None:
            loss = self._first_run(
                prog, lambda: self._train_step(prog.inputs), "the step")
        else:
            self._replay(prog)
            # the graph's loss buffer is overwritten by the next replay
            loss = prog.loss.clone()
        if self._health is not None:
            # queued device stats, folded once their copy has landed
            self._health.submit(self._step_count - 1, 1,
                                self._stats.rows_of(1))
        self._ledger.record(time.perf_counter() - t0)
        # the whole step (forward, backward, update) is one program
        _telemetry.gauge("mxtpu_optimizer_dispatches_per_step").set(1)
        return loss

    def _first_run(self, prog, body, what):
        """A program's first run on the card: ``body`` runs eagerly on a
        side stream (the real step or chunk, the warm-up of cuBLAS and the
        allocator the capture needs, and its FLOPs counted), then is
        captured into the program's graph in the trainer's pool.
        Capturing runs nothing, so the work is applied once.  A failed
        capture raises, and so does every later dispatch of the
        program.  A run that changed the dtypes of the values or the
        state (a promoting step) is not captured: its program is dropped
        (its dtype key never comes back) and the next step, under the new
        key, runs eagerly in turn."""
        dev = self._mesh.device
        with _graphs.CAPTURE_LOCK:
            out, prog.flops = _graphs.on_side_stream(
                lambda: _graphs.counted(body), dev)
            if self._dtype_key() != prog.dtypes:
                self._publish_cost(prog.flops, prog.dtypes)
                self._drop(prog)
                return out
            t0 = time.perf_counter()
            try:
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                graph, cap_out, tally, grown = _graphs.capture(
                    body, dev, self._graph_pool)
            except Exception as e:
                # the card has no eager path after a key's first step:
                # every later step of the key raises the same error
                prog.error = (f"{type(self).__name__}: capture of {what} "
                              f"for batch key {_key_text(prog.key)} "
                              f"failed: {e}")
                raise MXNetError(prog.error) from e
        prog.graph, prog.loss, prog.tally = graph, cap_out, tally
        self._pool_bytes += grown
        self._ledger.record_compile(time.perf_counter() - t0)
        self._publish_cost(prog.flops, prog.dtypes)
        return out

    def _drop(self, prog) -> None:
        """Forget a program whose dtype key is gone (a step's, or a
        ``CompiledLoop`` chunk's)."""
        for table in (self._programs, getattr(self, "_chunks", {})):
            for k, v in list(table.items()):
                if v is prog:
                    del table[k]

    @contextlib.contextmanager
    def _eager_steps(self):
        """Run the step body uncaptured on the card inside this block: the
        reference the graphs are held to."""
        self._eager = True
        try:
            yield
        finally:
            self._eager = False

    # ------------------------------------------------------------------
    def reload_params(self):
        """Re-read the net's parameters after the caller replaced its
        tensors (for example with ``convert.load_jax_params`` on a new
        net, or ``load_state_dict``) and drop every captured step, which
        would write to the old addresses.  The optimizer state and the
        step count are kept, as the JAX trainer keeps them."""
        trainable = self._read_params()
        old = [(n, tuple(p.shape)) for n, p in self._trainable]
        if [(n, tuple(p.shape)) for n, p in trainable] != old:
            raise MXNetError("reload_params: the net's trainable parameters "
                             "changed names or shapes")
        self._trainable = trainable
        self._programs.clear()
        self._graph_pool = None
        self._pool_bytes = 0

    def sync_health(self):
        """Wait until every queued health-plane record is folded into the
        StepHealth ring (a no-op with the plane off)."""
        if self._health is not None:
            self._health.sync()

    def sync_to_block(self):
        """Nothing to copy: the step updates the net's parameters in
        place (kept for the JAX package's API).  Folds the pending health
        records, as the JAX trainer's does."""
        self.sync_health()


def _key_text(key) -> str:
    return ", ".join(f"{list(shape)} {str(dtype).replace('torch.', '')}"
                     for shape, dtype in key)
