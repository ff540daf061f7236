"""The serving engines (counterpart of
``incubator_mxnet_tpu/serving/engine.py``): :class:`InferenceEngine`, a
one-shot model as one program per batch-size bucket, and
:class:`GenerationEngine`, autoregressive generation over a preallocated
KV cache.  On the card every program of either engine is a CUDA graph
(:mod:`..cuda_graphs`); on the CPU the same bodies run eagerly.
:class:`InferenceEngine` is described on its class; the rest of this
docstring is the generation engine's.

The JAX engine serves from a closed set of compiled programs: one prefill
per prompt-length bucket (and one suffix prefill per bucket with the
prefix cache), one decode, one decode burst and, with a draft attached,
one verify.  The port keeps that set.  Each program is a fixed-shape body
of plain tensor code that reads its operands from static buffers the
engine allocates once and refills in place (step inputs, block tables,
per-slot sampling state), writes the KV cache in place (``index_put_``)
where JAX donates it, and leaves its outputs in tensors the engine reads
back after the call.  :meth:`GenerationEngine.warmup` binds every body;
on the card it captures each into a ``torch.cuda.CUDAGraph`` (all of an
engine's graphs share one memory pool), and every later call is one
replay.  On the card there is no eager path: a program that was never
captured, or a capture that fails, raises :class:`MXNetError`.  On the
CPU the same bodies run over the same static buffers, uncaptured.

The kernels are the port's own: prefill self-attention goes through
:func:`..models.bert._sdpa` (kernel K1 on the card), decode through
:func:`paged_decode_attention` (K2) or, in the dense layout,
:func:`decode_attention` (K3), and the speculative-decode verify through
:func:`paged_verify_decode_attention` (K4) or
:func:`verify_decode_attention` (K5).  A replay adds each program's
kernel launches, tallied at capture, to ``launch_counts``.

Layouts (fp32, as in the JAX engine, whatever the net's dtype: a cast
net's K/V is cast to fp32 as it is written, and its query reaches K2-K5
in the net's dtype, their output coming back in it):

* **paged** (default): per layer a block pool ``(num_blocks, H,
  block_size, D)`` managed by :class:`~.kvcache.BlockPool`; each slot
  addresses its K/V through a row of an int32 block table padded with
  the null block 0.  A prompt whose leading full blocks are in the prefix
  cache prefills only its suffix.
* **dense**: per layer ``(max_slots, H, max_len, D)``; the parity oracle
  for paged.

JAX clamps out-of-range gathers and ``dynamic_update_slice`` starts where
torch raises; the bodies reproduce the clamps the engine relies on
explicitly (the null-block redirect of writes past a slot's table, the
position clamp of the prefix-hit prefill, the table-column clamp of
decode, the verify writes past ``max_len``) and the host checks the
inputs it is given before copying them in."""
from __future__ import annotations

import contextlib
import functools
import math
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from ..base import MXNetError, getenv_bool, getenv_int
from .. import health as _health
from .. import telemetry as _telemetry
from .. import cuda_graphs as _graphs
from .. import telemetry_device as _tdev
from ..kernels.flash_attention import (NEG, add_launches, decode_attention,
                                       paged_decode_attention,
                                       paged_verify_decode_attention,
                                       verify_decode_attention)
from .kvcache import BlockPool, blocks_for
from .sampling import (SamplingParams, root_key, sample_tokens, step_keys,
                       topn_logprobs)

__all__ = ["InferenceEngine", "GenerationEngine", "derive_buckets",
           "derive_prefill_buckets"]

#: one capture at a time in the process (``cuda_graphs``' rules): two
#: engines warming on two threads (the server's background warmups) wait
#: for each other
_CAPTURE_LOCK = _graphs.CAPTURE_LOCK

#: program kind -> its dispatch-ledger site ("serving:<model>:<site>"),
#: the JAX engine's jit names
_LEDGER_SITES = {"prefill": "prefill", "prefill_hit": "prefill_ext",
                 "decode": "decode", "decode_burst": "decode_burst",
                 "verify": "verify"}


def derive_prefill_buckets(max_len: int, smallest: int = 8):
    """Prompt-length buckets: powers of two from ``smallest`` up to (and
    always including) ``max_len`` — ``derive_prefill_buckets(128) ==
    (8, 16, 32, 64, 128)``."""
    m = int(max_len)
    if m < 1:
        raise MXNetError(f"max_len must be >= 1, got {m}")
    out, b = [], min(int(smallest), m)
    while b < m:
        out.append(b)
        b *= 2
    out.append(m)
    return tuple(out)


def _host_buffer(shape, dtype, device) -> torch.Tensor:
    """A zeroed host tensor, page-locked when ``device`` is a card so that
    copies from it are true DMA transfers."""
    return torch.zeros(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


def _locked(fn):
    """Run an engine method under the engine's dispatch lock."""
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    return call


def _register_device_observers(engine) -> None:
    """Enroll ``engine`` in the device-observability plane: its program
    inventory (``GET /programs``), its parameters and its KV cache as
    memory owners (``params:<name>``, ``kv:<name>``) and its dispatch
    ledger sites with their counts of ready programs.  All weak: a
    registration never keeps a dropped engine's tensors or graphs alive
    (a dropped engine reports empty or zero until a successor of the
    same name replaces it)."""
    wref = weakref.ref(engine)

    def inventory():
        eng = wref()
        return eng.program_inventory() if eng is not None else {}

    def param_bytes():
        eng = wref()
        if eng is None:
            return 0
        return sum(p.numel() * p.element_size()
                   for p in eng.block.parameters())

    def kv_bytes():
        eng = wref()
        return eng.cache_bytes if eng is not None else 0

    def ready(kind):
        def count():
            eng = wref()
            if eng is None:
                return 0
            cuda = eng.device.type == "cuda"
            return sum(1 for key, p in list(eng._programs.items())
                       if key[0] == kind and (p.graph is not None
                                              or not cuda))
        return count

    _tdev.register_inventory(engine.name, inventory)
    _tdev.register_owner("params:" + engine.name, param_bytes)
    _tdev.register_owner("kv:" + engine.name, kv_bytes)
    engine._ledger = {}
    for kind, site in _LEDGER_SITES.items():
        if kind == "prefill_hit" and not engine.paged:
            continue
        engine._ledger[kind] = _telemetry.ledger_site(
            f"serving:{engine.name}:{site}", ready(kind))


# ===========================================================================
# InferenceEngine — one-shot models as batch-size buckets
# ===========================================================================

#: a request's 64-bit dtypes and the 32-bit ones they become before they
#: reach a program, as ``jnp.asarray`` narrows them in the JAX engine
_CANON_DTYPES = {torch.float64: torch.float32, torch.int64: torch.int32}


def derive_buckets(max_batch_size: int) -> Tuple[int, ...]:
    """Powers of two up to (and always including) ``max_batch_size``:
    ``derive_buckets(32) == (1, 2, 4, 8, 16, 32)``,
    ``derive_buckets(24) == (1, 2, 4, 8, 16, 24)``."""
    m = int(max_batch_size)
    if m < 1:
        raise MXNetError(f"max_batch_size must be >= 1, got {m}")
    out, b = [], 1
    while b < m:
        out.append(b)
        b *= 2
    out.append(m)
    return tuple(out)


def _canon_specs(input_specs):
    """[(per-example shape, numpy dtype)] with the batch dim EXCLUDED; a
    bare shape means float32."""
    if input_specs is None:
        return None
    out = []
    for spec in input_specs:
        if isinstance(spec, tuple) and len(spec) == 2 \
                and isinstance(spec[0], (tuple, list)):
            shape, dtype = spec
        else:
            shape, dtype = spec, _np.float32
        out.append((tuple(int(d) for d in shape), _np.dtype(dtype)))
    return out


def _as_tensor(a) -> torch.Tensor:
    """A request array (numpy, torch tensor or NDArray) as a tensor at the
    JAX engine's canonical dtypes (64-bit floats and ints narrowed to 32
    bits); numpy arrays are wrapped, not copied."""
    from ..ndarray.ndarray import NDArray
    if isinstance(a, NDArray):
        a = a._data
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(_np.ascontiguousarray(_np.asarray(a)))
    dt = _CANON_DTYPES.get(a.dtype)
    return a if dt is None else a.to(dt)


def _param_signature(tensors) -> tuple:
    """What a captured graph assumes of the weights it reads: every
    tensor's address, dtype and shape, in order."""
    return tuple((t.data_ptr(), t.dtype, tuple(t.shape)) for t in tensors)


def _register_oneshot_observers(engine) -> None:
    """Enroll a one-shot engine in the device-observability plane, as
    :func:`_register_device_observers` does a generation engine: its
    program inventory, its weights as the ``params:<name>`` owner and its
    dispatch-ledger site ``serving:<name>`` with its count of ready
    programs.  All weak."""
    wref = weakref.ref(engine)

    def inventory():
        eng = wref()
        return eng.program_inventory() if eng is not None else {}

    def param_bytes():
        eng = wref()
        if eng is None:
            return 0
        try:
            pv, av = eng._param_fn()
            return sum(t.numel() * t.element_size()
                       for vals in (pv, av) for t in vals)
        except Exception:
            return 0

    def ready():
        eng = wref()
        return eng.compiled_programs() if eng is not None else 0

    _tdev.register_inventory(engine.name, inventory)
    _tdev.register_owner("params:" + engine.name, param_bytes)
    engine._ledger = _telemetry.ledger_site("serving:" + engine.name, ready)


class _BucketProgram:
    """One input signature's program on the card: static input buffers at
    the signature's shapes and dtypes, refilled in place per dispatch; the
    captured graph, its static outputs and the kernel launches one replay
    makes; and the weights' signature the graph was captured over."""

    __slots__ = ("ins", "graph", "out", "tally", "weights", "replays",
                 "captures")

    def __init__(self, signature, device):
        self.ins = tuple(torch.zeros(shape, dtype=dt, device=device)
                         for shape, dt in signature)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[tuple] = None
        self.tally: Dict[str, int] = {}
        self.weights: Optional[tuple] = None
        self.replays = 0
        self.captures = 0


class InferenceEngine:
    """A one-shot model (one forward per batch) as a bucketed set of
    programs (counterpart of the JAX engine of the same name).

    ``pure_fn(in_vals, param_vals, aux_vals, key) -> outputs`` computes
    the model on a batch of input tensors; ``param_fn() -> (param_vals,
    aux_vals)`` returns the CURRENT weight tensors.  The port draws no
    random numbers in predict mode, so ``key`` is None.  Most callers
    build engines through :meth:`from_block`.

    A batch of ``n`` rows is zero-padded up to the smallest bucket that
    holds it (declared ``buckets``, or :func:`derive_buckets` of
    ``max_batch_size``), so a stream of mixed sizes meets one program per
    bucket; past the largest bucket it is chunked.  On the card each
    program is one CUDA graph, captured at :meth:`warmup` or at its first
    dispatch: the padded batch is copied into the graph's static input
    buffers (the declared dtypes are kept: int32 ids stay int32) and the
    graph is replayed, then the first ``n`` rows of each output are copied
    out, so a later replay never overwrites an answer already returned.
    A graph reads the weights by address: at every dispatch the engine
    compares ``param_fn()``'s tensors (address, dtype, shape) with those
    the graph was captured over, so a weight copied in place
    (``Parameter.set_data``, ``load_parameters``) is seen at no cost and
    one given new storage (``cast``, ``reset_ctx``, a reassigned
    ``nn.Parameter``) re-captures that program before it runs.  On the
    CPU (or on the card inside :meth:`_eager_bodies`) ``pure_fn`` runs
    eagerly on the padded batch.

    Captures follow :mod:`..cuda_graphs`' rules (``CAPTURE_LOCK``, one
    graph pool per engine) and every dispatch holds ``DISPATCH_GATE``
    shared and the engine's lock, so a server's warmup thread and its
    batcher threads never capture and replay over each other.  The
    engine runs on ``ctx`` (default: the current context, ``gpu(0)``
    outside a ``with mx.cpu():`` scope; without a card that raises
    :class:`MXNetError`)."""

    def __init__(self, pure_fn: Callable, input_names: Sequence[str],
                 param_fn: Callable, *, name: str = "model",
                 buckets: Optional[Sequence[int]] = None,
                 max_batch_size: Optional[int] = None,
                 input_specs=None, ctx=None):
        from ..context import as_context
        self.name = str(name)
        self.input_names = [str(n) for n in input_names]
        self._pure = pure_fn
        self._param_fn = param_fn
        self._ctx = as_context(ctx)
        self.device = self._ctx.device          # raises without the card
        self.input_specs = _canon_specs(input_specs)
        if buckets:
            self.buckets = tuple(sorted({int(b) for b in buckets}))
            if self.buckets[0] < 1:
                raise MXNetError(f"buckets must be >= 1: {self.buckets}")
        elif max_batch_size:
            self.buckets = derive_buckets(max_batch_size)
        else:
            self.buckets = ()       # exact-shape mode (run_exact)
        self.max_batch_size = self.buckets[-1] if self.buckets else None
        self._lock = threading.RLock()
        self._programs: Dict[tuple, _BucketProgram] = {}
        self._shapes_seen: set = set()
        self._graph_pool = None
        self._capture_seconds = 0.0
        self._pool_bytes = 0
        self._eager = False
        self._warming = False
        self._warmup_done = False
        _register_oneshot_observers(self)

    @property
    def input_dtypes(self):
        """Declared per-input dtypes (from ``input_specs``), or None: the
        HTTP front decodes JSON tensors at these dtypes."""
        if not self.input_specs:
            return None
        return [dtype for _, dtype in self.input_specs]

    @property
    def warm(self) -> bool:
        """True once every declared bucket has a program (the readiness
        gate); an exact-shape engine is always warm."""
        if not self.buckets:
            return True
        if self._warmup_done:
            return True
        return self.compiled_programs() >= len(self.buckets)

    # -- shape bucketing ------------------------------------------------
    def bucket_for(self, n: int) -> Optional[int]:
        """Smallest bucket that fits ``n`` rows (None past the largest:
        the caller chunks)."""
        for b in self.buckets:
            if b >= int(n):
                return b
        return None

    # -- dispatch -------------------------------------------------------
    def _prepare(self, arrays, target: Optional[int]):
        """The batch as tensors, each zero-padded along the batch dim up
        to ``target`` rows (None: as given)."""
        vals = []
        for a in arrays:
            v = _as_tensor(a)
            if v.dim() == 0:
                raise MXNetError(f"{self.name}: each input needs a "
                                 "leading batch dim")
            if target is not None and v.shape[0] != target:
                pad = target - int(v.shape[0])
                if pad < 0:
                    raise MXNetError(
                        f"{self.name}: batch {v.shape[0]} exceeds bucket "
                        f"{target}")
                v = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
            vals.append(v)
        return vals

    def _body(self, vals, param_vals, aux_vals):
        """``pure_fn`` in predict mode, as a tuple of output tensors."""
        with torch.no_grad():
            out = self._pure(tuple(vals), tuple(param_vals),
                             tuple(aux_vals), None)
        if isinstance(out, torch.Tensor):
            return (out,)
        return tuple(out)

    def _dispatch(self, vals, n: int):
        """Run one padded batch and return each output's first ``n``
        rows.  The call lands in the dispatch ledger (outside warmup)
        under a ``serve.infer`` span; an out-of-memory error is reported
        (``telemetry_device``) and re-raised."""
        t0 = time.perf_counter()
        try:
            with _telemetry.trace_span("serve.infer", cat="serving",
                                       model=self.name,
                                       batch=int(vals[0].shape[0])):
                with self._lock, _graphs.DISPATCH_GATE.shared():
                    outs = self._run(vals, n)
        except Exception as e:
            if _tdev.is_oom(e):
                _tdev.report_oom("serving." + self.name, e, model=self.name)
            raise
        if not self._warming:
            self._ledger.record(time.perf_counter() - t0)
        return outs

    def _run(self, vals, n: int):
        signature = tuple((tuple(v.shape), v.dtype) for v in vals)
        self._shapes_seen.add(tuple(s for s, _ in signature))
        pv, av = self._param_fn()
        if self.device.type != "cuda" or self._eager:
            vals = [v.to(self.device) for v in vals]
            outs = self._body(vals, pv, av)
            if int(vals[0].shape[0]) == n:
                return list(outs)
            return [o[:n] for o in outs]
        prog = self._programs.get(signature)
        if prog is None:
            prog = self._programs[signature] = _BucketProgram(signature,
                                                              self.device)
        for buf, v in zip(prog.ins, vals):
            buf.copy_(v)
        weights = _param_signature(tuple(pv) + tuple(av))
        if prog.graph is None or prog.weights != weights:
            self._capture(prog, pv, av, weights)
        prog.graph.replay()
        add_launches(prog.tally)
        prog.replays += 1
        return [o[:n].clone() for o in prog.out]

    def _capture(self, prog: _BucketProgram, pv, av, weights) -> None:
        """Warm the body on a side stream over ``prog``'s static inputs,
        then capture it into a CUDA graph in this engine's pool.  A graph
        captured over other weights is dropped first (never during a
        capture: freeing a graph inside one invalidates it)."""
        prog.graph = prog.out = None
        t0 = time.perf_counter()
        with _CAPTURE_LOCK:
            try:
                _graphs.on_side_stream(
                    lambda: self._body(prog.ins, pv, av), self.device)
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                graph, out, tally, grown = _graphs.capture(
                    lambda: self._body(prog.ins, pv, av), self.device,
                    self._graph_pool)
            except Exception as e:
                raise MXNetError(
                    f"{self.name}: capture of the program for "
                    f"{[tuple(b.shape) for b in prog.ins]} failed: "
                    f"{e}") from e
        prog.graph, prog.out, prog.tally = graph, out, tally
        prog.weights = weights
        prog.captures += 1
        self._pool_bytes += grown
        dt = time.perf_counter() - t0
        self._capture_seconds += dt
        self._ledger.record_compile(dt)

    @contextlib.contextmanager
    def _eager_bodies(self):
        """Run the body uncaptured on the card inside this block: the
        reference the graphs are held to."""
        with self._lock:
            self._eager = True
        try:
            yield
        finally:
            with self._lock:
                self._eager = False

    def _check_inputs(self, arrays) -> list:
        arrays = list(arrays)
        if len(arrays) != len(self.input_names):
            raise MXNetError(
                f"{self.name}: got {len(arrays)} inputs, expected "
                f"{len(self.input_names)} ({self.input_names})")
        return arrays

    def predict(self, arrays: Sequence) -> List[torch.Tensor]:
        """Run one batch: pad up to the next bucket, dispatch ONE program,
        slice the outputs back to the true row count.  A batch larger
        than the biggest bucket is chunked.  Outputs are tensors on the
        engine's device that no later dispatch writes."""
        arrays = self._check_inputs(arrays)
        if not self.buckets:
            vals = self._prepare(arrays, None)
            return self._dispatch(vals, int(vals[0].shape[0]))
        shape = tuple(getattr(arrays[0], "shape", ()))
        if not shape:
            raise MXNetError(f"{self.name}: each input needs a leading "
                             "batch dim")
        n = int(shape[0])
        bucket = self.bucket_for(n)
        if bucket is None:          # chunk by the largest bucket
            step = self.buckets[-1]
            chunks = [self.predict([a[i:i + step] for a in arrays])
                      for i in range(0, n, step)]
            return [torch.cat([c[k] for c in chunks])
                    for k in range(len(chunks[0]))]
        return self._dispatch(self._prepare(arrays, bucket), n)

    def run_exact(self, arrays: Sequence) -> List[torch.Tensor]:
        """Dispatch at the exact input shapes, no bucketing: one program
        per distinct shape."""
        vals = self._prepare(self._check_inputs(arrays), None)
        return self._dispatch(vals, int(vals[0].shape[0]))

    def warmup(self) -> int:
        """Make every declared bucket's program (on the card: capture its
        graph) from zero batches built from ``input_specs``; returns the
        number of buckets warmed."""
        if not self.buckets:
            return 0
        if not self.input_specs:
            raise MXNetError(
                f"{self.name}: warmup needs input_specs (per-example "
                "shapes) to synthesize bucket batches")
        self._warming = True
        try:
            for b in self.buckets:
                self.predict([_np.zeros((b,) + shape, dtype)
                              for shape, dtype in self.input_specs])
        finally:
            self._warming = False
        self._warmup_done = True
        return len(self.buckets)

    def compiled_programs(self) -> int:
        """Programs ready to run: captured graphs on the card; on the
        CPU the distinct input shapes run so far, as the JAX engine
        counts them when it cannot read its jit cache.  Bounded by the
        bucket count for bucketed serving."""
        if self.device.type == "cuda":
            return sum(p.graph is not None
                       for p in list(self._programs.values()))
        return len(self._shapes_seen)

    def program_inventory(self) -> dict:
        """Expected against compiled programs, and this engine's
        dispatch-ledger row, under the JAX engine's keys (``GET
        /programs``, flight dumps)."""
        site = "serving:" + self.name
        ledger = _telemetry.dispatch_ledger(prefix=site)
        return {
            "model": self.name,
            "expected_programs": len(self.buckets) or None,
            "compiled_programs": self.compiled_programs(),
            "warm": self.warm,
            "programs": {k: v for k, v in ledger.items() if k == site},
        }

    def graph_stats(self) -> dict:
        """Capture cost on the card: programs expected and captured,
        captures made (re-captures after a weight changed storage
        included), the seconds spent warming and capturing, and the bytes
        the engine's graph pool reserved (0 on the CPU)."""
        progs = list(self._programs.values())
        return {"expected": len(self.buckets),
                "captured": sum(p.graph is not None for p in progs),
                "captures": sum(p.captures for p in progs),
                "capture_seconds": self._capture_seconds,
                "pool_bytes": self._pool_bytes}

    def __repr__(self):
        return (f"<InferenceEngine {self.name!r}: inputs="
                f"{self.input_names}, buckets={list(self.buckets)}, "
                f"programs={self.compiled_programs()}>")

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_block(cls, block, input_specs, *, name: Optional[str] = None,
                   buckets=None, max_batch_size: Optional[int] = None,
                   ctx=None):
        """Wrap a block (a Gluon ``Block``/``HybridBlock`` or any
        ``torch.nn.Module`` whose forward takes the inputs as tensors).
        ``input_specs`` are per-example shapes (batch dim excluded), e.g.
        ``[(784,)]`` or ``[((128,), "int32"), ...]``.  The block runs in
        predict mode (no gradient, ``training`` off for the call).  Its
        weights must be on the engine's device: the port settles every
        shape at construction, so no probe forward is needed."""
        from ..context import as_context
        specs = _canon_specs(input_specs)
        if not specs:
            raise MXNetError("from_block: input_specs is required")
        ctx = as_context(ctx)
        dev = ctx.device
        for t in list(block.parameters()) + list(block.buffers()):
            if t.device != dev:
                raise MXNetError(
                    f"from_block: the block's weights are on {t.device}, "
                    f"the engine runs on {dev}; move the block "
                    "(reset_ctx) or pass its context")

        def param_fn():
            return tuple(block.parameters()), tuple(block.buffers())

        def pure(in_vals, param_vals, aux_vals, key):
            was = block.training
            if was:
                block.train(False)
            try:
                return block(*in_vals)
            finally:
                if was:
                    block.train(True)

        names = ["data"] if len(specs) == 1 else \
            [f"data{i}" for i in range(len(specs))]
        return cls(pure, names, param_fn,
                   name=name or getattr(block, "name", "block"),
                   buckets=buckets, max_batch_size=max_batch_size or 32,
                   input_specs=specs, ctx=ctx)

    @classmethod
    def from_symbol(cls, *args, **kwargs):
        raise MXNetError(_SYMBOL_FORMATS.format("from_symbol"))

    @classmethod
    def from_module(cls, *args, **kwargs):
        raise MXNetError(_SYMBOL_FORMATS.format("from_module"))

    @classmethod
    def from_export(cls, *args, **kwargs):
        raise MXNetError(_SYMBOL_FORMATS.format("from_export"))


#: what the symbol-based constructors answer until they are ported
_SYMBOL_FORMATS = ("InferenceEngine.{}: the symbol and export formats "
                   "(symbol/, Module, HybridBlock.export artifacts) are not "
                   "ported; ROADMAP Queue A item 17")



class _Program:
    """One fixed-shape body of the engine.  Its int64 operands live in one
    flat host buffer and one flat device buffer of the same layout (one
    copy per call); ``body(engine, args, *static)`` reads the device
    views ``args`` and returns a tuple of output tensors (None where it
    computes nothing).
    On the card, ``graph`` is the captured body, ``out`` its static
    outputs and ``tally`` the kernel launches one replay makes."""

    def __init__(self, kind: str, name: str,
                 spec: Sequence[Tuple[str, tuple]], body: Callable,
                 static: tuple, device):
        self.kind = kind
        self.name = name
        # an unbound engine method and its static arguments: a program
        # holds no reference to its engine, so an engine dropped by its
        # caller is freed at once, graphs included, never by a cyclic
        # collection that could land inside another engine's capture
        self.body, self.static = body, static
        total = sum(math.prod(shape) for _, shape in spec)
        self.host = _host_buffer(total, torch.int64, device)
        self.dev = torch.zeros(total, dtype=torch.int64, device=device)
        self.host_np: Dict[str, _np.ndarray] = {}
        self.args: Dict[str, torch.Tensor] = {}
        off = 0
        for arg, shape in spec:
            n = math.prod(shape)
            self.host_np[arg] = self.host[off:off + n].view(shape).numpy()
            self.args[arg] = self.dev[off:off + n].view(shape)
            off += n
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[tuple] = None
        self.tally: Dict[str, int] = {}
        self.host_out: Optional[tuple] = None
        self.replays = 0


class GenerationEngine:
    """A GPT-style model served from ``max_slots`` slots over one KV
    cache.

    * ``prefill(tokens, slot)`` runs the prompt (zero-padded to its
      prompt-length bucket) and returns the first generated token;
    * ``decode(last_tokens, positions)`` advances EVERY slot one token;
    * ``decode_burst(...)`` advances every slot up to ``scan_steps``
      tokens with a per-slot done mask kept on the device, so the k steps
      run without a host round-trip between them;
    * with a draft engine attached (:meth:`attach_draft`),
      ``spec_step(...)`` lets the draft propose ``spec_k`` tokens per slot
      and scores all ``spec_k + 1`` positions in one :meth:`verify`.

    Each of these is one program of the closed set (:meth:`warmup`).
    Free slots ride along in decode (their writes land in the null block,
    or in their own dense row at position 0).  Every public method that
    stages, replays or reads back a program, or changes the host state a
    program reads (sampling rows, block tables, the cache itself), runs
    under the engine's dispatch lock: the programs share one graph pool
    and one set of static buffers, so a second thread (a worker restarted
    by the watchdog, a warmup on a background thread) waits until the
    first one's program has been read back.  Constructor arguments and
    their environment variables are the JAX engine's.

    With ``MXNET_HEALTH_PLANE`` on at construction, the decode and burst
    bodies also compute the health plane's per-slot logit stats
    (:meth:`last_decode_health`); the tokens do not change.  Every
    program call lands in the telemetry dispatch ledger under
    ``serving:<name>:<site>`` (host seconds around staging, replay and
    read-back), and a prefill opens a ``serve.prefill`` span."""

    def __init__(self, block, *, name: Optional[str] = None,
                 max_slots: Optional[int] = None,
                 max_len: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 paged: Optional[bool] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 scan_steps: Optional[int] = None,
                 logprobs_topn: Optional[int] = None):
        for attr in ("embed", "pos_embed", "cells", "ln_f", "_units",
                     "_max_length"):
            if not hasattr(block, attr):
                raise MXNetError(
                    "GenerationEngine needs a GPT-style block (embed/"
                    f"pos_embed/cells/ln_f); {type(block).__name__} has "
                    f"no {attr!r}")
        self.block = block
        self.name = str(name or "gpt")
        self.device = block.embed.weight.device
        self._lock = threading.RLock()
        # the health plane is baked into the bodies at construction, as
        # the JAX engine bakes it into its jit outputs
        self._health_on = _health.enabled()
        self._last_decode_health = None
        self.max_slots = int(max_slots
                             or getenv_int("MXNET_GEN_MAX_SLOTS", 8))
        if self.max_slots < 1:
            raise MXNetError(f"max_slots must be >= 1: {self.max_slots}")
        blk_len = int(block._max_length)
        self.max_len = min(int(max_len
                               or getenv_int("MXNET_GEN_MAX_LEN", blk_len)),
                           blk_len)
        if self.max_len < 2:
            raise MXNetError(f"max_len must be >= 2: {self.max_len}")
        self._cells = list(block.cells)
        self.num_layers = len(self._cells)
        self.num_heads = int(self._cells[0].attention._num_heads)
        self.head_dim = int(block._units) // self.num_heads
        if prefill_buckets:
            self.prefill_buckets = tuple(sorted(
                {int(b) for b in prefill_buckets}))
            if self.prefill_buckets[0] < 1 \
                    or self.prefill_buckets[-1] > self.max_len:
                raise MXNetError(
                    f"prefill buckets must be in [1, {self.max_len}]: "
                    f"{self.prefill_buckets}")
        else:
            self.prefill_buckets = derive_prefill_buckets(self.max_len)
        self.paged = bool(getenv_bool("MXNET_KV_PAGED", True)
                          if paged is None else paged)
        self.block_size = int(block_size
                              or getenv_int("MXNET_KV_BLOCK_SIZE", 16))
        if self.block_size < 1:
            raise MXNetError(f"block_size must be >= 1: {self.block_size}")
        self.prefix_cache_enabled = self.paged and bool(
            getenv_bool("MXNET_KV_PREFIX_CACHE", True)
            if prefix_cache is None else prefix_cache)
        if self.paged:
            self.max_blocks_per_slot = -(-self.max_len // self.block_size)
            nb = int(num_blocks or getenv_int("MXNET_KV_NUM_BLOCKS", 0)) \
                or 1 + self.max_slots * self.max_blocks_per_slot
            if nb < 1 + self.max_blocks_per_slot:
                raise MXNetError(
                    f"num_blocks {nb} cannot hold even one max_len slot "
                    f"({self.max_blocks_per_slot} blocks + null block)")
            self.num_blocks = nb
            self.pool = BlockPool(nb, self.block_size,
                                  prefix_cache=self.prefix_cache_enabled,
                                  model=self.name)
        else:
            self.max_blocks_per_slot = 0
            self.num_blocks = 0
            self.pool = None
        self._warming = False
        self.scan_steps = int(scan_steps if scan_steps is not None
                              else getenv_int("MXNET_DECODE_SCAN_STEPS",
                                              8))
        if self.scan_steps < 0:
            raise MXNetError(
                f"scan_steps must be >= 0: {self.scan_steps}")
        self.vocab_size = int(block._vocab_size)
        self.logprobs_topn = max(0, min(
            int(logprobs_topn if logprobs_topn is not None
                else getenv_int("MXNET_SAMPLING_LOGPROBS_TOPN", 5)),
            self.vocab_size))
        S, V, dev = self.max_slots, self.vocab_size, self.device
        # per-slot sampling state: host mirrors (page-locked on a card)
        # and the static device buffers every program reads; a changed
        # slot is copied in before the next program runs
        self._samp_host = (_host_buffer(S, torch.float32, dev),
                           _host_buffer(S, torch.int64, dev),
                           _host_buffer(S, torch.float32, dev),
                           _host_buffer((S, V), torch.float32, dev),
                           _host_buffer((S, 2), torch.int64, dev))
        self._samp_host[2].fill_(1.0)
        (self._samp_temp, self._samp_topk, self._samp_topp, self._samp_bias,
         self._samp_keys) = (t.numpy() for t in self._samp_host)
        self._samp_dev = tuple(torch.zeros_like(t, device=dev)
                               for t in self._samp_host)
        self._samp_dirty = set(range(S))
        # block tables: one static (S, MB) int32 buffer and its host mirror
        MB = max(1, self.max_blocks_per_slot)
        self._tables_host = _host_buffer((S, MB), torch.int32, dev)
        self._tables = self._tables_host.numpy()
        self._tables_dev = torch.zeros((S, MB), dtype=torch.int32,
                                       device=dev)
        self._tables_dirty = True
        # each slot's index: the rows the decode and verify bodies gather
        # and scatter by (a verify repeats slot s over its Q rows)
        self._slot_ids = torch.arange(S, device=dev)
        self._last_logprobs = None
        self._last_prefill_logprobs = None
        self._last_verify_logprobs = None
        # the program set: key -> _Program, bound at first use; captured
        # graphs share one memory pool per engine
        self._programs: Dict[tuple, _Program] = {}
        self._eager = False
        self._warmup_done = False
        self._graph_pool = None
        self._capture_seconds = 0.0
        self._pool_bytes = 0
        # speculative decoding: a draft engine attached by attach_draft
        # proposes spec_k tokens per slot for one verify to score
        self.draft: Optional["GenerationEngine"] = None
        self.spec_k = 0
        self._cache: Tuple[torch.Tensor, ...] = ()
        self.reset()
        _register_device_observers(self)

    # -- sampling plane --------------------------------------------------
    @_locked
    def set_slot_sampling(self, slot: int, params=None) -> None:
        """Install a request's :class:`~.sampling.SamplingParams` into
        ``slot`` before its prefill (None: greedy).  Cascades to an
        attached draft, so its proposals are drawn from the same key
        stream (the coupling that speculative sampling needs)."""
        s = int(slot)
        if not 0 <= s < self.max_slots:
            raise MXNetError(f"{self.name}: slot {s} out of range")
        p = params if params is not None else SamplingParams()
        self._samp_temp[s] = float(p.temperature)
        self._samp_topk[s] = int(p.top_k)
        self._samp_topp[s] = float(p.top_p)
        row = _np.zeros(self.vocab_size, _np.float32)
        if p.logit_bias:
            for t, b in p.logit_bias.items():
                if 0 <= int(t) < self.vocab_size:
                    row[int(t)] = float(b)
        self._samp_bias[s] = row
        self._samp_keys[s] = root_key(p.seed or 0)
        self._samp_dirty.add(s)
        if self.draft is not None:
            self.draft.set_slot_sampling(s, params)

    @_locked
    def update_slot_bias(self, slot: int, row) -> None:
        """Replace ``slot``'s logit-bias row for the next program
        (the JSON mode's mask; cascades to an attached draft)."""
        s = int(slot)
        self._samp_bias[s] = _np.asarray(row, _np.float32).reshape(
            self.vocab_size)
        self._samp_dirty.add(s)
        if self.draft is not None:
            self.draft.update_slot_bias(s, row)

    def last_logprobs(self):
        """Host ``(values, token ids)`` of the most recent decode, (S, N),
        or burst, (k, S, N), for every slot; None when ``logprobs_topn``
        is 0 (every program then computes none)."""
        return self._last_logprobs

    def last_prefill_logprobs(self):
        """Host ``(values, token ids)``, each (N,), of the most recent
        prefill's first sampled token; None when ``logprobs_topn`` is
        0."""
        return self._last_prefill_logprobs

    def last_verify_logprobs(self):
        """Host ``(values, token ids)`` of the most recent :meth:`verify`,
        each (S, Q, N); None when ``logprobs_topn`` is 0."""
        return self._last_verify_logprobs

    def last_decode_health(self):
        """Host ``(logit_max (S,), entropy (S,), finite (S,))`` of the most
        recent decode (a burst's folded over its steps: max, mean, all)
        when the health plane is on, else None."""
        return self._last_decode_health

    def _health(self, lg):
        """The health plane's stats of logits ``lg`` (S, V), or three
        Nones while the plane is off."""
        if not self._health_on:
            return None, None, None
        return _health.decode_health(lg)

    def _sample(self, lg, key_idx, rows=None):
        """Next token for each row of ``lg`` (R, V), the rows being the
        slots ``rows`` ((R,) int64 on the device; default: all slots);
        ``key_idx`` (R,) int64 the positions the sampled tokens will
        occupy.  Returns ``(tokens (R,) int64, logprob values (R, N),
        logprob ids (R, N))``, the last two None when ``logprobs_topn``
        is 0.  Reads the static sampling buffers only."""
        temps, topks, topps, biases, roots = self._samp_dev
        if rows is not None:
            temps, topks, topps = (t.index_select(0, rows)
                                   for t in (temps, topks, topps))
            biases, roots = biases.index_select(0, rows), \
                roots.index_select(0, rows)
        nxt = sample_tokens(lg, temps, topks, topps, biases,
                            step_keys(roots, key_idx))
        if not self.logprobs_topn:
            return nxt, None, None
        return (nxt,) + topn_logprobs(lg, biases, self.logprobs_topn)

    # -- cache lifecycle -------------------------------------------------
    @_locked
    def reset(self):
        """Zero the cache: all slots free.  Paged mode also rewipes the
        block pool, every block table and the prefix cache — cached K/V
        must never outlive the params that computed it.  Cascades to an
        attached draft."""
        if self.draft is not None:
            self.draft.reset()
        self._samp_dirty.update(range(self.max_slots))
        if self.paged:
            shape = (self.num_blocks, self.num_heads, self.block_size,
                     self.head_dim)
        else:
            shape = (self.max_slots, self.num_heads, self.max_len,
                     self.head_dim)
        with _graphs.DISPATCH_GATE.shared():
            if self._cache:
                for c in self._cache:
                    c.zero_()
            else:
                self._cache = tuple(
                    torch.zeros(shape, dtype=torch.float32,
                                device=self.device)
                    for _ in range(2 * self.num_layers))
        self._tables[:] = 0
        self._tables_dirty = True
        if self.paged:
            self.pool.reset()
            self.pool.block_bytes = self.cache_bytes // self.num_blocks
            self._slot_blocks: List[List[int]] = [
                [] for _ in range(self.max_slots)]

    @property
    def cache_bytes(self) -> int:
        return sum(c.numel() * c.element_size() for c in self._cache)

    # the batcher's stats speak the reference's one-shot engine too: the
    # slot count is the batch cap, the prefill buckets the shape buckets
    @property
    def max_batch_size(self) -> int:
        return self.max_slots

    @property
    def buckets(self):
        return self.prefill_buckets

    def prefill_bucket_for(self, n: int) -> Optional[int]:
        for b in self.prefill_buckets:
            if b >= int(n):
                return b
        return None

    def _set_table(self, slot: int, blocks) -> None:
        """Write ``slot``'s host table row (padded with the null block);
        it reaches the device buffer before the next program."""
        self._tables[slot] = 0
        self._tables[slot, :len(blocks)] = blocks
        self._tables_dirty = True

    # -- the program set ---------------------------------------------------
    def _program(self, key: tuple) -> _Program:
        """The program ``key``, bound (its static buffers allocated) at
        first use."""
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        kind, S = key[0], self.max_slots
        cls = type(self)
        if kind in ("prefill", "prefill_hit"):
            b = key[1]
            spec = [("tokens", (1, b)), ("n", (1,)), ("slot", (1,))]
            if kind == "prefill_hit":
                spec.append(("ctx", (1,)))
            body = cls._prefill_miss_body if kind == "prefill" \
                else cls._prefill_hit_body
            name = f"{kind}[{b}]"
        elif kind == "decode":
            spec = [("tokens", (S,)), ("positions", (S,))]
            body, name = cls._decode_body, "decode"
        elif kind == "decode_burst":
            spec = [("tokens", (S,)), ("positions", (S,)), ("budgets", (S,)),
                    ("eos", (S,)), ("active", (S,))]
            body, name = cls._burst_body, f"decode_burst[{key[1]}]"
        elif kind == "verify":
            spec = [("tokens", (S, key[1])), ("positions", (S,))]
            body, name = cls._verify_body, f"verify[{key[1]}]"
        else:
            raise MXNetError(f"{self.name}: no program {key!r}")
        prog = _Program(kind, name, spec, body, key[1:], self.device)
        self._programs[key] = prog
        return prog

    def _stage_state(self) -> None:
        """Copy changed block tables and sampling rows into the static
        device buffers (host range checks came before).  The copies are
        asynchronous on a card: a host mirror changes only between two
        calls, and every call ends synchronised."""
        nb = self.device.type == "cuda"
        if self._tables_dirty:
            self._tables_dev.copy_(self._tables_host, non_blocking=nb)
            self._tables_dirty = False
        if self._samp_dirty:
            for i in (0, 1, 2, 4):          # temperature, top-k, top-p, key
                self._samp_dev[i].copy_(self._samp_host[i], non_blocking=nb)
            bias_h, bias_d = self._samp_host[3], self._samp_dev[3]
            for s in sorted(self._samp_dirty):
                bias_d[s].copy_(bias_h[s], non_blocking=nb)
            self._samp_dirty.clear()

    @_locked
    @torch.no_grad()
    def _run(self, key: tuple, **inputs):
        """Run program ``key`` on ``inputs`` (host arrays, already
        checked): refill its static operands in place, replay its graph
        (card) or run its body (CPU, or the card under :meth:`_eager_bodies`),
        and return its outputs as host arrays (None where it computes
        nothing).  Every output is read back before any other program of
        this engine runs (the dispatch lock), which keeps the shared graph
        pool safe.  Outside warmup the call lands in the dispatch ledger;
        an out-of-memory error is reported (``telemetry_device``) and
        re-raised."""
        t0 = time.perf_counter()
        try:
            with _graphs.DISPATCH_GATE.shared():
                outs = self._dispatch(key, inputs)
        except Exception as e:
            if _tdev.is_oom(e):
                _tdev.report_oom("serving." + self.name, e, model=self.name)
            raise
        if not self._warming:
            self._ledger[key[0]].record(time.perf_counter() - t0)
        return outs

    def _dispatch(self, key: tuple, inputs):
        """:meth:`_run`'s staging, replay and read-back."""
        prog = self._program(key)
        for arg, val in inputs.items():
            prog.host_np[arg][...] = val
        self._stage_state()
        cuda = self.device.type == "cuda"
        prog.dev.copy_(prog.host, non_blocking=cuda)
        if cuda and not self._eager:
            if prog.graph is None:
                if not self._warming:
                    raise MXNetError(
                        f"{self.name}: program {prog.name} was never "
                        "captured; call warmup() before serving (the card "
                        "has no eager path)")
                self._capture(prog)
            prog.graph.replay()
            add_launches(prog.tally)
            outs = prog.out
        else:
            outs = prog.body(self, prog.args, *prog.static)
        prog.replays += 1
        if not cuda:
            return tuple(None if o is None else o.numpy().copy()
                         for o in outs)
        if prog.host_out is None:
            prog.host_out = tuple(
                None if o is None else _host_buffer(o.shape, o.dtype,
                                                    self.device)
                for o in outs)
        for h, o in zip(prog.host_out, outs):
            if o is not None:
                h.copy_(o, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return tuple(None if h is None else h.numpy().copy()
                     for h in prog.host_out)

    def _capture(self, prog: _Program) -> None:
        """Warm ``prog``'s body on a side stream, then capture it into a
        CUDA graph in this engine's pool.  The launches made while
        capturing are the replay's tally, not launches."""
        with _CAPTURE_LOCK:
            self._capture_locked(prog)

    def _capture_locked(self, prog: _Program) -> None:
        t0 = time.perf_counter()
        run = (self, prog.args) + prog.static
        try:
            _graphs.on_side_stream(lambda: prog.body(*run), self.device)
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph, out, tally, grown = _graphs.capture(
                lambda: prog.body(*run), self.device, self._graph_pool)
            self._pool_bytes += grown
        except Exception as e:
            raise MXNetError(f"{self.name}: capture of program {prog.name} "
                             f"failed: {e}") from e
        prog.graph, prog.out, prog.tally = graph, out, tally
        dt = time.perf_counter() - t0
        self._capture_seconds += dt
        self._ledger[prog.kind].record_compile(dt)

    @contextlib.contextmanager
    def _eager_bodies(self):
        """Run the bodies uncaptured on the card inside this block (this
        engine and its draft): the reference the graphs are held to."""
        engines = [self] + ([self.draft] if self.draft is not None else [])
        for e in engines:
            e._eager = True
        try:
            yield
        finally:
            for e in engines:
                e._eager = False

    # -- prefill ---------------------------------------------------------
    def _prime(self, tokens: torch.Tensor, n: torch.Tensor):
        """Full-prefix forward over ``tokens`` (1, Tb): the last valid
        row's logits (1, V) (``n`` (1,) the valid length) and every
        layer's K/V as (H, Tb, D)."""
        H, D = self.num_heads, self.head_dim
        Tb = tokens.shape[1]
        x = self.block._embed_at(tokens)
        ks, vs = [], []
        for cell in self._cells:
            x, k, v = cell.prime(x)
            ks.append(k.reshape(Tb, H, D).transpose(0, 1))
            vs.append(v.reshape(Tb, H, D).transpose(0, 1))
        last = self.block._project(self.block.ln_f(
            x[0].index_select(0, n - 1)))
        return last, ks, vs

    def _write_positions(self, pool, kv, table, pos) -> None:
        """Write ``kv`` (W, H, D) — the K or V of logical positions ``pos``
        (W,) int64 of a slot — into the blocks its ``table`` (MB,) names,
        in place, cast to the pool's dtype as JAX casts every write.  A
        position past the table goes to the null block 0 (JAX clamps such
        writes into a harmless sink)."""
        MB = self.max_blocks_per_slot
        col = pos // self.block_size
        blk = torch.where(col < MB, table[col.clamp(max=MB - 1)].long(),
                          torch.zeros_like(col))
        pool[blk, :, pos % self.block_size] = kv.to(pool.dtype)

    def _prefill_miss_body(self, a, bucket: int):
        """The prefix-miss prefill of one bucket: the prompt ``tokens``
        (1, bucket), valid length ``n``, into ``slot``."""
        L = self.num_layers
        last, ks, vs = self._prime(a["tokens"], a["n"])
        slot = a["slot"]
        if self.paged:
            table = self._tables_dev.index_select(0, slot)[0]
            pos = torch.arange(bucket, device=self.device)
            for l in range(L):
                self._write_positions(self._cache[l],
                                      ks[l].transpose(0, 1), table, pos)
                self._write_positions(self._cache[L + l],
                                      vs[l].transpose(0, 1), table, pos)
        else:
            # JAX donates the cache to a dynamic_update_slice at (slot,
            # 0, 0, 0); here the slot's rows are overwritten in place
            dt = self._cache[0].dtype
            for l in range(L):
                self._cache[l][slot, :, :bucket] = ks[l][None].to(dt)
                self._cache[L + l][slot, :, :bucket] = vs[l][None].to(dt)
        return self._sample(last, a["n"], slot)

    def _prefill_hit_body(self, a, Tb: int):
        """Prefix-cache hit: ``ctx`` leading positions (a multiple of
        ``block_size``) already hold valid K/V in shared blocks.  Run only
        the suffix ``tokens`` (1, Tb) (valid length ``n``), append its K/V
        at positions ``[ctx, ctx + Tb)`` and attend through the slot's
        block table.  The attention here is plain torch, as the JAX
        engine's einsum (it is outside any Pallas kernel there).  The
        caches are fp32 whatever the net's dtype: JAX promotes a 16-bit
        query against them, so the scores, p and the PV product are fp32
        here too, and the output is rounded once to the activations'
        dtype, where JAX rounds it."""
        L, H, D = self.num_layers, self.num_heads, self.head_dim
        T = self.max_blocks_per_slot * self.block_size
        C = H * D
        scale = 1.0 / math.sqrt(D)
        dev = self.device
        ctx, sn, slot = a["ctx"], a["n"], a["slot"]
        q_pos = ctx + torch.arange(Tb, device=dev)
        # padded rows may run past max_len: JAX clamps the embedding
        # gather, torch would raise
        pos = torch.clamp(q_pos, max=self.max_len - 1)[None]
        h = self.block.drop(self.block.embed(a["tokens"])
                            + self.block.pos_embed(pos))
        live = torch.arange(T, device=dev)[None, :] <= q_pos[:, None]
        table = self._tables_dev.index_select(0, slot)[0]
        idx = table.long()
        for l, cell in enumerate(self._cells):
            at = cell.attention
            hn = cell.ln1(h)
            q, kn, vn = at.query(hn), at.key(hn), at.value(hn)
            qh = q.reshape(Tb, H, D).transpose(0, 1)[None].float()
            ck, cv = self._cache[l], self._cache[L + l]
            self._write_positions(ck, kn.reshape(Tb, H, D), table, q_pos)
            self._write_positions(cv, vn.reshape(Tb, H, D), table, q_pos)
            kf = ck[idx].transpose(0, 1).reshape(1, H, T, D)
            vf = cv[idx].transpose(0, 1).reshape(1, H, T, D)
            s = torch.einsum("bhqd,bhkd->bhqk", qh, kf) * scale
            s = torch.where(live[None, None], s, torch.full_like(s, NEG))
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            attn = torch.einsum("bhqk,bhkd->bhqd",
                                p / p.sum(dim=-1, keepdim=True), vf)
            h = h + at.dropout(at.proj(
                attn.transpose(1, 2).reshape(1, Tb, C).to(h.dtype)))
            h = h + cell.ffn(cell.ln2(h))
        last = self.block._project(self.block.ln_f(
            h[0].index_select(0, sn - 1)))
        return self._sample(last, ctx + sn, slot)

    @_locked
    def prefill(self, tokens, slot: int,
                reserve_tokens: Optional[int] = None) -> int:
        """Admit a prompt into ``slot``: pad it to its bucket, run it, and
        return the FIRST generated token.  The slot's write head is then
        at ``len(tokens)``.

        Paged mode first reserves the slot's blocks for ``reserve_tokens``
        positions (default ``max_len``: prompt + budget), so decode never
        allocates; a prefix-cache hit runs only the unshared suffix.

        With a draft attached, the draft is prefilled first with the same
        prompt into the same slot, so its write head tracks this one (its
        first token is discarded: only this engine's tokens are emitted),
        and both engines reserve ``spec_k`` more positions: a verify near
        the budget edge writes up to ``spec_k`` positions past the last
        consumed token.  A failed prefill frees the draft's slot too."""
        toks = _np.asarray(tokens, _np.int32).reshape(-1)
        n = int(toks.shape[0])
        slot = int(slot)
        if not 0 <= slot < self.max_slots:
            raise MXNetError(f"{self.name}: slot {slot} out of range "
                             f"(max_slots {self.max_slots})")
        if n < 1:
            raise MXNetError(f"{self.name}: empty prompt")
        if n > self.max_len - 1:
            raise MXNetError(
                f"{self.name}: prompt length {n} leaves no room to "
                f"generate (max_len {self.max_len})")
        self._check_tokens(toks)
        if self.draft is None:
            return self._prefill_own(toks, n, slot, reserve_tokens)
        self.draft._warming = self._warming
        self.draft.prefill(toks, slot, reserve_tokens=int(
            reserve_tokens or self.max_len) + self.spec_k)
        try:
            return self._prefill_own(toks, n, slot, reserve_tokens)
        except Exception:
            self.draft.release_slot(slot)
            raise

    def _prefill_own(self, toks, n: int, slot: int, reserve_tokens) -> int:
        """:meth:`prefill` of this engine alone, on checked inputs."""
        if not self.paged:
            return self._prefill_miss(toks, n, slot)
        if self._slot_blocks[slot]:
            self._release_blocks(slot)
        reserve = int(reserve_tokens or self.max_len) \
            + (self.spec_k if self.draft is not None else 0)
        reserve = max(n + 1, min(reserve, self.max_len))
        table, m = self.pool.allocate(toks, n, reserve,
                                      share=not self._warming)
        self._slot_blocks[slot] = table
        self._set_table(slot, table)
        try:
            if m == 0:
                return self._prefill_miss(toks, n, slot)
            return self._prefill_hit(toks[m:], m, slot)
        except Exception:
            # the fresh blocks never got their K/V, but allocate()
            # already registered the full ones in the prefix cache:
            # unregister them so a later same-prefix request prefills
            # cold instead of hitting garbage
            self.pool.invalidate(table[m // self.block_size:])
            self.release_slot(slot)
            raise

    def _prefill_first(self, outs) -> int:
        first, lpv, lpi = outs
        self._last_prefill_logprobs = None if lpv is None \
            else (lpv[0], lpi[0])
        return int(first[0])

    def _prefill_miss(self, toks, n: int, slot: int) -> int:
        """Prefix-cache miss (and every dense prefill): the prompt's
        bucket program, its K/V written into the slot's blocks or dense
        row."""
        bucket = self.prefill_bucket_for(n)
        padded = _np.zeros((1, bucket), _np.int64)
        padded[0, :n] = toks
        with _telemetry.trace_span("serve.prefill", cat="serving",
                                   model=self.name, slot=slot, tokens=n,
                                   bucket=bucket):
            return self._prefill_first(self._run(
                ("prefill", bucket), tokens=padded, n=n, slot=slot))

    def _prefill_hit(self, suffix, ctx: int, slot: int) -> int:
        """Prefix-cache hit: the suffix's bucket program at context
        ``ctx``."""
        sn = int(suffix.shape[0])
        Tb = self.prefill_bucket_for(sn)
        padded = _np.zeros((1, Tb), _np.int64)
        padded[0, :sn] = suffix
        with _telemetry.trace_span("serve.prefill", cat="serving",
                                   model=self.name, slot=slot,
                                   tokens=ctx + sn, bucket=Tb,
                                   prefix_hit_tokens=ctx):
            return self._prefill_first(self._run(
                ("prefill_hit", Tb), tokens=padded, n=sn, slot=slot,
                ctx=ctx))

    # -- decode ----------------------------------------------------------
    def _layers(self, lt, emb_pos, write, attend):
        """The model over Q tokens per slot: ``lt`` (S, Q) int64 token ids
        embedded at positions ``emb_pos`` (S, Q).  In layer ``l``,
        ``write(l, k, v)`` stores the new K/V (S, Q, H, D) into that
        layer's cache in place, then ``attend(l, q)`` returns the
        attention of the queries q (S, Q, H, D) as (S, Q, H, D).  Returns
        the logits (S, Q, V)."""
        H, D = self.num_heads, self.head_dim
        S, Q = lt.shape
        kv_dtype = self._cache[0].dtype
        h = self.block.drop(self.block.embed(lt)
                            + self.block.pos_embed(emb_pos))
        for l, cell in enumerate(self._cells):
            at = cell.attention
            hn = cell.ln1(h)
            q, kn, vn = at.query(hn), at.key(hn), at.value(hn)
            # the JAX program scatters into a donated copy of the cache,
            # cast to its dtype; the port writes the pool tensors in place
            write(l, kn.reshape(S, Q, H, D).to(kv_dtype),
                  vn.reshape(S, Q, H, D).to(kv_dtype))
            attn = attend(l, q.reshape(S, Q, H, D))
            h = h + at.dropout(at.proj(attn.reshape(S, Q, H * D)))
            h = h + cell.ffn(cell.ln2(h))
        return self.block._project(self.block.ln_f(h))

    def _step_logits(self, lt, pos, blk=None, off=None):
        """One position for every slot: ``lt`` (S,) int64 tokens at write
        heads ``pos`` (S,) int64.  Writes each slot's K/V in place — at
        ``(blk, off)`` in the pools when paged, else at ``pos`` in its
        dense row — then attends over positions ``<= pos`` through K2 or
        K3.  Returns the logits (S, V)."""
        L = self.num_layers
        ck, cv = self._cache[:L], self._cache[L:]
        pos32 = pos.to(torch.int32)
        if self.paged:
            tables = self._tables_dev

            def write(l, k, v):
                ck[l][blk, :, off] = k[:, 0]
                cv[l][blk, :, off] = v[:, 0]

            def attend(l, q):
                return paged_decode_attention(q[:, 0], ck[l], cv[l], tables,
                                              pos32)[:, None]
        else:
            rows = self._slot_ids

            def write(l, k, v):
                ck[l][rows, :, pos] = k[:, 0]
                cv[l][rows, :, pos] = v[:, 0]

            def attend(l, q):
                return decode_attention(q[:, 0], ck[l], cv[l], pos32)[:, None]
        return self._layers(lt[:, None], pos[:, None], write, attend)[:, 0]

    def _block_of(self, pos):
        """Physical block of each slot's write head; the table column is
        clamped into the table, as the JAX gather clamps it."""
        col = torch.clamp(pos // self.block_size,
                          max=self.max_blocks_per_slot - 1)
        return self._tables_dev[self._slot_ids, col].long()

    def _host_positions(self, positions):
        pos = _np.asarray(positions, _np.int64).reshape(self.max_slots)
        if pos.min() < 0 or pos.max() > self.max_len - 1:
            raise MXNetError(f"{self.name}: positions must lie in [0, "
                             f"{self.max_len - 1}], got {pos.tolist()}")
        return pos

    def _check_tokens(self, toks) -> None:
        if toks.size and (int(toks.min()) < 0
                          or int(toks.max()) >= self.vocab_size):
            raise MXNetError(f"{self.name}: token ids outside the vocab "
                             f"[0, {self.vocab_size})")

    def _decode_body(self, a):
        lt, pos = a["tokens"], a["positions"]
        blk = off = None
        if self.paged:
            blk, off = self._block_of(pos), pos % self.block_size
        lg = self._step_logits(lt, pos, blk, off)
        # keyed at pos + 1, the position the token will occupy
        return self._sample(lg, pos + 1) + self._health(lg)

    @_locked
    def decode(self, last_tokens, positions):
        """Advance EVERY slot one position: ``last_tokens`` (S,) (free
        slots: 0) at write heads ``positions`` (S,) (free slots: 0).
        Returns the next token per slot as a host int32 array."""
        lt = _np.asarray(last_tokens, _np.int64).reshape(self.max_slots)
        self._check_tokens(lt)
        pos = self._host_positions(positions)
        nxt, lpv, lpi, *health = self._run(("decode",), tokens=lt,
                                           positions=pos)
        self._last_logprobs = None if lpv is None else (lpv, lpi)
        self._last_decode_health = None if health[0] is None \
            else tuple(health)
        return nxt.astype(_np.int32)

    def _burst_body(self, a, k: int):
        lt, pos = a["tokens"], a["positions"]
        bud, eos = a["budgets"], a["eos"]
        done = a["active"] == 0
        emitted = torch.zeros_like(pos)
        toks, vals, ids, hs = [], [], [], []
        for _ in range(k):
            blk = off = None
            if self.paged:
                blk = torch.where(done, torch.zeros_like(pos),
                                  self._block_of(pos))
                off = pos % self.block_size
            lg = self._step_logits(lt, pos, blk, off)
            # keyed at pos + 1, the position this token will occupy
            nxt, lpv, lpi = self._sample(lg, pos + 1)
            emit = ~done
            emitted = emitted + emit.long()
            done = done | (emit & ((nxt == eos) | (emitted >= bud)))
            lt = torch.where(done, lt, nxt)
            pos = torch.where(done, pos, pos + 1)
            toks.append(nxt)
            vals.append(lpv)
            ids.append(lpi)
            hs.append(self._health(lg))
        out = (torch.stack(toks), emitted)
        out += (None, None) if not self.logprobs_topn \
            else (torch.stack(vals), torch.stack(ids))
        if not self._health_on:
            return out + (None, None, None)
        # a frozen slot's later steps repeat its last live step's logits:
        # max and all are exact over the live steps, the mean leans
        # toward the frozen value (the JAX engine's fold)
        hmax, hent, hfin = (torch.stack(h) for h in zip(*hs))
        return out + (hmax.amax(0), hent.mean(0), hfin.all(0))

    @_locked
    def decode_burst(self, last_tokens, positions, budgets, eos_ids,
                     active):
        """Advance every slot up to ``scan_steps`` positions with the
        per-slot termination of the JAX scan kept on the device:
        ``budgets`` (S,) caps the tokens each slot may emit, ``eos_ids``
        (S,) is its stop token (-1: none), ``active`` (S,) is False for
        free slots.  A slot that hits eos or its budget freezes: its
        (token, position) stop advancing and its later K/V writes go to
        the null block (paged) or rewrite the same dense entry.  Returns
        host arrays ``(tokens (k, S) int32, emitted (S,) int32)``; slot
        ``s`` emitted ``tokens[:emitted[s], s]``, the same tokens as that
        many :meth:`decode` calls."""
        k = int(self.scan_steps)
        if k < 1:
            raise MXNetError(
                f"{self.name}: decode bursts disabled (scan_steps "
                f"{self.scan_steps}; set MXNET_DECODE_SCAN_STEPS >= 1)")
        S = self.max_slots
        pos_h = self._host_positions(positions)
        bud_h = _np.asarray(budgets, _np.int64).reshape(S)
        act_h = _np.asarray(active, bool).reshape(S)
        reach = pos_h + _np.clip(bud_h, 1, k) - 1
        if (act_h & (reach > self.max_len - 1)).any():
            raise MXNetError(
                f"{self.name}: a burst would write past max_len "
                f"{self.max_len} (positions {pos_h.tolist()}, budgets "
                f"{bud_h.tolist()})")
        lt = _np.asarray(last_tokens, _np.int64).reshape(S)
        self._check_tokens(lt)
        toks, emitted, lpv, lpi, *health = self._run(
            ("decode_burst", k), tokens=lt, positions=pos_h, budgets=bud_h,
            eos=_np.asarray(eos_ids, _np.int64).reshape(S), active=act_h)
        self._last_logprobs = None if lpv is None else (lpv, lpi)
        self._last_decode_health = None if health[0] is None \
            else tuple(health)
        return toks.astype(_np.int32), emitted.astype(_np.int32)

    # -- speculative decoding --------------------------------------------
    def attach_draft(self, draft: "GenerationEngine",
                     spec_k: Optional[int] = None) -> None:
        """Attach a (small) draft engine for speculative decoding.

        The draft proposes ``spec_k`` tokens per slot (default
        ``MXNET_SPEC_K``, 4); :meth:`verify` scores all ``spec_k + 1``
        positions at once.  The draft must mirror this engine's slot
        layout and position space: the same ``max_slots``, a ``max_len``
        at least this one's, the same vocabulary (sampled ids are
        compared).  Attach before :meth:`warmup`."""
        if draft is self:
            raise MXNetError(f"{self.name}: a model cannot draft itself")
        if int(draft.max_slots) != self.max_slots:
            raise MXNetError(
                f"{self.name}: draft max_slots {draft.max_slots} != "
                f"target max_slots {self.max_slots}")
        if int(draft.max_len) < self.max_len:
            raise MXNetError(
                f"{self.name}: draft max_len {draft.max_len} < target "
                f"max_len {self.max_len} (the draft decodes at the same "
                f"positions)")
        if int(draft.vocab_size) != self.vocab_size:
            raise MXNetError(f"{self.name}: draft vocab {draft.vocab_size} "
                             f"!= target vocab {self.vocab_size}")
        k = int(spec_k if spec_k is not None
                else getenv_int("MXNET_SPEC_K", 4))
        if k < 1:
            raise MXNetError(f"spec_k must be >= 1, got {k}")
        self.draft = draft
        self.spec_k = k
        # the draft's tokens are never emitted, so it computes no logprobs
        draft.logprobs_topn = 0
        # the k draft steps run as one burst; scan_steps == 0 (bursts
        # switched off) keeps the host loop of spec_step
        if draft.scan_steps != 0:
            draft.scan_steps = k

    def _verify_body(self, a, Q: int):
        S = self.max_slots
        L = self.num_layers
        dev = self.device
        toks, pos = a["tokens"], a["positions"]
        pos_q = pos[:, None] + torch.arange(Q, device=dev)[None, :]  # (S, Q)
        pos32 = pos.to(torch.int32)
        rows = self._slot_ids[:, None].expand(S, Q)
        ck, cv = self._cache[:L], self._cache[L:]
        if self.paged:
            tables = self._tables_dev
            MB = self.max_blocks_per_slot
            col = pos_q // self.block_size
            ok = (col < MB) & (pos_q < self.max_len)
            blk = torch.where(ok, tables[rows, col.clamp(max=MB - 1)].long(),
                              torch.zeros_like(col))
            off = pos_q % self.block_size

            def write(l, k, v):
                # several redirected (slot, row) pairs may land on one null
                # block address: it is garbage by contract and no live row
                # reads a position written there
                ck[l][blk, :, off] = k
                cv[l][blk, :, off] = v

            def attend(l, q):
                return paged_verify_decode_attention(
                    q.transpose(1, 2).contiguous(), ck[l], cv[l], tables,
                    pos32).transpose(1, 2)
        else:
            # a fixed-shape write: row j goes to positions[s] + j where
            # that lies below max_len; a row past it writes row
            # (max_len - 1 - positions[s])'s K/V again at max_len - 1, so
            # duplicate indices carry identical values and the live write
            # there wins whatever the order
            src = torch.minimum(torch.arange(Q, device=dev)[None, :],
                                (self.max_len - 1 - pos)[:, None])
            dst = pos[:, None] + src

            def write(l, k, v):
                ck[l][rows, :, dst] = k[rows, src]
                cv[l][rows, :, dst] = v[rows, src]

            def attend(l, q):
                return verify_decode_attention(
                    q.transpose(1, 2).contiguous(), ck[l], cv[l],
                    pos32).transpose(1, 2)
        lg = self._layers(toks, torch.clamp(pos_q, max=self.max_len - 1),
                          write, attend)
        # each slot's sampling parameters repeated over its Q rows
        nxt, lpv, lpi = self._sample(lg.reshape(S * Q, -1),
                                     (pos_q + 1).reshape(-1),
                                     rows.reshape(-1))
        if lpv is None:
            return nxt.reshape(S, Q), None, None
        return (nxt.reshape(S, Q), lpv.reshape(S, Q, -1),
                lpi.reshape(S, Q, -1))

    @_locked
    def verify(self, tokens, positions):
        """Score Q positions for EVERY slot at once: ``tokens`` (S, Q) —
        column 0 each slot's last accepted token, columns 1..Q-1 the
        draft's proposals — at base write heads ``positions`` (S,).

        Writes the Q positions' K/V per slot and layer — dense writes past
        ``max_len`` are dropped, paged writes past the slot's reservation
        or ``max_len`` go to the null block, so an overrun row near the
        budget edge never lands on a live entry — embeds row j at position
        ``min(positions[s] + j, max_len - 1)``, and attends through K4 or
        K5.  Returns a host int32 (S, Q) array: ``out[s, j]`` is the token
        sampled after consuming ``tokens[s, :j + 1]``, keyed at position
        ``positions[s] + j + 1`` exactly as :meth:`decode` keys it there.
        With Q == 1 this is :meth:`decode`."""
        S = self.max_slots
        toks = _np.asarray(tokens, _np.int64).reshape(S, -1)
        self._check_tokens(toks)
        pos = self._host_positions(positions)
        out, lpv, lpi = self._run(("verify", toks.shape[1]), tokens=toks,
                                  positions=pos)
        self._last_verify_logprobs = None if lpv is None else (lpv, lpi)
        return out.astype(_np.int32)

    @_locked
    def spec_step(self, last_tokens, positions):
        """One speculative step for EVERY slot: the draft proposes
        ``spec_k`` tokens per slot (one burst, or ``spec_k`` decodes when
        the draft's bursts are off), then one :meth:`verify` scores all
        ``spec_k + 1`` positions.

        Acceptance is the JAX engine's Gumbel-coupled speculative
        sampling: both engines key their samples by (slot root, position),
        so at every position they share one noise vector, and a draft
        token is accepted while it equals the target's sample there.
        Every emitted token is a target sample, the same token plain
        decode emits at that position, at any accept rate; greedy is the
        temperature-0 case.

        Returns ``(out, accepted)``: ``out`` (S, spec_k + 1) int32, of
        which ``out[s, :accepted[s] + 1]`` are this step's tokens, and
        ``accepted`` (S,) in ``[0, spec_k]``.  Rejected positions are
        rolled back by not advancing past them: their stale K/V is masked
        and overwritten by the next dispatch, and in paged mode
        :meth:`~.kvcache.BlockPool.rewind` keeps that overwrite out of
        any shared block.  Acceptance and rollback run on the host,
        between the draft's program and the verify's."""
        if self.draft is None:
            raise MXNetError(f"{self.name}: no draft attached "
                             "(attach_draft first)")
        k, S = self.spec_k, self.max_slots
        last = _np.asarray(last_tokens, _np.int32).reshape(S)
        pos = self._host_positions(positions)
        # The draft never writes past position max_len - 1.  A proposal
        # consumed at position p is a guess for position p + 1, and no
        # token is ever emitted at max_len or later, so a slot's burst
        # stops after max_len - pos steps (its later proposals repeat the
        # last one, as a frozen burst slot does) and every proposal that
        # can be emitted is still the one JAX drafts.  The JAX draft runs
        # on past the cap, with dropped or clamped writes, where the
        # port's index checks would raise.
        room = self.max_len - pos
        if self.draft.scan_steps == k:
            drafted, _ = self.draft.decode_burst(
                last, pos, budgets=_np.minimum(room, k + 1),
                eos_ids=_np.full(S, -1, _np.int32),
                active=_np.ones(S, bool))
            drafted = _np.ascontiguousarray(drafted.T)              # (S, k)
        else:
            drafted = _np.zeros((S, k), _np.int32)
            lt, pv = last, pos
            for j in range(k):
                nxt = _np.asarray(self.draft.decode(lt, pv),
                                  _np.int32).reshape(S)
                drafted[:, j] = nxt
                go = pv + 1 < self.max_len
                lt, pv = _np.where(go, nxt, lt), _np.where(go, pv + 1, pv)
        out = self.verify(_np.concatenate([last[:, None], drafted], axis=1),
                          pos)
        match = out[:, :k] == drafted                               # (S, k)
        accepted = _np.where(match.all(axis=1), k,
                             _np.argmin(match, axis=1))
        if self.paged or self.draft.paged:
            self._rollback_rejected(pos, accepted)
        return out, accepted

    def _rollback_rejected(self, base_positions, accepted) -> None:
        """Paged rollback after a verify: for every slot that rejected
        draft tokens, run the pool's copy-on-write guard over the dirty
        tail of both engines' tables, so the next dispatch's overwrites
        cannot touch a shared block.  A changed table reaches the static
        buffer before either engine's next program."""
        for s in range(self.max_slots):
            if int(accepted[s]) >= self.spec_k:
                continue
            keep = int(base_positions[s]) + int(accepted[s]) + 1
            for eng in (self, self.draft):
                if not eng.paged or not eng._slot_blocks[s]:
                    continue
                blocks = eng._slot_blocks[s]
                new = eng.pool.rewind(blocks, keep)
                if new != blocks:
                    eng._slot_blocks[s] = new
                    eng._set_table(s, new)

    # -- paged-pool bookkeeping (no-ops in dense mode) --------------------
    @_locked
    def release_slot(self, slot: int) -> None:
        """Return ``slot``'s blocks to the pool (decref: shared prefix
        blocks stay live for their other readers and the prefix cache).
        Cascades to an attached draft's mirrored slot."""
        if self.draft is not None:
            self.draft.release_slot(slot)
        self._release_blocks(slot)

    def _release_blocks(self, slot: int) -> None:
        """:meth:`release_slot` of this engine's own blocks."""
        if not self.paged:
            return
        blocks = self._slot_blocks[int(slot)]
        if blocks:
            self.pool.release(blocks)
        self._slot_blocks[int(slot)] = []
        self._set_table(int(slot), [])

    def can_admit(self, tokens, reserve_tokens: int,
                  reserved_blocks: int = 0) -> bool:
        """Can the pool reserve worst-case capacity for this prompt now?
        ``reserved_blocks`` discounts capacity promised to earlier admits
        of the same scheduling step.  Dense mode always admits.  With a
        draft attached both pools must fit the reservation plus the
        ``spec_k`` verify headroom."""
        if self.draft is not None and not self.draft.can_admit(
                tokens, int(reserve_tokens) + self.spec_k,
                reserved_blocks):
            return False
        if not self.paged:
            return True
        toks = _np.asarray(tokens, _np.int32).reshape(-1)
        n = int(toks.shape[0])
        reserve = int(reserve_tokens) \
            + (self.spec_k if self.draft is not None else 0)
        reserve = max(n + 1, min(reserve, self.max_len))
        return self.pool.can_admit(toks, n, reserve, reserved_blocks)

    def reserve_estimate(self, reserve_tokens: int) -> int:
        """Worst-case blocks a request reserving ``reserve_tokens``
        positions takes (no sharing assumed)."""
        if not self.paged:
            return 0
        reserve = int(reserve_tokens) \
            + (self.spec_k if self.draft is not None else 0)
        return blocks_for(min(reserve, self.max_len), self.block_size)

    def kv_capacity_tokens(self) -> int:
        """Token positions the KV cache holds across all requests."""
        if self.paged:
            return (self.num_blocks - 1) * self.block_size
        return self.max_slots * self.max_len

    def kv_stats(self) -> dict:
        out = {"kv_paged": self.paged,
               "kv_capacity_tokens": self.kv_capacity_tokens()}
        if self.paged:
            out.update(self.pool.stats())
        return out

    def slot_occupancy(self) -> List[dict]:
        """Blocks held and reserved token capacity per live slot (paged
        mode; ``[]`` dense)."""
        if not self.paged:
            return []
        return [{"slot": s, "blocks": len(b),
                 "reserved_tokens": len(b) * self.block_size}
                for s, b in enumerate(self._slot_blocks) if b]

    # -- the closed program set ------------------------------------------
    @property
    def expected_programs(self) -> int:
        """Size of the closed program set (the JAX engine's formula): one
        prefill per bucket (plus one suffix prefill per bucket when the
        prefix cache can hit), ONE decode, ONE decode burst when
        ``scan_steps >= 1`` (budgets, eos ids and the done mask are
        operands) and, with a draft attached, ONE verify of ``spec_k + 1``
        rows."""
        per_bucket = 2 if self.prefix_cache_enabled else 1
        return per_bucket * len(self.prefill_buckets) + 1 \
            + (1 if self.scan_steps >= 1 else 0) \
            + (1 if self.draft is not None else 0)

    def compiled_programs(self) -> int:
        """Programs of this engine ready to run: captured graphs on the
        card, bound bodies on the CPU."""
        progs = list(self._programs.values())
        if self.device.type == "cuda":
            return sum(p.graph is not None for p in progs)
        return len(progs)

    @property
    def warm(self) -> bool:
        if self._warmup_done:
            return True
        return self.compiled_programs() >= self.expected_programs

    def program_inventory(self) -> dict:
        """The closed-set accounting (expected against compiled programs)
        with each program's call count and per-slot KV occupancy, under
        the JAX engine's keys.  Recurses into an attached draft."""
        inv = {
            "model": self.name,
            "expected_programs": self.expected_programs,
            "compiled_programs": self.compiled_programs(),
            "warm": self.warm,
            "paged": self.paged,
            "scan_steps": self.scan_steps,
            "spec_k": self.spec_k if self.draft is not None else 0,
            "programs": {p.name: {"dispatches": p.replays,
                                  "captured": p.graph is not None}
                         for p in list(self._programs.values())},
            "slots": self.slot_occupancy(),
        }
        if self.draft is not None:
            inv["draft"] = self.draft.program_inventory()
        return inv

    def graph_stats(self) -> dict:
        """Capture cost on the card: programs expected and captured, the
        seconds spent warming and capturing them, and the bytes the
        engine's shared graph pool reserved (0 on the CPU)."""
        return {"expected": self.expected_programs,
                "captured": sum(p.graph is not None
                                for p in self._programs.values()),
                "capture_seconds": self._capture_seconds,
                "pool_bytes": self._pool_bytes}

    @_locked
    def warmup(self) -> int:
        """Bind the whole closed program set — every prefill bucket (miss
        and, with the prefix cache, the suffix variant, whose writes land
        in the null block), decode, the burst and, with a draft attached,
        verify — by running each once; on the card each is warmed on a
        side stream and captured.  Then reset the cache (warmup traffic
        must not look like live slots or poison the prefix cache) and warm
        the draft.  Raises on accounting drift: a program count other than
        ``expected_programs`` means the set is not closed.  Returns
        ``expected_programs``."""
        S = self.max_slots
        self._warming = True
        try:
            for b in self.prefill_buckets:
                self.prefill(_np.zeros(max(1, min(b, self.max_len - 1)),
                                       _np.int32), 0)
                self.release_slot(0)
            if self.paged and self.prefix_cache_enabled:
                # slot 0's table row is all null blocks after its release
                for b in self.prefill_buckets:
                    self._prefill_hit(
                        _np.zeros(max(1, min(b, self.max_len - 1)),
                                  _np.int64), 0, 0)
            zeros = _np.zeros(S, _np.int32)
            self.decode(zeros, zeros)
            if self.scan_steps >= 1:
                # budgets of 1 exercise the in-program done path
                self.decode_burst(zeros, zeros, _np.ones(S, _np.int32),
                                  _np.full(S, -1, _np.int32),
                                  _np.ones(S, bool))
            if self.draft is not None:
                self.verify(_np.zeros((S, self.spec_k + 1), _np.int32),
                            zeros)
        finally:
            self._warming = False
        self.reset()
        if self.draft is not None:
            self.draft.warmup()
        compiled = self.compiled_programs()
        if compiled != self.expected_programs:
            raise MXNetError(
                f"{self.name}: program accounting drift after warmup — "
                f"compiled {compiled} programs, expected "
                f"{self.expected_programs} (closed program set violated)")
        self._warmup_done = True
        return self.expected_programs

    @_locked
    def generate(self, tokens, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 speculative: Optional[bool] = None, sampling=None):
        """Solo generation through the serving programs (slot 0):
        prefill, then one :meth:`decode` per token — or, with a draft
        attached, one :meth:`spec_step` per 1 to ``spec_k + 1`` tokens
        (the default then; ``speculative=False`` forces plain decode).
        Every emitted token is a target sample either way, so the outputs
        are the same.  ``sampling`` is an optional
        :class:`~.sampling.SamplingParams` (None: greedy).  Returns the
        generated tokens as a list."""
        toks = list(_np.asarray(tokens, _np.int32).reshape(-1))
        n = len(toks)
        budget = min(int(max_new_tokens), self.max_len - n)
        if budget < 1:
            raise MXNetError(
                f"{self.name}: no token budget (prompt {n}, max_len "
                f"{self.max_len})")
        spec = self.draft is not None and (speculative is None
                                           or bool(speculative))
        self.set_slot_sampling(0, sampling)
        out = [self.prefill(toks, 0, reserve_tokens=n + budget)]
        try:
            lt = _np.zeros(self.max_slots, _np.int32)
            pv = _np.zeros(self.max_slots, _np.int32)
            while len(out) < budget and (eos_id is None
                                         or out[-1] != int(eos_id)):
                lt[0] = out[-1]
                pv[0] = n + len(out) - 1
                if not spec:
                    out.append(int(self.decode(lt, pv)[0]))
                    continue
                burst, acc = self.spec_step(lt, pv)
                for t in burst[0, :int(acc[0]) + 1]:
                    out.append(int(t))
                    if len(out) >= budget or (eos_id is not None
                                              and out[-1] == int(eos_id)):
                        break
        finally:
            self.release_slot(0)
        return out

    def __repr__(self):
        return (f"<GenerationEngine {self.name!r}: slots={self.max_slots}, "
                f"max_len={self.max_len}, layers={self.num_layers}, "
                f"heads={self.num_heads}, paged={self.paged}, "
                f"device={self.device}>")
