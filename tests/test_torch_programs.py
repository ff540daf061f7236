"""The serving engine's closed program set in the port
(``incubator_mxnet_tpu_torch/serving/engine.py``) against the JAX engine's
accounting, at ``gpt_tiny`` width (vocab 512, 64 units, 2 layers, 2
heads, max_len 128) with 8 slots, fp32 on the CPU.

The JAX side runs in a child interpreter, once per module, with every
``MXNET_*`` variable unset: it builds one JAX ``GenerationEngine`` per
configuration (paged or dense, prefix cache on or off, ``scan_steps`` 0
or 8, a draft attached or not) and reports each one's
``expected_programs`` and its ``program_inventory()`` keys; it warms
none (the counts need no compile).

On the CPU the port binds every program body over its static buffers at
warmup; on a card it captures each as a CUDA graph.  The tests here hold
the accounting to JAX's formula and to the JAX tests of the closed set
(``test_device_obs.py``, ``test_decode_scan.py``), check that state
changed between two calls (sampling parameters, a bias row, a block
table rewritten by a paged rollback) reaches the next call, and that a
dense verify writes nothing past ``max_len``.  The ``cuda`` tests hold the
graph replays to the eager bodies bit for bit and the replays' launch
counts to the eager ones."""
import gc
import itertools
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import initializer as tinit
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.serving import (ContinuousBatcher,
                                               GenerationEngine,
                                               SamplingParams)

ROOT = Path(__file__).resolve().parents[1]
SLOTS = 8
# (paged, prefix_cache, scan_steps, draft)
CONFIGS = list(itertools.product((True, False), (True, False), (0, 8),
                                 (False, True)))

_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json, sys, itertools
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.models.gpt import gpt_tiny
from incubator_mxnet_tpu.serving import GenerationEngine
slots, configs = eval(sys.argv[1])
mx.random.seed(0)
net = gpt_tiny(dropout=0.0)
net.initialize(init=mx.init.Normal(0.02))
net(mx.nd.array(np.zeros((1, 2), np.int32)))
out = {"expected": [], "keys": None, "draft_keys": None}
for paged, prefix, scan, draft in configs:
    kw = dict(max_slots=slots, paged=paged, prefix_cache=prefix,
              scan_steps=scan)
    eng = GenerationEngine(net, name="t", **kw)
    if draft:
        eng.attach_draft(GenerationEngine(net, name="d", **kw), spec_k=4)
    out["expected"].append(eng.expected_programs)
    if draft and out["keys"] is None:
        inv = eng.program_inventory()
        out["keys"] = sorted(inv)
        out["draft_keys"] = sorted(inv["draft"])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_ref():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, repr((SLOTS, CONFIGS))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def net():
    n = gpt_tiny(dropout=0.0, device="cpu")
    tinit.initialize(n, tinit.Normal(0.02), 0)
    return n


def _engine(net, name="t", **kw):
    kw.setdefault("max_slots", SLOTS)
    return GenerationEngine(net, name=name, **kw)


def _with_draft(net, **kw):
    eng = _engine(net, **kw)
    eng.attach_draft(_engine(net, name="d", **kw), spec_k=4)
    return eng


# ------------------------------------------------- accounting against JAX
@pytest.mark.parametrize("i", range(len(CONFIGS)),
                         ids=["paged%d-prefix%d-scan%d-draft%d" % c
                              for c in CONFIGS])
def test_expected_programs_match_jax_and_warmup_binds_them(net, jax_ref, i):
    paged, prefix, scan, draft = CONFIGS[i]
    kw = dict(paged=paged, prefix_cache=prefix, scan_steps=scan)
    eng = _with_draft(net, **kw) if draft else _engine(net, **kw)
    assert eng.expected_programs == jax_ref["expected"][i]
    assert eng.compiled_programs() == 0 and not eng.warm
    assert eng.warmup() == eng.expected_programs == eng.compiled_programs()
    assert eng.warm
    if draft:
        d = eng.draft
        assert d.compiled_programs() == d.expected_programs
    if paged:
        assert eng.pool.blocks_in_use == 0      # warmup traffic is gone


def test_inventory_has_the_jax_keys_and_nests_the_draft(net, jax_ref):
    eng = _with_draft(net)
    eng.warmup()
    inv = eng.program_inventory()
    assert sorted(inv) == jax_ref["keys"]
    assert sorted(inv["draft"]) == jax_ref["draft_keys"]
    assert inv["draft"]["model"] == "d" and inv["spec_k"] == 4
    assert inv["compiled_programs"] == inv["expected_programs"]
    assert inv["draft"]["compiled_programs"] \
        == inv["draft"]["expected_programs"]
    assert "verify[5]" in inv["programs"] and "draft" not in inv["draft"]
    assert sorted(_engine(net).program_inventory()) \
        == [k for k in jax_ref["keys"] if k != "draft"]


def test_serving_leaves_the_program_set_closed(net):
    """Misses, prefix hits and mid-flight joins through the batcher, plain
    and speculative: no program is bound after warmup, and the calls are
    counted per program."""
    system = [int(t) for t in np.random.RandomState(1).randint(1, 500, 40)]
    prompts = [system + [7, i] for i in range(5)] + [[3, 4, 5], [9] * 70]
    for eng in (_engine(net), _with_draft(net)):
        n = eng.warmup()
        drafts = eng.draft.compiled_programs() if eng.draft else None
        hits = eng.pool.hits
        bat = ContinuousBatcher(eng)
        try:
            reqs = [bat.submit_async(p, max_new_tokens=12) for p in prompts]
            outs = [r.result(timeout=120) for r in reqs]
        finally:
            bat.close()
        assert [len(o) for o in outs] == [12] * len(prompts)
        assert eng.pool.hits > hits
        assert eng.compiled_programs() == n == eng.expected_programs
        if eng.draft is not None:
            assert eng.draft.compiled_programs() == drafts
        calls = {k: v["dispatches"]
                 for k, v in eng.program_inventory()["programs"].items()}
        # warmup called each program once
        assert calls["prefill[64]"] > 1 and calls["prefill_hit[16]"] > 1
        assert calls["verify[5]" if eng.draft else "decode_burst[8]"] > 1


def test_accounting_drift_raises(net, monkeypatch):
    """As the JAX engine: a warmup whose program count disagrees with the
    prediction raises, and a burst length changed after warmup is a
    drift."""
    eng = _engine(net, scan_steps=4, prefill_buckets=(16, 128))
    assert eng.warmup() == eng.expected_programs == 6
    monkeypatch.setattr(eng, "compiled_programs", lambda: 999)
    with pytest.raises(MXNetError, match="program accounting drift"):
        eng.warmup()
    monkeypatch.undo()
    eng.scan_steps = 0
    with pytest.raises(MXNetError, match="program accounting drift"):
        eng.warmup()


def test_a_dropped_engine_is_freed_without_a_cyclic_collection(net):
    """No program refers back to its engine: dropping a warm engine (and
    its draft) frees it at once, so its graphs are never destroyed by a
    cyclic collection inside another engine's capture."""
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        eng = _with_draft(net)
        eng.warmup()
        eng.generate([1, 2, 3], 5)
        refs = weakref.ref(eng), weakref.ref(eng.draft)
        del eng
        assert [r() for r in refs] == [None, None]
    finally:
        if enabled:
            gc.enable()


# ------------------------------ state changed between two calls is seen
def _steps(eng, prompt, inputs, change=None, at=0):
    """Prefill ``prompt`` into slot 0 and feed it the host tokens
    ``inputs`` one decode at a time, calling ``change(eng)`` before the
    decode of ``inputs[at]``; returns the sampled tokens."""
    got = [eng.prefill(prompt, 0, reserve_tokens=len(prompt) + 16)]
    lt, pv = np.zeros(SLOTS, np.int32), np.zeros(SLOTS, np.int32)
    for j, t in enumerate(inputs):
        if change is not None and j == at:
            change(eng)
        lt[0], pv[0] = t, len(prompt) + j
        got.append(int(eng.decode(lt, pv)[0]))
    eng.release_slot(0)
    return got


@pytest.mark.parametrize("change", ["sampling", "bias"])
def test_sampling_state_reaches_the_next_call(net, change):
    """A warm engine serves three steps under one state, then the state
    changes (new sampling parameters, or a bias row that forbids the
    greedy tokens) and it serves three more: those three are a fresh
    engine's under the new state from the start, on the same inputs."""
    prompt = [5, 17, 250, 3]
    eng = _engine(net)
    eng.warmup()
    greedy = eng.generate(prompt, 7)
    inputs = greedy[:6]

    def install(e):
        if change == "sampling":
            e.set_slot_sampling(0, SamplingParams(temperature=0.9, top_k=40,
                                                  seed=123))
        else:
            row = np.zeros(512, np.float32)
            row[greedy[4:]] = -1e9
            e.update_slot_bias(0, row)
    got = _steps(eng, prompt, inputs, install, at=3)
    want = _steps(_engine(net), prompt, inputs, install, at=0)
    assert got[:4] == greedy[:4]
    assert got[4:] == want[4:]
    assert got[4:] != greedy[4:]               # the change took effect


def test_paged_rollback_table_reaches_the_next_call(net):
    """A rejected draft token whose dirty block another reader holds: the
    rollback swaps a fresh block into the slot's table between the verify
    and the next call, and the tokens after it are plain decode's."""
    V = 512
    tgt = _engine(net)
    drf = _engine(net, name="d", scan_steps=0)
    tgt.attach_draft(drf, spec_k=4)
    real = drf.decode
    drf.decode = lambda last, pos: (np.asarray(real(last, pos)) + 1) % V
    tgt.warmup()
    prompt = [int(t) for t in np.random.RandomState(2).randint(0, V, 15)]
    want = _engine(net).generate(prompt, 10)
    tgt.set_slot_sampling(0, None)
    out = [tgt.prefill(prompt, 0, reserve_tokens=25)]
    shared = tgt._slot_blocks[0][1]                  # positions 16..31
    tgt.pool._incref(shared)                         # a second reader
    lt, pv = np.zeros(SLOTS, np.int32), np.zeros(SLOTS, np.int32)
    lt[0], pv[0] = out[0], 15
    burst, acc = tgt.spec_step(lt, pv)
    assert acc[0] == 0                               # keep = 16
    assert tgt._slot_blocks[0][1] != shared          # a new table row
    assert tgt._tables[0, 1] == tgt._slot_blocks[0][1]
    out.append(int(burst[0, 0]))
    while len(out) < 10:
        lt[0], pv[0] = out[-1], len(prompt) + len(out) - 1
        out.append(int(tgt.decode(lt, pv)[0]))
    assert out == want


def test_dense_verify_past_max_len_writes_nothing(net):
    """A dense verify of 5 rows at positions up to ``max_len - 1``: every
    cache entry outside ``[positions[s], min(positions[s] + 5, max_len))``
    keeps its bits, and the entries inside hold what a verify of only the
    rows that fit writes there (the live write at ``max_len - 1`` wins
    over the rows past it)."""
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 512, (SLOTS, 5)).astype(np.int32)
    pos = np.array([125, 120, 127, 0, 3, 124, 126, 60], np.int32)
    eng = _engine(net, paged=False)
    for c in eng._cache:
        c.copy_(torch.from_numpy(rng.randn(*c.shape).astype(np.float32)))
    before = [c.clone() for c in eng._cache]
    eng.verify(toks, pos)
    for s in range(SLOTS):
        q = min(5, 128 - int(pos[s]))
        one = GenerationEngine(net, max_slots=1, paged=False)
        for c1, c in zip(one._cache, before):
            c1.copy_(c[s:s + 1])
        one.verify(toks[s:s + 1, :q], pos[s:s + 1])
        live = slice(int(pos[s]), int(pos[s]) + q)
        for c1, c, b in zip(one._cache, eng._cache, before):
            np.testing.assert_allclose(c[s, :, live].numpy(),
                                       c1[0, :, live].numpy(),
                                       rtol=1e-5, atol=1e-6)
            kept = torch.ones(128, dtype=torch.bool)
            kept[live] = False
            assert torch.equal(c[s][:, kept], b[s][:, kept])


# ---------------------------------------------------- on the card (cuda)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs run only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["paged", "dense", "paged_spec"])
def test_cuda_graph_replays_equal_eager_bodies(path):
    """16 steps with sampling parameters and tables changed between
    steps: the replays' tokens are the eager bodies' bit for bit, and the
    replays count the eager bodies' launches."""
    _need_cuda()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import graph_vs_eager
    n = gpt_tiny(dropout=0.0, device="cuda")
    tinit.initialize(n, tinit.Normal(0.02), 0)
    eng = _engine(n, paged=path != "dense")
    if path == "paged_spec":
        eng.attach_draft(_engine(n, name="d"), spec_k=4)
    eng.warmup()
    assert eng.graph_stats()["captured"] == eng.expected_programs
    prompts = [[int(t) for t in np.random.RandomState(s).randint(0, 512, ln)]
               for s, ln in enumerate((5, 40, 17, 90, 33))]
    same, graph_counts, eager_counts = graph_vs_eager(eng, prompts, 16)
    assert same
    assert graph_counts == eager_counts
    assert sum(graph_counts.values()) > 0
