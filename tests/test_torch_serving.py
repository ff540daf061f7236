"""The port's serving stack (``incubator_mxnet_tpu_torch/serving``) against
the JAX package's on the same weights, fp32 on the CPU: the sampling
hash bit for bit, the block pool op for op, and the generation engine
token for token — paged == dense == ``net.generate`` == the JAX engine,
prefix hit == miss, burst == per-step decode, seeded sampling == the JAX
engine's — plus continuous batching with a mid-flight join."""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.models.gpt import GPTModel as JaxGPT
from incubator_mxnet_tpu.serving import GenerationEngine as JaxEngine
from incubator_mxnet_tpu.serving import kvcache as jkv
from incubator_mxnet_tpu.serving import sampling as jsamp
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models.gpt import GPTModel
from incubator_mxnet_tpu_torch.serving import (BlockPool,
                                               ContinuousBatcher,
                                               GenerationEngine,
                                               SamplingParams)
from incubator_mxnet_tpu_torch.serving import sampling as tsamp

SHAPE = dict(vocab_size=50, units=32, hidden_size=64, num_layers=2,
             num_heads=2, max_length=64, dropout=0.0)
PROMPT = [3, 7, 11]
LONG = [int(t) for t in np.random.RandomState(9).randint(1, 50, 40)]


@pytest.fixture(scope="module")
def nets():
    """``tests/test_kvcache.py``'s ``_gpt()`` and its port twin."""
    mx.random.seed(3)
    jnet = JaxGPT(**SHAPE)
    jnet.initialize(init=mx.init.Normal(0.6))
    jnet(mx.nd.array(np.zeros((1, 2), np.int32)))
    params = {k[len(jnet.prefix):]: v.data().asnumpy()
              for k, v in jnet.collect_params().items()}
    tnet = load_jax_params(GPTModel(device="cpu", **SHAPE), params)
    return jnet, tnet


@pytest.fixture(scope="module")
def jax_engine(nets):
    return JaxEngine(nets[0], name="jax", max_slots=2, max_len=64)


def _engine(tnet, **kw):
    kw.setdefault("max_slots", 4)
    return GenerationEngine(tnet, max_len=64, **kw)


# ------------------------------------------------------------ sampling
@pytest.mark.parametrize("seed,pos", [(0, 0), (123, 7), (2 ** 40 + 5, 1023),
                                      (2 ** 62, 3)])
@pytest.mark.parametrize("V", [1, 50, 50257])
def test_gumbel_hash_is_bit_exact(monkeypatch, seed, pos, V):
    """The integer hash equals the JAX function's bit for bit (its top 24
    bits are all that reach the float: read them from the JAX function
    with its log transform replaced by the identity), and the Gumbel
    floats agree within rtol 1e-6.  The two libraries' f32 ``log`` may
    differ by an ulp; where the inner ``-log(u)`` is near 1 the outer log
    turns one ulp there (<= 1.2e-7) into an absolute error of that size
    around 0, hence atol 3e-7 beside the rtol."""
    key_np = jsamp.step_keys(jsamp.root_key(seed), pos)
    tkey = tsamp.step_keys(torch.from_numpy(tsamp.root_key(seed)),
                           torch.tensor(pos))
    assert np.asarray(key_np).astype(np.int64).tolist() == tkey.tolist()
    want = np.asarray(jsamp._gumbel_row(key_np, V))
    np.testing.assert_allclose(tsamp._gumbel_row(tkey, V).numpy(), want,
                               rtol=1e-6, atol=3e-7)
    import jax.numpy as jnp
    monkeypatch.setattr(jnp, "log", lambda x: x)
    u = np.asarray(jsamp._gumbel_row(key_np, V))       # = -(-u) = u
    got = torch.clamp(tsamp._hash_row(tkey, V) >> 8, min=1).numpy()
    np.testing.assert_array_equal(got, (u * 2.0 ** 24).astype(np.int64))


@pytest.mark.parametrize("temp,top_k,top_p", [
    (0.0, 0, 1.0), (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.6),
    (0.9, 10, 0.8)])
def test_sample_row_matches_jax(temp, top_k, top_p):
    rng = np.random.RandomState(int(temp * 10) + top_k)
    for trial in range(8):
        lg = (rng.randn(50) * 3).astype(np.float32)
        bias = np.zeros(50, np.float32)
        bias[rng.randint(50)] = -1e9
        key = jsamp.step_keys(jsamp.root_key(trial * 977), trial)
        want = int(jsamp._sample_row(lg, np.float32(temp), np.int32(top_k),
                                     np.float32(top_p), bias, key))
        got = int(tsamp._sample_row(
            torch.from_numpy(lg), temp, top_k, top_p,
            torch.from_numpy(bias),
            torch.from_numpy(np.asarray(key).astype(np.int64))))
        assert got == want


def test_sampling_params_validate():
    sp = SamplingParams(temperature=1, top_k=3, stop=[[1, 2], 3]).validate()
    assert sp.stop == ((1, 2), (3,)) and isinstance(sp.temperature, float)
    for bad in (dict(temperature=-1), dict(top_p=0.0), dict(top_k=-1),
                dict(n=0), dict(seed=-1)):
        with pytest.raises(ValueError):
            SamplingParams(**bad).validate()


# ---------------------------------------------------------- block pool
def test_block_pool_parity_with_jax():
    """One scripted allocate / release / hit / evict sequence through both
    pools: tables, shared spans, refcounts and stats agree at every
    step."""
    rng = np.random.RandomState(0)
    sysp = [int(t) for t in rng.randint(0, 50, 37)]
    prompts = [sysp + [1, 2], sysp + [3], list(range(20)),
               [int(t) for t in rng.randint(0, 50, 50)], sysp[:16] + [9]]
    # 11 blocks: small enough that the fifth allocation evicts a cached
    # block, large enough that every allocation is admitted
    jp = jkv.BlockPool(11, 16, model="t")
    tp = BlockPool(11, 16, model="t")
    held = []
    script = [("alloc", 0, 64), ("alloc", 1, 48), ("alloc", 2, 30),
              ("release", 0), ("alloc", 4, 40), ("release", 1),
              ("alloc", 3, 64), ("release", 2), ("alloc", 0, 64),
              ("release", 3), ("release", 4), ("release", 5)]
    for op in script:
        if op[0] == "alloc":
            toks = prompts[op[1]]
            if not jp.can_admit(toks, len(toks), op[2]):
                assert not tp.can_admit(toks, len(toks), op[2])
                continue
            a = jp.allocate(toks, len(toks), op[2])
            b = tp.allocate(toks, len(toks), op[2])
            assert a == b
            held.append(a[0])
        else:
            jp.release(held[op[1]])
            tp.release(held[op[1]])
        assert [jp.refcount(i) for i in range(11)] \
            == [tp.refcount(i) for i in range(11)]
        assert jp.stats() == tp.stats()
    assert tp.hits > 0 and tp.evictions > 0
    # copy-on-write of a block two readers share: the same fresh block
    toks = prompts[0]
    for _ in range(2):
        assert jp.allocate(toks, len(toks), 64) \
            == tp.allocate(toks, len(toks), 64)
    shared = jp.allocate(toks, len(toks), 64)[0][0]
    assert tp.allocate(toks, len(toks), 64)[0][0] == shared
    assert jp.copy_on_write(shared) == tp.copy_on_write(shared) != shared
    assert [jp.refcount(i) for i in range(11)] \
        == [tp.refcount(i) for i in range(11)]


# -------------------------------------------------------------- engine
def test_engine_greedy_parity_paged_dense_model_and_jax(nets, jax_engine):
    jnet, tnet = nets
    paged, dense = _engine(tnet), _engine(tnet, paged=False)
    for prompt, n in ((PROMPT, 10), (LONG[:21], 12)):
        want = jax_engine.generate(prompt, max_new_tokens=n)
        model = tnet.generate(torch.tensor([prompt]), max_new_tokens=n)
        assert paged.generate(prompt, n) == want
        assert dense.generate(prompt, n) == want
        assert model[0, len(prompt):].tolist() == want


def test_prefix_hit_equals_miss(nets):
    _, tnet = nets
    paged, dense = _engine(tnet), _engine(tnet, paged=False)
    miss = paged.generate(LONG, 10)
    hits = paged.pool.hits
    hit = paged.generate(LONG, 10)
    assert paged.pool.hits == hits + 2        # two full 16-token blocks
    assert hit == miss == dense.generate(LONG, 10)
    assert paged.pool.blocks_in_use == 0


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_decode_burst_equals_per_step(nets, k, paged):
    """Three slots through bursts of k — a greedy slot with a budget that
    is no multiple of k, a sampled slot, a slot that stops on eos, and a
    free slot riding along — emit what per-step decode emits solo."""
    _, tnet = nets
    ref = _engine(tnet, paged=paged)
    sp = SamplingParams(temperature=0.8, top_k=20, seed=11)
    greedy = ref.generate(PROMPT, 20)
    # the first token from index 3 on that did not come before: the slot
    # stops there, mid-way through a burst
    eos = next(t for i, t in enumerate(greedy) if i >= 3
               and t not in greedy[:i])
    reqs = [(LONG[:21], 10, None, None), (LONG[5:30], 14, None, sp),
            (PROMPT, 20, eos, None)]
    want = [ref.generate(p, b, eos_id=e, sampling=s) for p, b, e, s in reqs]
    assert len(want[2]) < 20 and want[2][-1] == eos
    eng = _engine(tnet, paged=paged, scan_steps=k)
    S = eng.max_slots
    outs = []
    for slot, (p, b, e, s) in enumerate(reqs):
        eng.set_slot_sampling(slot, s)
        outs.append([eng.prefill(p, slot, reserve_tokens=len(p) + b)])
    active = np.zeros(S, bool)
    active[:3] = True
    while active.any():
        last, pos = np.zeros(S, np.int32), np.zeros(S, np.int32)
        bud, eos_ids = np.ones(S, np.int32), np.full(S, -1, np.int32)
        for s in np.flatnonzero(active):
            p, b, e, _ = reqs[s]
            last[s], pos[s] = outs[s][-1], len(p) + len(outs[s]) - 1
            bud[s] = b - len(outs[s])
            eos_ids[s] = -1 if e is None else e
        toks, emitted = eng.decode_burst(last, pos, bud, eos_ids, active)
        assert toks.shape == (k, S)
        for s in np.flatnonzero(active):
            outs[s] += toks[:emitted[s], s].tolist()
            p, b, e, _ = reqs[s]
            if len(outs[s]) >= b or (e is not None and outs[s][-1] == e):
                active[s] = False
    assert outs == want


def test_seeded_sampling_matches_jax_engine(nets, jax_engine):
    _, tnet = nets
    eng = _engine(tnet)
    for seed in (5, 2 ** 33 + 1):
        kw = dict(temperature=0.9, top_k=12, top_p=0.9, seed=seed)
        want = jax_engine.generate(PROMPT, max_new_tokens=12,
                                   sampling=jsamp.SamplingParams(**kw))
        got = eng.generate(PROMPT, 12, sampling=SamplingParams(**kw))
        assert got == want
    assert eng.generate(PROMPT, 12, sampling=SamplingParams(seed=3)) \
        == eng.generate(PROMPT, 12)     # temperature 0 is greedy


def test_logprobs_only_when_a_slot_asks(nets, jax_engine):
    """Every decode computes the top-N logprobs when the engine's
    ``logprobs_topn`` is above 0, whether or not a slot asked (the JAX
    programs bake them by ``logprobs_topn``): the JAX engine's top-5
    (values within 1e-5, same ids).  An engine with ``logprobs_topn`` 0
    computes none."""
    _, tnet = nets
    eng = _engine(tnet, max_slots=2)
    pos = np.array([len(PROMPT), 0], np.int32)
    jax_engine.set_slot_sampling(0, None)     # an earlier test sampled
    first = jax_engine.prefill(PROMPT, 0)
    jax_engine.decode(np.array([first, 0], np.int32), pos)
    want = jax_engine.last_logprobs()
    jax_engine.release_slot(0)
    for asked in (0, 3):
        eng.reset()
        eng.set_slot_sampling(0, SamplingParams(logprobs=asked))
        assert eng.prefill(PROMPT, 0) == first
        eng.decode(np.array([first, 0], np.int32), pos)
        got = eng.last_logprobs()
        assert got[0].shape == (2, eng.logprobs_topn)
        np.testing.assert_allclose(got[0][0], np.asarray(want[0])[0],
                                   rtol=1e-5, atol=1e-5)
        assert got[1][0].tolist() == np.asarray(want[1])[0].tolist()
    off = _engine(tnet, max_slots=2, logprobs_topn=0)
    off.set_slot_sampling(0, SamplingParams(logprobs=3))
    assert off.prefill(PROMPT, 0) == first
    off.decode(np.array([first, 0], np.int32), pos)
    assert off.last_logprobs() is None
    assert off.last_prefill_logprobs() is None


def test_engine_checks_its_inputs(nets):
    _, tnet = nets
    eng = _engine(tnet, scan_steps=4)
    from incubator_mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError):
        eng.prefill([], 0)
    with pytest.raises(MXNetError):
        eng.prefill([60], 0)                  # outside the vocab
    with pytest.raises(MXNetError):
        eng.decode(np.zeros(4), np.full(4, 64))
    with pytest.raises(MXNetError):          # would write past max_len
        eng.decode_burst(np.zeros(4), np.full(4, 62), np.full(4, 4),
                         np.full(4, -1), np.ones(4, bool))


# ------------------------------------------------------------- batcher
def test_batcher_staggered_requests_match_solo(nets):
    """A long request, then two that join while it decodes: each equals
    its solo run, and the late one's first token arrives before the long
    one's last."""
    _, tnet = nets
    eng = _engine(tnet)
    bat = ContinuousBatcher(eng)
    try:
        long_req = bat.submit_async(LONG[:20], max_new_tokens=40)
        # keep the stream open: closing it would cancel the request
        stream = long_req.stream(timeout=30)
        first = next(stream)
        mid = bat.submit_async(LONG[20:], max_new_tokens=15)
        late = bat.submit_async(PROMPT, max_new_tokens=5)
        outs = [r.result(timeout=60) for r in (long_req, mid, late)]
        assert outs[0][0] == first
        assert late.t_first < long_req.t_emit
        st = bat.stats()
        assert st["tokens_emitted"] == 60 and st["slots_in_use"] == 0
        assert st["decode_burst_dispatches"] > 0
    finally:
        bat.close()
    assert not bat._thread.is_alive()
    solo = []
    for prompt, n in ((LONG[:20], 40), (LONG[20:], 15), (PROMPT, 5)):
        eng.reset()
        solo.append(eng.generate(prompt, n))
    assert outs == solo


def test_batcher_cancel_and_close(nets):
    _, tnet = nets
    bat = ContinuousBatcher(_engine(tnet, max_slots=1), queue_size=1)
    try:
        a = bat.submit_async(PROMPT, max_new_tokens=50)
        stream = a.stream(timeout=30)
        next(stream)
        stream.close()                        # consumer went away
        assert a.event.wait(30) and a.error is not None
        b = bat.submit_async(PROMPT, max_new_tokens=3)
        assert len(b.result(timeout=30)) == 3
    finally:
        bat.close()
    with pytest.raises(Exception):
        bat.submit_async(PROMPT)
