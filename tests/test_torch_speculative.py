"""Speculative decoding in the port (``incubator_mxnet_tpu_torch``) against
the JAX package, fp32 on the CPU at the reference's ``_spec_pair`` size
(2 layers, 32 wide, vocab 50, max_len 64): the two verify attentions'
plain versions against the JAX lax oracles and the Pallas kernels in
interpret mode; speculative ``generate`` == plain ``generate`` == the JAX
spec engine, token for token, paged and dense, for a draft equal to the
target (accept-all), a contrarian draft (reject-all) and an independent
one, greedy and seeded-sampled, and at ``prompt + budget == max_len``;
the batcher's speculative step with mid-flight joins and a prefix hit;
``attach_draft``'s checks; ``BlockPool.rewind``; and, on a card, K4/K5
against their plain versions (``cuda`` marker)."""
import importlib
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models.gpt import GPTModel
from incubator_mxnet_tpu_torch.serving import (BlockPool,
                                               ContinuousBatcher,
                                               GenerationEngine,
                                               SamplingParams)

# the module, not the same-named function its package exports
tfa = importlib.import_module(
    "incubator_mxnet_tpu_torch.kernels.flash_attention")

SHAPE = dict(vocab_size=50, units=32, hidden_size=64, num_layers=2,
             num_heads=2, max_length=64, dropout=0.0)
PROMPTS = [[3, 7, 11, 2], [5, 5, 9], [1, 2, 3, 4, 5, 6]]
# 50 prompt tokens + a budget of 14 fill max_len 64 exactly
EDGE = [int(t) for t in np.random.RandomState(4).randint(0, 50, 50)]
TOL = dict(atol=1e-5, rtol=1e-5)
# kernel vs plain on the card: both fp32, different summation order
CUDA_TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_gpt(seed):
    """``tests/test_speculative.py``'s ``_gpt(seed=...)``.  The JAX
    package is imported where a test needs it, so that the card tests
    (``-m cuda``) collect on a machine without JAX."""
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu.models.gpt import GPTModel as JaxGPT
    mx.random.seed(seed)
    net = JaxGPT(**SHAPE)
    net.initialize(init=mx.init.Normal(0.6))
    net(mx.nd.array(np.zeros((1, 2), np.int32)))
    return net


def _port(jnet):
    params = {k[len(jnet.prefix):]: v.data().asnumpy()
              for k, v in jnet.collect_params().items()}
    return load_jax_params(GPTModel(device="cpu", **SHAPE), params)


@pytest.fixture(scope="module")
def nets():
    """The target (seed 3) in both packages and an independent draft
    (seed 7) in the port."""
    jt = _jax_gpt(3)
    return {"jax": jt, "target": _port(jt), "independent": _port(_jax_gpt(7))}


@pytest.fixture(scope="module")
def jax_spec(nets):
    """The reference's ``_spec_pair(paged=True)``: a JAX target with
    itself as the draft, spec_k 4."""
    from incubator_mxnet_tpu.serving import GenerationEngine as JaxEngine
    tgt = JaxEngine(nets["jax"], name="tgt", max_slots=2, max_len=64,
                    paged=True)
    drf = JaxEngine(nets["jax"], name="drf", max_slots=2, max_len=64,
                    paged=True)
    tgt.attach_draft(drf, spec_k=4)
    return tgt


def _pair(nets, paged, draft="target", max_slots=2, max_len=64, **kw):
    """A port target with an attached draft: the target's own net
    (``"target"``), the independent net, or the target's net proposing
    ``(its token + 1) % 50`` at every step (``"contrarian"``, through the
    host loop: the draft's bursts are off).  ``accepted`` collects every
    slot's accept count of every ``spec_step``."""
    tgt = GenerationEngine(nets["target"], name="tgt", max_slots=max_slots,
                           max_len=max_len, paged=paged, **kw)
    drf = GenerationEngine(nets["independent" if draft == "independent"
                                else "target"],
                           name="drf", max_slots=max_slots, max_len=max_len,
                           paged=paged,
                           scan_steps=0 if draft == "contrarian" else None)
    tgt.attach_draft(drf, spec_k=4)
    if draft == "contrarian":
        real = drf.decode
        drf.decode = lambda last, pos: (np.asarray(real(last, pos)) + 1) % 50
    tgt.accepted = []
    real_step = tgt.spec_step

    def step(last, pos):
        out, acc = real_step(last, pos)
        tgt.accepted += [int(a) for a, p in zip(acc, pos) if p > 0]
        return out, acc
    tgt.spec_step = step
    return tgt


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax():
    """The JAX package's kernel module and ``jax.numpy``."""
    import jax.numpy as jnp
    return (importlib.import_module(
        "incubator_mxnet_tpu.kernels.flash_attention"), jnp)


# ------------------------------------------------- (a) plain verify versions
def _verify_inputs(seed, S=3, H=2, Q=5, D=32, bs=16, MB=8, positions=()):
    """q (S, H, Q, D), a shuffled pool of 1 + S * MB blocks whose tables
    hold distinct blocks up to each slot's last row and the null block 0
    past it, and the same K/V as a dense (S, H, MB * bs, D) cache."""
    rng = np.random.RandomState(seed)
    NB = 1 + S * MB
    kp = rng.randn(NB, H, bs, D).astype(np.float32)
    vp = rng.randn(NB, H, bs, D).astype(np.float32)
    q = rng.randn(S, H, Q, D).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    perm = rng.permutation(np.arange(1, NB))
    tables = np.zeros((S, MB), np.int32)
    for s in range(S):
        live = min(MB, (int(pos[s]) + Q - 1) // bs + 1)
        tables[s, :live] = perm[s * MB:s * MB + live]
    kd = kp[tables].transpose(0, 2, 1, 3, 4).reshape(S, H, MB * bs, D)
    vd = vp[tables].transpose(0, 2, 1, 3, 4).reshape(S, H, MB * bs, D)
    return q, kp, vp, tables, pos, kd, vd


# rows crossing a block boundary (14 + 0..4 crosses 15/16), rows running
# past T = 128 (125 + 0..4), position 0, and one row (Q = 1)
@pytest.mark.parametrize("Q,positions", [(5, (14, 125, 0)), (5, (31, 60, 96)),
                                         (1, (0, 127, 64))])
def test_plain_verify_matches_xla_oracle_and_pallas(monkeypatch, Q,
                                                    positions):
    jfa, jnp = _jax()
    q, kp, vp, tables, pos, kd, vd = _verify_inputs(0, Q=Q,
                                                    positions=positions)
    scale = 0.25
    got = tfa._plain_verify_decode_attention(_t(q), _t(kd), _t(vd), _t(pos),
                                             scale).numpy()
    got_p = tfa._plain_paged_verify_decode_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(pos), scale).numpy()
    dense = tuple(jnp.asarray(a) for a in (q, kd, vd, pos))
    paged = tuple(jnp.asarray(a) for a in (q, kp, vp, tables, pos))
    np.testing.assert_allclose(
        got, np.asarray(jfa._xla_verify_decode_attention(*dense, scale)),
        **TOL)
    np.testing.assert_allclose(
        got_p, np.asarray(jfa._xla_paged_verify_decode_attention(
            *paged, scale)), **TOL)
    # the public JAX entries, forced onto the Pallas kernels in interpret
    # mode (T = 128 and bs = 16 open their gates)
    monkeypatch.setenv("MXNET_FA_DECODE_FORCE_PALLAS", "1")
    np.testing.assert_allclose(
        got, np.asarray(jfa.verify_decode_attention(*dense, scale=scale)),
        **TOL)
    np.testing.assert_allclose(
        got_p, np.asarray(jfa.paged_verify_decode_attention(
            *paged, scale=scale)), **TOL)
    # the port's public entries on CPU tensors are the plain versions
    np.testing.assert_array_equal(tfa.verify_decode_attention(
        _t(q), _t(kd), _t(vd), _t(pos), scale=scale).numpy(), got)
    np.testing.assert_array_equal(tfa.paged_verify_decode_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(pos), scale=scale).numpy(),
        got_p)
    # paged == dense on the same live K/V, bit for bit
    np.testing.assert_array_equal(got_p, got)


# --------------------------------------------- (b) Q = 1 verify is decode
@pytest.mark.parametrize("positions", [(0, 15, 127), (16, 77, 1)])
def test_verify_at_one_row_equals_decode(positions):
    q, kp, vp, tables, pos, kd, vd = _verify_inputs(1, Q=1,
                                                    positions=positions)
    qd = _t(q[:, :, 0])
    ver = tfa.verify_decode_attention(_t(q), _t(kd), _t(vd), _t(pos))
    dec = tfa.decode_attention(qd, _t(kd), _t(vd), _t(pos))
    np.testing.assert_array_equal(ver[:, :, 0].numpy(), dec.numpy())
    pver = tfa.paged_verify_decode_attention(_t(q), _t(kp), _t(vp),
                                             _t(tables), _t(pos))
    pdec = tfa.paged_decode_attention(qd, _t(kp), _t(vp), _t(tables),
                                      _t(pos))
    np.testing.assert_array_equal(pver[:, :, 0].numpy(), pdec.numpy())


def test_verify_wrappers_refuse_cpu_tensors_and_count_nothing():
    q, kp, vp, tables, pos, kd, vd = _verify_inputs(2, positions=(1, 2, 3))
    tfa.reset_launch_counts()
    with pytest.raises(MXNetError, match="CUDA"):
        tfa._verify_cuda(_t(q), _t(kd), _t(vd), _t(pos), 0.25)
    with pytest.raises(MXNetError, match="CUDA"):
        tfa._paged_verify_cuda(_t(q), _t(kp), _t(vp), _t(tables), _t(pos),
                               0.25)
    tfa.verify_decode_attention(_t(q), _t(kd), _t(vd), _t(pos))
    assert tfa.launch_counts["verify"] == tfa.launch_counts[
        "paged_verify"] == 0                 # plain runs never count


# ------------------------- (c) spec == plain == the JAX spec engine, greedy
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("draft", ["target", "contrarian", "independent"])
def test_spec_generate_equals_plain_and_jax(nets, jax_spec, paged, draft):
    eng = _pair(nets, paged, draft)
    for p in PROMPTS:
        want = jax_spec.generate(p, max_new_tokens=12, speculative=True)
        assert eng.generate(p, 12) == want
        assert eng.generate(p, 12, speculative=False) == want
    k = eng.spec_k
    if draft == "target":
        assert k in eng.accepted             # a full accept ran
    elif draft == "contrarian":
        assert set(eng.accepted) == {0}      # every draft token rejected
    else:
        assert min(eng.accepted) < k         # a rollback ran
    if paged:
        assert eng.pool.blocks_in_use == eng.draft.pool.blocks_in_use == 0


@pytest.mark.parametrize("paged", [True, False])
def test_verify_and_its_logprobs_match_jax(nets, jax_spec, paged):
    """One verify after a prefill: the JAX engine's tokens, and its top-5
    logprobs (values within 1e-5, same ids) whether or not the slot asked
    (the verify program computes them whenever ``logprobs_topn`` > 0, as
    the JAX program does); none from a target with ``logprobs_topn`` 0."""
    prompt = PROMPTS[2]
    jax_spec.set_slot_sampling(0, None)      # an earlier test sampled
    first = jax_spec.prefill(prompt, 0)
    toks = np.zeros((2, 5), np.int32)
    toks[0] = [first, 4, 9, 9, 30]
    pos = np.array([len(prompt), 0], np.int32)
    want = jax_spec.verify(toks, pos)
    want_lp = jax_spec.last_verify_logprobs()
    jax_spec.release_slot(0)
    eng = _pair(nets, paged)
    for asked in (0, 3):
        eng.reset()
        eng.set_slot_sampling(0, SamplingParams(logprobs=asked))
        assert eng.prefill(prompt, 0) == first
        got = eng.verify(toks, pos)
        assert got.shape == (2, 5) and got[0].tolist() == want[0].tolist()
        lp = eng.last_verify_logprobs()
        assert lp[0].shape == lp[1].shape == (2, 5, eng.logprobs_topn)
        np.testing.assert_allclose(lp[0][0], np.asarray(want_lp[0])[0],
                                   **TOL)
        assert lp[1][0].tolist() == np.asarray(want_lp[1])[0].tolist()
    off = _pair(nets, paged, logprobs_topn=0)
    assert off.prefill(prompt, 0) == first
    assert off.verify(toks, pos)[0].tolist() == want[0].tolist()
    assert off.last_verify_logprobs() is None


# --------------------------------------------------- (d) seeded sampling
@pytest.mark.parametrize("paged", [True, False])
def test_seeded_sampling_spec_equals_plain_and_jax(nets, jax_spec, paged):
    from incubator_mxnet_tpu.serving import sampling as jsamp
    kw = dict(temperature=0.8, top_p=0.9, seed=2 ** 33 + 7)
    want = jax_spec.generate(PROMPTS[2], max_new_tokens=16,
                             speculative=True,
                             sampling=jsamp.SamplingParams(**kw))
    eng = _pair(nets, paged, "independent")
    sp = SamplingParams(**kw)
    assert eng.generate(PROMPTS[2], 16, sampling=sp) == want
    assert eng.generate(PROMPTS[2], 16, speculative=False,
                        sampling=sp) == want
    assert want != eng.generate(PROMPTS[2], 16)   # really sampled


# ---------------------------------------- (e) prompt + budget == max_len
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("draft", ["target", "independent"])
def test_spec_serves_up_to_max_len(nets, jax_spec, paged, draft):
    """The verify's and the draft's writes past the last position are
    dropped, redirected to the null block or never made: the request is
    served to the last position, as the JAX spec engine serves it."""
    want = jax_spec.generate(EDGE, max_new_tokens=14, speculative=True)
    assert len(want) == 14
    eng = _pair(nets, paged, draft)
    assert eng.generate(EDGE, 14) == want
    assert eng.generate(EDGE, 14, speculative=False) == want


@pytest.mark.parametrize("paged", [True, False])
def test_spec_at_max_len_off_the_block_grid(nets, paged):
    """max_len 60 with blocks of 16: positions 60..63 lie inside the last
    table block but past max_len, so the paged verify sends them to the
    null block by the max_len test, not the table's end."""
    plain = GenerationEngine(nets["target"], max_slots=2, max_len=60,
                             paged=paged)
    eng = _pair(nets, paged, "independent", max_len=60)
    want = plain.generate(EDGE[:45], 15)
    assert len(want) == 15 and eng.generate(EDGE[:45], 15) == want


# ---------------------------------------------------------- (f) batcher
def test_spec_batcher_mid_flight_joins_and_prefix_hit(nets):
    """4 requests sharing a 32-token prefix through 2 slots, staggered so
    the later two join mid-flight: each equals its plain run, and the
    stats carry the speculative fields."""
    system = list(range(1, 33))
    prompts = [system + [40 + i] for i in range(4)]
    plain = GenerationEngine(nets["target"], max_slots=1, max_len=64,
                             paged=False)
    golden = [plain.generate(p, 10) for p in prompts]
    eng = _pair(nets, True, "independent")
    hits = eng.pool.hits
    bat = ContinuousBatcher(eng)
    try:
        reqs = []
        for p in prompts:
            reqs.append(bat.submit_async(p, max_new_tokens=10))
            time.sleep(0.02)
        outs = [r.result(timeout=60) for r in reqs]
        st = bat.stats()
    finally:
        bat.close()
    assert not bat._thread.is_alive()
    assert outs == golden
    assert eng.pool.hits > hits              # the shared prefix was hit
    for r in reqs:
        assert r.draft_tokens >= r.accepted_tokens >= 0
        assert r.draft_tokens > 0
    assert st["spec_k"] == 4 and st["spec_draft_model"] == "drf"
    assert st["spec_dispatches"] > 0
    assert 1.0 <= st["accepted_tokens_per_dispatch"] <= 5.0
    assert 0.0 <= st["spec_accept_rate"] <= 1.0
    assert st["tokens_emitted"] == 40 and st["slots_in_use"] == 0
    assert st["kv_blocks_in_use"] == eng.draft.pool.blocks_in_use == 0


def test_spec_batcher_accept_all_counts(nets):
    """A draft equal to the target through the batcher: the per-request
    accepted/draft counts add up to the stats' rate."""
    eng = _pair(nets, False, "target")
    bat = ContinuousBatcher(eng)
    try:
        req = bat.submit_async(PROMPTS[0], max_new_tokens=12)
        assert req.result(timeout=60) == GenerationEngine(
            nets["target"], max_slots=2, max_len=64,
            paged=False).generate(PROMPTS[0], 12)
        st = bat.stats()
    finally:
        bat.close()
    assert st["accepted_tokens_per_dispatch"] > 1.0
    assert st["spec_accept_rate"] == req.accepted_tokens / req.draft_tokens
    assert st["dispatches_per_token"] < 1.0


# ---------------------------------------------------- (g) attach_draft
def test_attach_draft_validations(nets):
    tgt = GenerationEngine(nets["target"], name="t", max_slots=2,
                           max_len=64, paged=False)
    with pytest.raises(MXNetError):
        tgt.attach_draft(tgt)                        # cannot draft itself
    with pytest.raises(MXNetError):                  # slot mismatch
        tgt.attach_draft(GenerationEngine(nets["independent"], max_slots=1,
                                          max_len=64, paged=False))
    with pytest.raises(MXNetError):                  # draft max_len short
        tgt.attach_draft(GenerationEngine(nets["independent"], max_slots=2,
                                          max_len=32, paged=False))
    other = dict(SHAPE, vocab_size=60)
    with pytest.raises(MXNetError):                  # another vocabulary
        tgt.attach_draft(GenerationEngine(GPTModel(device="cpu", **other),
                                          max_slots=2, max_len=64,
                                          paged=False))
    ok = GenerationEngine(nets["independent"], max_slots=2, max_len=64,
                          paged=False, logprobs_topn=5)
    with pytest.raises(MXNetError):
        tgt.attach_draft(ok, spec_k=0)               # k must be >= 1
    assert tgt.draft is None
    with pytest.raises(MXNetError):
        tgt.spec_step(np.zeros(2), np.zeros(2))      # no draft yet
    tgt.attach_draft(ok, spec_k=3)
    assert tgt.draft is ok and tgt.spec_k == 3
    assert ok.logprobs_topn == 0 and ok.scan_steps == 3


def test_spec_k_env_default(nets, monkeypatch):
    monkeypatch.setenv("MXNET_SPEC_K", "2")
    tgt = GenerationEngine(nets["target"], max_slots=2, max_len=64,
                           paged=False)
    tgt.attach_draft(GenerationEngine(nets["independent"], max_slots=2,
                                      max_len=64, paged=False))
    assert tgt.spec_k == 2


def test_draft_cascades_and_admission_headroom(nets):
    """Sampling, reset and release reach the draft; admission and the
    reservation leave spec_k positions of headroom in both pools; a
    failed target prefill frees the draft's slot too; warmup runs one
    verify and warms the draft."""
    eng = _pair(nets, True, "independent")
    drf = eng.draft
    assert eng.warmup() == 2 * len(eng.prefill_buckets) + 3
    assert eng.pool.blocks_in_use == drf.pool.blocks_in_use == 0
    eng.set_slot_sampling(1, SamplingParams(temperature=0.5, seed=9))
    assert drf._samp_temp[1] == 0.5
    assert (drf._samp_keys[1] == eng._samp_keys[1]).all()
    row = np.zeros(50, np.float32)
    row[3] = -1e9
    eng.update_slot_bias(1, row)
    assert drf._samp_bias[1, 3] == -1e9
    # 45 positions take 3 blocks of 16; with spec_k 4 of headroom, 4
    assert eng.reserve_estimate(45) == 4
    eng.prefill(PROMPTS[0], 0, reserve_tokens=45)
    assert len(eng._slot_blocks[0]) == len(drf._slot_blocks[0]) == 4
    eng.release_slot(0)
    assert eng.pool.blocks_in_use == drf.pool.blocks_in_use == 0
    eng._prefill_miss = None                         # the target fails
    with pytest.raises(TypeError):
        eng.prefill(PROMPTS[0], 0)
    assert eng.pool.blocks_in_use == drf.pool.blocks_in_use == 0
    eng.reset()
    assert not drf._tables.any() and not any(drf._slot_blocks)


# --------------------------------------------------- (h) BlockPool.rewind
def test_rewind_private_blocks_is_identity():
    pool = BlockPool(8, 4, model="t")
    table, shared = pool.allocate([1, 2, 3, 4, 5], 5, 12, share=False)
    assert shared == 0
    assert pool.rewind(table, keep_tokens=6) == table
    assert pool.rewinds == 0


def test_rewind_cows_published_tail_block():
    pool = BlockPool(8, 4, model="t")
    toks = [1, 2, 3, 4, 5, 6, 7, 8]
    table, shared = pool.allocate(toks, 8, 12, share=True)
    assert shared == 0
    out = pool.rewind(table, keep_tokens=4)
    assert out[0] == table[0] and pool.rewinds == 1
    _, shared2 = pool.allocate(toks, 8, 12, share=True)
    assert shared2 <= 4                 # the dirty block was unpublished


def test_rewind_shared_block_gets_private_copy():
    pool = BlockPool(10, 4, model="t")
    toks = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    t1, _ = pool.allocate(toks, 9, 12, share=True)
    t2, shared = pool.allocate(toks, 9, 12, share=True)
    assert shared == 8
    out = pool.rewind(t2, keep_tokens=4)
    assert out[0] == t2[0] and out[1] != t2[1]
    assert pool.cow_copies >= 1 and t1[1] == t2[1]


def test_rewind_refuses_cow_of_kept_positions():
    pool = BlockPool(10, 4, model="t")
    toks = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    pool.allocate(toks, 9, 12, share=True)
    t2, shared = pool.allocate(toks, 9, 12, share=True)
    assert shared == 8
    with pytest.raises(MXNetError):
        pool.rewind(t2, keep_tokens=6)


# ------------------------------------------------ (i) on the card (cuda)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_cuda_verify_kernels_match_plain(D):
    """K4 and K5 against their plain versions at Q in {1, 5, 9} (rows
    past T at position 1023), bitwise equal to each other on the same
    live K/V, and row 0 bitwise equal to K2."""
    _need_cuda()
    positions = (0, 15, 16, 500, 1023, 1, 77, 256)
    for Q in (1, 5, 9):
        q, kp, vp, tables, pos, kd, vd = _verify_inputs(
            11, S=8, H=12, Q=Q, D=D, MB=64, positions=positions)
        cpu = [_t(a) for a in (q, kp, vp, tables, pos, kd, vd)]
        cu = [a.cuda() for a in cpu]
        tfa.reset_launch_counts()
        got_p = tfa.paged_verify_decode_attention(*cu[:5])
        got = tfa.verify_decode_attention(cu[0], cu[5], cu[6], cu[4])
        dec = tfa.paged_decode_attention(cu[0][:, :, 0].contiguous(),
                                         *cu[1:5])
        torch.cuda.synchronize()
        assert {n: tfa.launch_counts[n] for n in ("paged_verify", "verify",
                                                  "paged_decode")} \
            == {"paged_verify": 2, "verify": 2, "paged_decode": 2}
        want = tfa.paged_verify_decode_attention(*cpu[:5])
        np.testing.assert_allclose(got_p.cpu().numpy(), want.numpy(),
                                   **CUDA_TOL)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      got_p.cpu().numpy())
        # K2 is the split kernel at one row: row 0 is the same arithmetic
        np.testing.assert_array_equal(got_p[:, :, 0].cpu().numpy(),
                                      dec.cpu().numpy())
