"""The serving plane's request features in the port: stop sequences,
``n > 1``, JSON mode and logprob streaming.

The host logic (``stop_trim``, ``derive_candidate_seed``,
``JsonMaskMachine``) equals the JAX package's functions on the same
inputs, called in-process (pure host functions).  Through the port's
``ContinuousBatcher`` at ``gpt_tiny`` width (vocab 512, 8 slots, fp32 on
the CPU): the ``n = 2`` children are the solo runs with derived seeds,
JSON mode's output is a complete document within its budget that parses
(up to the reference's permissive number rule) and never bursts or
speculates, a stop sequence is trimmed on the burst path, and streamed
logprobs equal the JAX batcher's within 1e-5.  The JAX batcher runs in a
child interpreter, once per module, with every ``MXNET_*`` variable
unset; its weights (``Normal(0.02)``, GPT-2's initializer scale) cross
through an ``.npz``."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
from incubator_mxnet_tpu_torch.serving import (ContinuousBatcher,
                                               GenerationEngine,
                                               SamplingParams)
from incubator_mxnet_tpu_torch.serving import sampling as tsamp

ROOT = Path(__file__).resolve().parents[1]
V = 512
# (prompt, budget, sampling kwargs) of the streamed-logprobs requests
LP_REQUESTS = [([3, 7, 11, 2], 12, dict(logprobs=3)),
               ([5, 300, 9, 41, 8, 8], 14,
                dict(temperature=0.9, top_k=40, seed=7, logprobs=5))]
TOL = dict(rtol=1e-5, atol=1e-5)

_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json, sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.models.gpt import gpt_tiny
from incubator_mxnet_tpu.serving import ContinuousBatcher, GenerationEngine
from incubator_mxnet_tpu.serving.sampling import SamplingParams
path, requests = sys.argv[1], eval(sys.argv[2])
mx.random.seed(0)
net = gpt_tiny(dropout=0.0)
net.initialize(init=mx.init.Normal(0.02))
net(mx.nd.array(np.zeros((1, 2), np.int32)))
np.savez(path, **{k[len(net.prefix):]: v.data().asnumpy()
                  for k, v in net.collect_params().items()})
b = ContinuousBatcher(GenerationEngine(net, name="ref", max_slots=8))
try:
    reqs = [b.submit_async(p, n, sampling=SamplingParams(**kw))
            for p, n, kw in requests]
    out = [{"tokens": r.result(120), "logprobs": r.logprobs_out}
           for r in reqs]
finally:
    b.close()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX batcher's streams and the weights behind them."""
    path = tmp_path_factory.mktemp("features_ref") / "params.npz"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(path), repr(LP_REQUESTS)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        params = dict(z)
    net = load_jax_params(gpt_tiny(dropout=0.0, device="cpu"), params)
    return net, json.loads(proc.stdout.strip().splitlines()[-1])


def _engine(net, draft=False, **kw):
    eng = GenerationEngine(net, name="t", max_slots=8, **kw)
    if draft:
        eng.attach_draft(GenerationEngine(net, name="d", max_slots=8, **kw),
                         spec_k=4)
    return eng


def _serve(eng, requests, **kw):
    """Serve ``(prompt, budget, SamplingParams)`` requests through one
    batcher; returns (handles, stats)."""
    bat = ContinuousBatcher(eng, **kw)
    try:
        reqs = [bat.submit_async(p, b, sampling=sp) for p, b, sp in requests]
        for r in reqs:
            r.result(120)
        return reqs, bat.stats()
    finally:
        bat.close()


# ------------------------------------------------ the JAX host functions
def _jax_sampling():
    from incubator_mxnet_tpu.serving import sampling as jsamp
    return jsamp


@pytest.mark.parametrize("prev,new,stops", [
    ([], [1, 2, 3], ()), ([1], [2, 3, 4], ((3, 4),)),
    ([5, 6], [7, 8], ((6, 7),)),
    ([1, 2], [3, 9, 9], ((1, 2, 3),)), ([0], [4, 4, 4], ((4,), (4, 4))),
    ([9, 8, 7, 6], [5, 4], ((2, 3),)), ([], [2, 2, 3], ((2, 3), (2, 2)))])
def test_stop_trim_equals_jax(prev, new, stops):
    assert tsamp.stop_trim(prev, new, stops) \
        == _jax_sampling().stop_trim(prev, new, stops)


def test_derive_candidate_seed_equals_jax():
    jsamp = _jax_sampling()
    for seed in (0, 1, 99, 2 ** 40 + 3, 2 ** 63 - 1):
        for i in range(5):
            assert tsamp.derive_candidate_seed(seed, i) \
                == jsamp.derive_candidate_seed(seed, i)


@pytest.mark.parametrize("seed", range(4))
def test_json_mask_machine_equals_jax(seed):
    """Both machines over a byte-level vocab of 256, driven by the same
    random legal tokens: equal masks (with and without a budget), equal
    ``advance`` results and ``done`` flags, and an illegal token refused
    by both."""
    jsamp = _jax_sampling()
    strs = [chr(i) for i in range(256)]
    tm, jm = tsamp.JsonMaskMachine(strs), jsamp.JsonMaskMachine(strs)
    rng = np.random.RandomState(seed)
    budget = 30
    while not tm.done:
        np.testing.assert_array_equal(tm.mask(), jm.mask())
        row = tm.mask(budget=budget)
        np.testing.assert_array_equal(row, jm.mask(budget=budget))
        bad = int(rng.choice(np.flatnonzero(tm.mask() != 0)))
        assert tm.advance(bad) == jm.advance(bad) is False
        tok = int(rng.choice(np.flatnonzero(row == 0)))
        assert tm.advance(tok) == jm.advance(tok) is True
        assert tm.done == jm.done
        budget -= 1
    assert budget >= 0 and jm.done


# ------------------------------------------------- through the batcher
def test_n_fans_out_into_the_solo_runs_with_derived_seeds(ref):
    net, _ = ref
    eng = _engine(net)
    prompt, sp = [4, 9, 16], SamplingParams(temperature=0.9, seed=99, n=2)
    bat = ContinuousBatcher(eng)
    try:
        r = bat.submit_async(prompt, 10, sampling=sp, request_id="req")
        outs = r.results(120)
        assert r.request_ids == ["req.0", "req.1"] and r.seed == 99
        assert r.result(1) == outs[0]
        with pytest.raises(ValueError):          # more candidates than slots
            bat.submit_async(prompt, 4, sampling=SamplingParams(n=9))
    finally:
        bat.close()
    solo = [eng.generate(prompt, 10, sampling=SamplingParams(
        temperature=0.9, seed=tsamp.derive_candidate_seed(99, i)))
        for i in range(2)]
    assert outs == solo and outs[0] != outs[1]


def test_json_mode_parses_and_never_bursts_or_speculates(ref):
    net, _ = ref
    eng = _engine(net, draft=True)
    budget = 40
    reqs, st = _serve(eng, [
        (p, budget, SamplingParams(temperature=0.9, seed=seed,
                                   json_mode=True))
        for p, seed in (([1], 0), ([1], 1), ([2, 3], 2), ([2, 3], 3))])
    for r in reqs:
        out = r.result(1)
        assert len(out) <= budget
        # a complete document by the grammar
        m = tsamp.JsonMaskMachine([chr(i) for i in range(V)])
        assert all(m.advance(t) for t in out) and m.done
        text = "".join(chr(t) for t in out)
        try:
            doc = json.loads(text)
        except ValueError:
            # the reference machine's number rule is permissive (it
            # accepts "-E." or "54+8"; ROADMAP Queue C): with every
            # number run replaced by 0 the document parses
            doc = json.loads(re.sub(r"[-0-9][-+.eE0-9]*", "0", text))
        assert isinstance(doc, (dict, list))
    assert st["spec_dispatches"] == 0 and st["decode_burst_dispatches"] == 0
    # the draft's bias rows follow the target's
    np.testing.assert_array_equal(eng._samp_bias, eng.draft._samp_bias)


def test_stop_sequence_is_trimmed_on_the_burst_path(ref):
    net, _ = ref
    prompt = [8, 120, 33]
    sp = SamplingParams(temperature=0.8, seed=11)
    base = _engine(net, scan_steps=0).generate(prompt, 16, sampling=sp)
    # the first 2-token window from index 3 on that did not occur before
    i = next(i for i in range(3, 14)
             if all(tuple(base[j:j + 2]) != tuple(base[i:i + 2])
                    for j in range(i)))
    stop = tuple(base[i:i + 2])
    reqs, st = _serve(_engine(net), [
        (prompt, 16, SamplingParams(temperature=0.8, seed=11,
                                    stop=(stop,)))])
    assert reqs[0].result(1) == base[:i + 2]
    assert st["decode_burst_dispatches"] >= 1
    assert st["stop_hits"] == 1 and st["stop_trimmed_tokens"] >= 1
    assert st["slots_in_use"] == 0


@pytest.mark.parametrize("path", ["burst", "step", "spec"])
def test_streamed_logprobs_equal_jax(ref, path):
    """The JAX batcher's tokens and per-token logprob records (ids equal,
    values within 1e-5), whichever program produced them: prefill then
    bursts, per-step decode, or speculative verify."""
    net, want = ref
    eng = _engine(net, draft=path == "spec",
                  scan_steps=0 if path == "step" else None)
    reqs, _ = _serve(eng, [(p, n, SamplingParams(**kw))
                           for p, n, kw in LP_REQUESTS])
    for r, w, (_, _, kw) in zip(reqs, want, LP_REQUESTS):
        assert r.result(1) == w["tokens"]
        assert len(r.logprobs_out) == len(w["tokens"]) == len(w["logprobs"])
        for got, exp in zip(r.logprobs_out, w["logprobs"]):
            assert len(got["token_ids"]) == kw["logprobs"]
            assert got["token_ids"] == exp["token_ids"]
            np.testing.assert_allclose(got["logprobs"], exp["logprobs"],
                                       **TOL)


def test_logprobs_clamped_to_the_engine(ref):
    net, _ = ref
    reqs, st = _serve(_engine(net, logprobs_topn=2),
                      [([3, 4], 5, SamplingParams(logprobs=9))])
    assert st["logprobs_topn"] == 2
    assert [len(e["token_ids"]) for e in reqs[0].logprobs_out] == [2] * 5
    reqs, _ = _serve(_engine(net, logprobs_topn=0),
                     [([3, 4], 5, SamplingParams(logprobs=3))])
    assert reqs[0].logprobs_out == []
