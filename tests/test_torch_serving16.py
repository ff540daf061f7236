"""Serving a cast GPT (bf16, fp16) through the port's ``GenerationEngine``
(``incubator_mxnet_tpu_torch/serving``) against the JAX package, on the
CPU at the reference's ``tests/test_generation.py`` size (vocab 50, 32
wide, 2 layers, 2 heads, max_len 64).

* The decode kernels with a 16-bit query: the plain versions of K2
  paged_decode, K3 decode, K4 paged_verify and K5 verify at bf16 and fp16
  q over fp32 caches, against the Pallas kernels in interpret mode (under
  ``jax.jit``): o in q's dtype, within 1 ulp of that dtype (both compute
  in fp32 and round once; the ulp taken at max(|x|, 2^-8 of the largest)).
* The engine: the JAX side runs in a child interpreter, once per module,
  with every ``MXNET_*`` variable unset.  It builds the net at fp32 from a
  seed, writes its parameters, casts the net and generates greedily in
  paged and dense mode, with a draft (the same cast net) and without
  one, three prompts in turn (the third a prefix-cache hit on the
  first's leading block), and records the top-2 logprob gap of every
  plain step (``logprobs_topn=2``).  The port loads the fp32 parameters
  (``convert.load_jax_params``) and casts its own net: round-to-nearest-
  even gives both the same 16-bit weights.  The tokens must be equal, or
  first differ at a step where the JAX gap is below ``NEAR_TIE`` x
  max(1, |top logit|) (the port's full-prefix forward gives the top
  logit): XLA's CPU backend rounds fused bf16 operations differently from
  a per-op torch forward.
* The port's own contracts at 16 bits: paged == dense, speculative ==
  plain, batched == solo (``ContinuousBatcher``), ``:generate`` through
  ``ModelServer`` (JSON and SSE) == the batcher; a draft of another
  dtype than the target's is accepted (JAX's ``attach_draft`` checks no
  dtype); the sampling plane and the health stats take 16-bit logits
  with an fp32 bias as JAX's do.
* On a card (``cuda`` marker, skipped without a GPU): the 16-bit
  instances of K2-K5 within 1 ulp of their plain versions, K2 == K3 and
  K4 == K5 bit for bit, K4's row j == K2 at ``positions + j`` bit for
  bit, and a cast engine's graph replays == its eager bodies.
Hygiene: ``torch_serving_hygiene``."""
import importlib
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models.gpt import GPTModel
from incubator_mxnet_tpu_torch.serving import (ContinuousBatcher,
                                               GenerationEngine,
                                               ModelServer)
from incubator_mxnet_tpu_torch.serving import sampling as tsamp
from torch_serving_hygiene import (clean_state, closer,  # noqa: F401
                                   module_hygiene)

# the module, not the same-named function its package exports
tfa = importlib.import_module(
    "incubator_mxnet_tpu_torch.kernels.flash_attention")

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(vocab_size=50, units=32, hidden_size=64, num_layers=2,
             num_heads=2, max_length=64, dropout=0.0)
DTYPES = {"bf16": ("bfloat16", torch.bfloat16),
          "fp16": ("float16", torch.float16)}
# the third prompt shares the first's leading block of 16 (a prefix hit)
PROMPTS = [list(range(3, 23)), [5, 5, 9], list(range(3, 19)) + [1, 2, 3, 4]]
BUDGET = 12
# a token may split from JAX's only where JAX's top-2 gap is below this
# share of max(1, |top logit|): a few ulps of the logit's dtype
NEAR_TIE = {"bf16": 2.0 ** -5, "fp16": 2.0 ** -8}
ULP_FLOOR = 2.0 ** -8

_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json, sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.models.gpt import GPTModel
from incubator_mxnet_tpu.serving import GenerationEngine
shape, prompts, budget, out_dir = eval(sys.argv[1])


def build(dtype):
    mx.random.seed(3)
    net = GPTModel(**shape)
    net.initialize(init=mx.init.Normal(0.6))
    net(mx.nd.array(np.zeros((1, 2), np.int32)))
    if dtype is None:
        np.savez(out_dir + "/params.npz", **{
            k[len(net.prefix):]: v.data().asnumpy()
            for k, v in net.collect_params().items()})
    else:
        net.cast(dtype)
    return net


def plain(eng, p):
    # generate()'s loop, reading each step's top-2 logprobs
    n = len(p)
    toks = [eng.prefill(p, 0, reserve_tokens=n + budget)]
    v, _ = eng.last_prefill_logprobs()
    gaps = [float(v[0] - v[1])]
    lt, pv = np.zeros(2, np.int32), np.zeros(2, np.int32)
    while len(toks) < budget:
        lt[0], pv[0] = toks[-1], n + len(toks) - 1
        toks.append(int(eng.decode(lt, pv)[0]))
        v, _ = eng.last_logprobs()
        gaps.append(float(v[0][0] - v[0][1]))
    eng.release_slot(0)
    return toks, gaps


build(None)
out = {}
for dt in ("bfloat16", "float16"):
    net = build(dt)
    for paged in (True, False):
        kw = dict(max_slots=2, max_len=64, paged=paged)
        eng = GenerationEngine(net, name="t", logprobs_topn=2, **kw)
        runs = [plain(eng, p) for p in prompts]
        out[f"{dt}-{int(paged)}-0"] = {
            "tokens": [r[0] for r in runs], "gaps": [r[1] for r in runs],
            "hits": eng.pool.hits if paged else 0}
        eng = GenerationEngine(net, name="t", **kw)
        eng.attach_draft(GenerationEngine(net, name="d", **kw), spec_k=4)
        out[f"{dt}-{int(paged)}-1"] = {
            "tokens": [eng.generate(p, budget) for p in prompts]}
with open(out_dir + "/jax.json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX engines' tokens and gaps, and the fp32 parameters."""
    out = tmp_path_factory.mktemp("jax16")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD,
         repr((SHAPE, PROMPTS, BUDGET, str(out)))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "jax.json") as f:
        runs = json.load(f)
    return {"runs": runs, "params": dict(np.load(out / "params.npz"))}


@pytest.fixture(scope="module")
def nets(jax_ref):
    """The port's net at fp32 and cast to each 16-bit dtype, all from the
    JAX net's fp32 parameters."""
    def load():
        return load_jax_params(GPTModel(device="cpu", **SHAPE),
                               jax_ref["params"])
    out = {"fp32": load()}
    for tag, (name, _) in DTYPES.items():
        out[tag] = load().cast(name)
    return out


def _engine(net, paged=True, draft=None, name="t", **kw):
    """A 2-slot engine at max_len 64; ``draft`` a net to attach (spec_k
    4)."""
    eng = GenerationEngine(net, name=name, max_slots=2, max_len=64,
                           paged=paged, **kw)
    if draft is not None:
        eng.attach_draft(GenerationEngine(draft, name="d", max_slots=2,
                                          max_len=64, paged=paged),
                         spec_k=4)
    return eng


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def ulps(got, want):
    """The largest distance of ``got`` from ``want`` (one 16-bit dtype) in
    ulps of that dtype at max(|want|, ULP_FLOOR x its largest)."""
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    g, w = got.float(), want.float()
    mag = w.abs().clamp(min=max(ULP_FLOOR * float(w.abs().max()),
                                2.0 ** -24))
    mant = 7 if want.dtype == torch.bfloat16 else 10
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
    if want.dtype == torch.float16:
        ulp = ulp.clamp(min=2.0 ** -24)
    return float(((g - w).abs() / ulp).max())


# ------------------------------------------- (a) K2-K5 with a 16-bit query
def _decode_case(seed, dt, Q=None, S=3, H=2, D=16, bs=16, MB=8,
                 positions=(0, 15, 127)):
    """q (S, H, D), or (S, H, Q, D) with ``Q``, in ``dt`` from numpy; an
    fp32 pool of 1 + S * MB shuffled blocks with each slot's table up to
    its last row's position (the null block 0 past it), and the same K/V
    as a dense (S, H, MB * bs, D) cache."""
    rng = np.random.RandomState(seed)
    NB = 1 + S * MB
    kp = rng.randn(NB, H, bs, D).astype(np.float32)
    vp = rng.randn(NB, H, bs, D).astype(np.float32)
    q = rng.randn(*((S, H, D) if Q is None else (S, H, Q, D))).astype(
        np.float32)
    pos = np.asarray(positions, np.int32)
    rows = 1 if Q is None else Q
    perm = rng.permutation(np.arange(1, NB))
    tables = np.zeros((S, MB), np.int32)
    for s in range(S):
        live = min(MB, (int(pos[s]) + rows - 1) // bs + 1)
        tables[s, :live] = perm[s * MB:s * MB + live]
    kd = kp[tables].transpose(0, 2, 1, 3, 4).reshape(S, H, MB * bs, D)
    vd = vp[tables].transpose(0, 2, 1, 3, 4).reshape(S, H, MB * bs, D)
    return _t(q).to(dt), kp, vp, tables, pos, kd, vd


# kernel -> (port plain version, Pallas function, paged, query rows)
KERNELS = {"K2": ("_plain_paged_decode_attention", "_paged_decode_pallas",
                  True, None),
           "K3": ("_plain_decode_attention", "_decode_pallas", False, None),
           "K4": ("_plain_paged_verify_decode_attention",
                  "_paged_verify_pallas", True, 5),
           "K5": ("_plain_verify_decode_attention", "_verify_pallas", False,
                  5)}


@pytest.mark.parametrize("tag", sorted(DTYPES))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_16bit_query_within_an_ulp_of_pallas(kernel, tag):
    """Rows at position 0, across a block edge (15/16) and at the cache's
    last key; verify rows past it (127 + 0..4) clamp at the last key."""
    import jax
    import jax.numpy as jnp
    jfa = importlib.import_module(
        "incubator_mxnet_tpu.kernels.flash_attention")
    plain_name, pallas_name, paged, Q = KERNELS[kernel]
    dt = DTYPES[tag][1]
    q, kp, vp, tables, pos, kd, vd = _decode_case(
        21 + sorted(KERNELS).index(kernel), dt, Q=Q)
    cache = (kp, vp, tables) if paged else (kd, vd)
    got = getattr(tfa, plain_name)(q, *(_t(a) for a in cache), _t(pos),
                                   0.25)
    jq = jnp.asarray(q.float().numpy()).astype(jnp.dtype(DTYPES[tag][0]))
    run = jax.jit(lambda *a: getattr(jfa, pallas_name)(
        *a, 0.25, interpret=True))
    want = run(jq, *(jnp.asarray(a) for a in cache), jnp.asarray(pos))
    assert got.dtype == dt and str(want.dtype) == DTYPES[tag][0]
    want_t = torch.from_numpy(np.array(want.astype(jnp.float32))).to(dt)
    assert ulps(got, want_t) <= 1.0
    # the public entries route CPU tensors to the plain versions
    route = {"K2": tfa.paged_decode_attention, "K3": tfa.decode_attention,
             "K4": tfa.paged_verify_decode_attention,
             "K5": tfa.verify_decode_attention}[kernel]
    assert torch.equal(route(q, *(_t(a) for a in cache), _t(pos),
                             scale=0.25), got)


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_plain_16bit_paged_equals_dense_and_verify_rows_equal_decode(tag):
    """K2 == K3 and K4 == K5 on the same live K/V, and K4's row j == K2
    at ``positions + j``, bit for bit, at a 16-bit q (the engine's paged
    == dense and spec == plain rest on these)."""
    dt = DTYPES[tag][1]
    q, kp, vp, tables, pos, kd, vd = _decode_case(31, dt, Q=5,
                                                  positions=(0, 14, 60))
    paged = tfa.paged_verify_decode_attention(q, _t(kp), _t(vp),
                                              _t(tables), _t(pos))
    dense = tfa.verify_decode_attention(q, _t(kd), _t(vd), _t(pos))
    assert paged.dtype == dt and torch.equal(paged, dense)
    for j in range(5):
        row = q[:, :, j].contiguous()
        dec = tfa.paged_decode_attention(row, _t(kp), _t(vp), _t(tables),
                                         _t(pos + j))
        assert torch.equal(dec, paged[:, :, j])
        assert torch.equal(dec, tfa.decode_attention(row, _t(kd), _t(vd),
                                                     _t(pos + j)))


# --------------------------------------------------- (b) engine against JAX
def _same_or_near_tie(net, tag, prompt, want, got, gaps):
    """``got`` equals ``want`` (JAX's), or first differs at a step whose
    JAX top-2 gap is below ``NEAR_TIE[tag]`` x max(1, |top logit|).
    Returns the index of the first difference, or None."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        if a == b:
            continue
        with torch.no_grad():
            top = float(net(torch.tensor([list(prompt) + list(want[:i])]))
                        [0, -1].float().max())
        lim = NEAR_TIE[tag] * max(1.0, abs(top))
        assert gaps[i] < lim, (f"{got} != {want}: split at {i}, JAX gap "
                               f"{gaps[i]} >= {lim}")
        return i
    return None


@pytest.mark.parametrize("draft", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_cast_engine_tokens_equal_jax(nets, jax_ref, tag, paged, draft):
    """Greedy tokens of the three prompts in turn (the third a prefix hit
    in paged mode) equal the JAX engine's, or split at a near-tie."""
    net = nets[tag]
    eng = _engine(net, paged, draft=net if draft else None)
    hits = eng.pool.hits if paged else 0
    got = [eng.generate(p, BUDGET) for p in PROMPTS]
    name = DTYPES[tag][0]
    want = jax_ref["runs"][f"{name}-{int(paged)}-{int(draft)}"]["tokens"]
    gaps = jax_ref["runs"][f"{name}-{int(paged)}-0"]["gaps"]
    for p, w, g, gp in zip(PROMPTS, want, got, gaps):
        _same_or_near_tie(net, tag, p, w, g, gp)
    if paged:
        assert eng.pool.hits - hits \
            == jax_ref["runs"][f"{name}-1-0"]["hits"] == 1


# ---------------------------------------- (c) the port's contracts at 16 bits
@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_cast_paged_equals_dense_and_spec_equals_plain(nets, tag):
    """Every prompt's tokens through paged and dense engines, each plain
    and with a draft of the net's dtype, are one list; the engines keep
    fp32 caches and write the net's dtype into them."""
    net = nets[tag]
    runs = []
    for paged in (True, False):
        for draft in (None, net):
            eng = _engine(net, paged, draft=draft)
            assert all(c.dtype == torch.float32 for c in eng._cache)
            runs.append([eng.generate(p, BUDGET) for p in PROMPTS])
    assert all(r == runs[0] for r in runs[1:])


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_cast_batched_equals_solo(nets, tag, closer):
    """Four staggered requests through one batcher (two slots: the later
    ones join mid-flight; the third hits the first's prefix), paged and
    with a draft: each equals its solo run on a fresh engine in the same
    order."""
    net = nets[tag]
    prompts = PROMPTS + [[7, 1, 8, 2, 8]]
    for draft in (None, net):
        solo = _engine(net, draft=draft)
        want = [solo.generate(p, BUDGET) for p in prompts]
        bat = closer(ContinuousBatcher(_engine(net, draft=draft)))
        reqs = [bat.submit_async(p, max_new_tokens=BUDGET) for p in prompts]
        assert [r.result(timeout=60) for r in reqs] == want


def _post(base, path, body, stream=False):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        if not stream:
            return json.loads(resp.read())
        tokens, event = [], None
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: ") and event == "token":
                tokens.append(json.loads(line[len("data: "):])["token"])
        return tokens


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_cast_generate_over_http_equals_the_batcher(nets, tag, closer):
    """``:generate`` (JSON and SSE) on a ``ModelServer`` holding a cast
    engine returns the batcher's tokens; the server needs nothing of its
    own for a 16-bit net."""
    net = nets[tag]
    bat = closer(ContinuousBatcher(_engine(net)))
    want = [bat.submit_async(p, max_new_tokens=BUDGET).result(timeout=60)
            for p in PROMPTS[:2]]
    srv = closer(ModelServer(port=0, host="127.0.0.1"))
    srv.add_model("g16", _engine(net), warmup=True)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    path = "/v1/models/g16:generate"
    body = _post(base, path, {"tokens": PROMPTS[0],
                              "max_new_tokens": BUDGET})
    assert body["tokens"] == want[0]
    assert _post(base, path, {"tokens": PROMPTS[1], "max_new_tokens": BUDGET,
                              "stream": True}, stream=True) == want[1]


@pytest.mark.parametrize("mix", ["bf16-fp32", "fp32-bf16", "bf16-fp16"])
def test_draft_of_another_dtype_is_accepted(nets, mix):
    """JAX's ``attach_draft`` checks slots, length and vocabulary, no
    dtype: a draft of another dtype serves, and every emitted token is
    still the target's (spec == plain)."""
    target, draft = (nets[t] for t in mix.split("-"))
    plain = _engine(target)
    spec = _engine(target, draft=draft)
    for p in PROMPTS:
        assert spec.generate(p, BUDGET) == plain.generate(p, BUDGET)


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_sampling_and_health_take_16bit_logits_as_jax(tag):
    """16-bit logits with an fp32 bias row promote to fp32 before the
    bias is added in both packages (JAX ``(lg + bias).astype(float32)``):
    equal greedy and sampled tokens, top-n logprobs within 1e-6, and the
    decode-health stats within 1e-6."""
    import jax.numpy as jnp
    from incubator_mxnet_tpu import health as jhealth
    from incubator_mxnet_tpu.serving import sampling as jsamp
    from incubator_mxnet_tpu_torch import health as thealth
    name, dt = DTYPES[tag]
    rng = np.random.RandomState(5)
    S, V = 4, 50
    lg = _t(rng.randn(S, V).astype(np.float32) * 4).to(dt)
    bias = rng.randn(S, V).astype(np.float32) * 1e-3
    bias[1, :5] = -1e9
    temps = np.array([0.0, 0.7, 1.0, 0.0], np.float32)
    topks = np.array([0, 5, 0, 3], np.int32)
    topps = np.array([1.0, 0.9, 0.5, 1.0], np.float32)
    roots = np.stack([tsamp.root_key(s) for s in (1, 2, 3, 4)])
    idx = np.array([3, 7, 11, 2], np.int64)
    keys = tsamp.step_keys(_t(roots.astype(np.int64)), _t(idx))
    jlg = jnp.asarray(lg.float().numpy()).astype(jnp.dtype(name))
    jkeys = jsamp.step_keys(jnp.asarray(roots.astype(np.uint32)),
                            jnp.asarray(idx.astype(np.int32)))
    got = tsamp.sample_tokens(lg, _t(temps), _t(topks.astype(np.int64)),
                              _t(topps), _t(bias), keys)
    want = jsamp.sample_tokens(jlg, jnp.asarray(temps), jnp.asarray(topks),
                               jnp.asarray(topps), jnp.asarray(bias), jkeys)
    assert got.tolist() == np.asarray(want).tolist()
    tv, ti = tsamp.topn_logprobs(lg, _t(bias), 5)
    jv, ji = jsamp.topn_logprobs(jlg, jnp.asarray(bias), 5)
    assert tv.dtype == torch.float32 and ti.tolist() == np.asarray(
        ji).tolist()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(thealth.decode_health(lg), jhealth.decode_health(jlg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------ on the card (cuda mark)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_cuda_16bit_decode_kernels_match_plain(tag, D):
    """K2-K5's 16-bit instances at 8 slots over a 1024-key cache (blocks
    of 16), positions at 0, the chunk edges 63/64, and the last key (a
    verify's rows run past it): within 1 ulp of their plain versions; K2
    == K3 and K4 == K5 bit for bit; every K4 row j == K2 at ``positions +
    j`` bit for bit; launches under ``"<kernel>.<dtype>"``, none fp32."""
    _need_cuda()
    dt = DTYPES[tag][1]
    positions = (0, 63, 64, 65, 1023, 1, 500, 127)
    tfa.reset_launch_counts()
    for Q in (None, 5):
        q, kp, vp, tables, pos, kd, vd = _decode_case(
            41, dt, Q=Q, S=8, H=4, D=D, MB=64, positions=positions)
        cu = [x.cuda() for x in (q, _t(kp), _t(vp), _t(tables), _t(pos),
                                 _t(kd), _t(vd))]
        cq, ckp, cvp, ctab, cpos, ckd, cvd = cu
        if Q is None:
            paged = tfa.paged_decode_attention(cq, ckp, cvp, ctab, cpos)
            dense = tfa.decode_attention(cq, ckd, cvd, cpos)
            want = tfa.paged_decode_attention(q, _t(kp), _t(vp), _t(tables),
                                              _t(pos))
        else:
            paged = tfa.paged_verify_decode_attention(cq, ckp, cvp, ctab,
                                                      cpos)
            dense = tfa.verify_decode_attention(cq, ckd, cvd, cpos)
            want = tfa.paged_verify_decode_attention(
                q, _t(kp), _t(vp), _t(tables), _t(pos))
        torch.cuda.synchronize()
        assert paged.dtype == dense.dtype == dt
        assert ulps(paged.cpu(), want) <= 1.0
        assert torch.equal(paged, dense)
        if Q is not None:
            for j in range(Q):
                dec = tfa.paged_decode_attention(cq[:, :, j].contiguous(),
                                                 ckp, cvp, ctab, cpos + j)
                assert torch.equal(dec, paged[:, :, j])
    counts = {k: v for k, v in tfa.launch_counts.items() if v}
    assert counts == {f"paged_decode.{tag}": 2 + 2 * 5,
                      f"decode.{tag}": 2, f"paged_verify.{tag}": 2,
                      f"verify.{tag}": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_cuda_cast_engine_graphs_equal_eager(tag, paged):
    """A cast net's engine (with a draft of its dtype) on the card: its
    programs captured at the net's dtype, the replays' tokens over prompts
    and steps equal its eager bodies' bit for bit, with the same launch
    counts, all of them 16-bit instances."""
    _need_cuda()
    from incubator_mxnet_tpu_torch import initializer as tinit
    net = GPTModel(device="cuda", **SHAPE)
    tinit.initialize(net, tinit.Normal(0.6), 0)
    net.cast(DTYPES[tag][0])
    eng = GenerationEngine(net, name="t", max_slots=2, max_len=64,
                           paged=paged)
    eng.attach_draft(GenerationEngine(net, name="d", max_slots=2,
                                      max_len=64, paged=paged), spec_k=4)
    eng.warmup()

    def run():
        eng.reset()             # the prefix cache too: both runs start cold
        tfa.reset_launch_counts()
        toks = [eng.generate(p, BUDGET, speculative=spec)
                for p in PROMPTS for spec in (False, True)]
        torch.cuda.synchronize()
        return toks, {k: v for k, v in tfa.launch_counts.items() if v}
    graph, graph_counts = run()
    with eng._eager_bodies():
        eager, eager_counts = run()
    assert graph == eager and graph_counts == eager_counts
    assert all("." in k for k in graph_counts if k != "flash_fwd") \
        and "flash_fwd" not in graph_counts
