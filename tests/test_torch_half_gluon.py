"""The port's 16-bit nets outside the train step, against the JAX package
on the CPU: the dtype of every layer's output of a cast BERT and GPT (a
census by forward hooks on both sides), the Gluon loop
(``gluon.Trainer``) on a bf16 ``gpt_tiny`` and on an fp16 one with
``multi_precision=True``, fused and ``fused=False``, the multi-precision
ops ``mp_sgd_update``/``mp_sgd_mom_update``, one-shot serving
(``InferenceEngine``) of a bf16 encoder; and, on the port alone, a 16-bit
checkpoint round trip, a resumed fp16 ``multi_precision`` run, layers
built at a dtype, and the MFU collector's peak for a cast step.

The JAX side runs once per module in a child interpreter (every
``MXNET_*`` variable unset, one XLA thread); numbers cross as fp32 values
(exact for 16-bit ones) in an ``.npz``, dtypes as names in JSON.

Tolerances, by the arithmetic:
- the census and every dtype: equal;
- the Gluon loop at 16 bits: both sides round each op of the update to
  the 16-bit type (the JAX fused update casts lr and wd to it, the eager
  ops weak-type them), but the forward and backward sum in other orders
  (XLA also keeps some fused intermediates at fp32), so the gradients
  differ by 16-bit ulps: a loss may differ by ``HALF_ULPS`` ulps of its
  dtype, and a value or an Adam moment by as many at its leaf's largest
  magnitude;
- the fp32 masters of ``multi_precision``: fp32 arithmetic, but over
  fp16 gradients that differ as above, which move Adam's normalised step
  lr m / sqrt(v) by a few % of lr: within lr x STEPS / 8;
- in both, an element whose gradient is within the 16-bit noise of zero
  may change sign between the implementations, and Adam turns that into
  a whole lr-sized step the other way: such elements are counted and
  kept under ``FLIP_SHARE`` of all (a few % at this initialisation), and
  every value stays within 2 lr (1 + 2^-6) per step; the attention's key
  projection bias is left out, as in the fp32 Gluon test: its gradient is
  rounding noise in both packages (a key bias shifts every score of a row
  alike);
- the port's fused update against its ``fused=False`` loop, and a
  resumed run against the uninterrupted one: bit for bit;
- the mp ops: fp32 arithmetic on the same numbers, bit for bit;
- one-shot outputs (bf16): ``HALF_ULPS`` ulps at each output's largest
  magnitude (the encoder's sums in other orders, through 2 layers)."""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as ag
from incubator_mxnet_tpu_torch import telemetry
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import bert as tbert
from incubator_mxnet_tpu_torch.models import gpt

import torch_half_training as TH

ROOT = Path(__file__).resolve().parents[1]
V, T, B, LR, STEPS = 64, 16, 2, 2e-3, 3
HALF_ULPS = 4
MASTER_TOL = LR * STEPS / 8
FLIP_SHARE = 5e-2
STEP_BOUND = 2 * LR * (1 + 2.0 ** -6) * STEPS

_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json, re, sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as ag
from incubator_mxnet_tpu.gluon.block import Block
from incubator_mxnet_tpu.models import bert as B
from incubator_mxnet_tpu.models import gpt
from incubator_mxnet_tpu.ndarray import optimizer_ops as jops

V, T, NB, lr, steps = eval(sys.argv[2])
out, meta = {}, {}


def f32(a):
    return np.asarray(a).astype(np.float32)


def strip(pre, name):
    name = name[len(pre):] if name.startswith(pre) else name
    return re.sub(r"^bertmodel\d+_", "bertmodel0_", name)


# the activation census: every block's output dtypes, in call order
rec = []
orig = Block.__call__


def call(self, *a, **k):
    o = orig(self, *a, **k)
    outs = o if isinstance(o, (tuple, list)) else (o,)
    rec.append([type(self).__name__,
                [str(getattr(x, "dtype", None)) for x in outs]])
    return o


rng = np.random.default_rng(0)
ids = rng.integers(0, V, (NB, T)).astype(np.int32)
types = np.zeros((NB, T), np.int32)
labels = np.concatenate([rng.integers(0, V, (NB, T)),
                         rng.integers(0, 2, (NB, 1))], axis=1).astype(
                             np.float32)
valid = np.array([T, 7], np.int32)
out.update(ids=ids, types=types, labels=labels, valid=valid)
for dt in ("bfloat16", "float16"):
    mx.random.seed(0)
    net = B.BERTForPretrain(B.BERTModel(vocab_size=V, units=32,
                                        hidden_size=64, num_layers=2,
                                        num_heads=2, max_length=32,
                                        dropout=0.0), vocab_size=V)
    net.initialize(init=mx.init.Normal(0.02))
    net.cast(dt)
    if dt == "bfloat16":
        for k, p in net.collect_params().items():
            out["bert/" + strip(net.prefix, k)] = f32(p.data().asnumpy())
    Block.__call__ = call
    rec.clear()
    mlm, nsp = net(mx.nd.array(ids, dtype="int32"),
                   mx.nd.array(types, dtype="int32"),
                   mx.nd.array(valid, dtype="int32"))
    B.BERTPretrainLoss(V)(mlm, nsp, mx.nd.array(labels))
    meta["census/bert/" + dt] = list(rec)
    rec.clear()
    mx.random.seed(0)
    g = gpt.gpt_tiny(vocab_size=V, dropout=0.0)
    g.initialize(init=mx.init.Normal(0.02))
    g.cast(dt)
    g(mx.nd.array(ids, dtype="int32"))
    meta["census/gpt/" + dt] = list(rec)
    Block.__call__ = orig

# one-shot: the bf16 encoder behind InferenceEngine, n = 3 of bucket 4
from incubator_mxnet_tpu.serving import InferenceEngine
mx.random.seed(0)
enc = B.BERTModel(vocab_size=V, units=32, hidden_size=64, num_layers=2,
                  num_heads=2, max_length=32, dropout=0.0)
enc.initialize(init=mx.init.Normal(0.02))
for k, p in enc.collect_params().items():
    out["enc/" + strip(enc.prefix, k)] = f32(p.data().asnumpy())
enc.cast("bfloat16")
eng = InferenceEngine.from_block(enc, [((T,), "int32"), ((T,), "int32"),
                                       ((), "int32")], max_batch_size=4)
r = np.random.RandomState(3)
x = [r.randint(0, V, (3, T)).astype(np.int32),
     np.zeros((3, T), np.int32), np.array([T, 5, 9], np.int32)]
res = eng.predict(x)
meta["oneshot/dtypes"] = [str(o.dtype) for o in res]
for i, a in enumerate(x):
    out["oneshot/x%d" % i] = a
for i, o in enumerate(res):
    out["oneshot/out%d" % i] = f32(o)


# the Gluon loop at 16 bits (train_gpt.py's, gpt_tiny)
def make_batch(rng, batch_size, seq_len, vocab):
    start = rng.randint(0, vocab, (batch_size, 1))
    stride = rng.randint(1, 4, (batch_size, 1))
    seq = (start + stride * np.arange(seq_len + 1)[None]) % vocab
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


for tag, dt, opts in (("bf16", "bfloat16", {}),
                      ("mp16", "float16", {"multi_precision": True})):
    mx.random.seed(0)
    net = gpt.gpt_tiny(vocab_size=V, dropout=0.0)
    net.initialize(init=mx.init.Normal(0.02))
    params = net.collect_params()
    pre = net.prefix
    for k, p in params.items():
        out[tag + "/w0/" + k[len(pre):]] = f32(p.data().asnumpy())
    net.cast(dt)
    net.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(params, "adam",
                               dict({"learning_rate": lr}, **opts))
    rng = np.random.RandomState(0)
    losses = []
    for s in range(steps):
        xb, yb = make_batch(rng, NB, T, V)
        out[tag + "/x%d" % s], out[tag + "/y%d" % s] = xb, yb
        with ag.record():
            logits = net(mx.nd.array(xb, dtype="int32"))
            L = loss_fn(logits.reshape((-1, V)),
                        mx.nd.array(yb.reshape(-1).astype(np.float32))
                        ).mean()
        L.backward()
        trainer.step(1)
        losses.append(float(f32(L.asnumpy())))
    meta[tag + "/dtypes"] = []
    meta[tag + "/names"] = []
    for i, (k, p) in enumerate(params.items()):
        n = k[len(pre):]
        meta[tag + "/names"].append(n)
        out[tag + "/w/" + n] = f32(p.data().asnumpy())
        st = trainer._updaters.states[i]
        if opts:
            w32, (m, v) = st
            out[tag + "/master/" + n] = f32(w32.asnumpy())
        else:
            m, v = st
        out[tag + "/m/" + n] = f32(m.asnumpy())
        out[tag + "/v/" + n] = f32(v.asnumpy())
        meta[tag + "/dtypes"].append([str(p.data().asnumpy().dtype),
                                      str(m.asnumpy().dtype)])
    out[tag + "/losses"] = np.asarray(losses, np.float64)

# the multi-precision ops
r = np.random.RandomState(7)
w32 = r.randn(33).astype(np.float32)
g16 = r.randn(33).astype(np.float16)
mom = (r.randn(33) * 0.1).astype(np.float32)
out.update(mp_w32=w32, mp_g16=g16, mp_mom=mom)
for name in ("mp_sgd_update", "mp_sgd_mom_update"):
    w = mx.nd.array(w32, dtype="float16")
    m32 = mx.nd.array(w32)
    g = mx.nd.array(g16, dtype="float16")
    mm = mx.nd.array(mom)
    kw = dict(lr=0.05, wd=0.01, rescale_grad=0.5, clip_gradient=0.8)
    if name == "mp_sgd_update":
        jops.mp_sgd_update(w, g, m32, **kw)
    else:
        jops.mp_sgd_mom_update(w, g, mm, m32, momentum=0.9, **kw)
        out[name + "/mom"] = f32(mm.asnumpy())
    out[name + "/w"] = f32(w.asnumpy())
    out[name + "/w32"] = f32(m32.asnumpy())
    meta[name + "/dtype"] = str(w.asnumpy().dtype)
np.savez(sys.argv[1], **out)
print(json.dumps(meta))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX side's numbers, computed once in a child interpreter."""
    path = tmp_path_factory.mktemp("half_gluon_ref") / "ref.npz"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")]
                                  if x]))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(path), repr((V, T, B, LR, STEPS))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    meta = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(path) as z:
        return meta, dict(z)


def _group(data, tag):
    pre = tag + "/"
    return {k[len(pre):]: v for k, v in data.items() if k.startswith(pre)}


def _dt(t):
    return str(t.dtype).replace("torch.", "")


def _in_thread(fn):
    """``fn()`` in a fresh thread: Gluon's name counters are per thread,
    so a net built there gets the first names, as in the JAX child."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:      # re-raised on the test's thread
            box["err"] = e
    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


# ------------------------------------------------------------- census
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("model", ["bert", "gpt"])
def test_cast_net_layer_dtypes_match_jax(ref, model, dtype):
    """Every layer's output dtype of a cast net, in call order, as the
    JAX net's: embeddings, LayerNorm, GELU, attention (its fp32 mask),
    the heads, the MLM/NSP loss and the GPT logits."""
    meta, _ = ref
    rec = []
    with mx.cpu():
        if model == "bert":
            net = tbert.BERTForPretrain(tbert.BERTModel(
                vocab_size=V, units=32, hidden_size=64, num_layers=2,
                num_heads=2, max_length=32, dropout=0.0, device="cpu"),
                vocab_size=V)
            loss = tbert.BERTPretrainLoss(V)
            mods = list(net.modules()) + list(loss.modules())
        else:
            net = gpt.gpt_tiny(vocab_size=V, dropout=0.0, device="cpu")
            mods = list(net.modules())
        mx.random.seed(0)
        net.initialize(init=mx.init.Normal(0.02))
        net.cast(dtype)
    hooks = [m.register_forward_hook(lambda mod, i, o: rec.append(
        [type(mod).__name__, [_dt(x) for x in (
            o if isinstance(o, (tuple, list)) else (o,))]]))
        for m in mods]
    try:
        _, data = ref
        ids = torch.from_numpy(data["ids"])
        with torch.no_grad():
            if model == "bert":
                mlm, nsp = net(ids, torch.from_numpy(data["types"]),
                               torch.from_numpy(data["valid"]))
                loss(mlm, nsp, torch.from_numpy(data["labels"]))
            else:
                net(ids)
    finally:
        for h in hooks:
            h.remove()
    assert rec == meta[f"census/{model}/{dtype}"]


# --------------------------------------------------------- Gluon loop
def _gluon_run(data, tag, dtype, opts, fused):
    """The port's 3 steps of ``train_gpt.py``'s loop at ``dtype`` from the
    JAX initial values: (losses, net's params, trainer)."""
    def build():
        with mx.cpu():
            net = gpt.gpt_tiny(vocab_size=V, dropout=0.0, device="cpu")
            load_jax_params(net, _group(data, tag + "/w0"))
            net.cast(dtype)
            net.hybridize()
            params = net.collect_params()
            tr = mx.gluon.Trainer(params, "adam",
                                  dict({"learning_rate": LR}, **opts),
                                  fused=fused)
        return net, params, tr
    net, params, tr = _in_thread(build)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    with mx.cpu():
        for s in range(STEPS):
            x = mx.nd.array(data[f"{tag}/x{s}"], dtype="int32")
            y = mx.nd.array(data[f"{tag}/y{s}"].reshape(-1).astype(
                np.float32))
            with ag.record():
                L = loss_fn(net(x).reshape((-1, V)), y).mean()
            L.backward()
            tr.step(1)
            losses.append(float(L.asnumpy()))
    return losses, params, tr


def _flips(got, want, tol, bound=None):
    """(elements beyond ``tol``, elements) of one leaf against JAX's;
    every element within ``bound`` plus ``tol`` where a bound is given."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    if bound is not None:
        assert float(d.max()) <= bound + tol, (float(d.max()), bound)
    return int((d > tol).sum()), d.size


def _half_tol(want, dtype):
    """``HALF_ULPS`` ulps of ``dtype`` at the leaf's largest magnitude."""
    return HALF_ULPS * TH.ulp_at(float(np.abs(want).max()), dtype)


def fmod_state(trainer, i):
    """The moment m of parameter ``i``'s state (inside the master's
    tuple under multi_precision), as a 1-tuple of its tensor."""
    st = trainer._updaters.states[i]
    inner = st[1] if isinstance(st[0], mx.nd.NDArray) and \
        isinstance(st[1], tuple) else st
    return (inner[0]._data,)


@pytest.mark.parametrize("tag,dtype,opts", [
    ("bf16", "bfloat16", {}), ("mp16", "float16", {"multi_precision": True})])
def test_gluon_loop_matches_jax_and_fused_equals_the_loop(ref, tag, dtype,
                                                          opts):
    """3 Adam steps of the Gluon loop: the fused Trainer (K8's 16-bit, or
    multi_precision, instance; its plain version here) bit for bit the
    ``fused=False`` loop; both against the JAX Trainer: losses, weights
    (the net's dtype), masters (fp32) and moments, and their dtypes."""
    meta, data = ref
    runs = [_gluon_run(data, tag, dtype, opts, f) for f in (None, False)]
    (l1, p1, t1), (l2, p2, t2) = runs
    assert l1 == l2
    for (k, a), b in zip(p1.items(), p2.values()):
        assert torch.equal(a.data()._data, b.data()._data), k
    # the JAX names in the same (collect_params) order
    names, want_dt = meta[tag + "/names"], meta[tag + "/dtypes"]
    assert len(names) == len(p1)
    jl = data[tag + "/losses"]
    for a, b in zip(l1, jl):
        assert TH.ulps(np.float32([a]), np.float32([b]), dtype) <= HALF_ULPS
    flips = total = 0
    for i, ((k, p), n) in enumerate(zip(p1.items(), names)):
        w = p.data()._data
        assert [_dt(w), _dt(fmod_state(t1, i)[0])] == want_dt[i], n
        if "multiheadattention0_dense1_bias" in n:
            continue                    # the key bias: rounding noise
        st = t1._updaters.states[i]
        if opts:
            master, (m, v) = st
            assert master._data.dtype == torch.float32
            f, t = _flips(master._data.numpy(), data[f"{tag}/master/{n}"],
                          MASTER_TOL, STEP_BOUND)
            assert torch.equal(w, master._data.to(w.dtype))
        else:
            m, v = st
            want_w = data[f"{tag}/w/{n}"]
            f, t = _flips(w.detach().float().numpy(), want_w,
                          _half_tol(want_w, dtype), STEP_BOUND)
            want_m = data[f"{tag}/m/{n}"]
            f2, t2 = _flips(m._data.float().numpy(), want_m,
                            _half_tol(want_m, _dt(m._data)))
            f, t = f + f2, t + t2
        flips, total = flips + f, total + t
    assert flips <= FLIP_SHARE * max(total, 1), (flips, total)


@pytest.mark.parametrize("name", ["mp_sgd_update", "mp_sgd_mom_update"])
def test_mp_sgd_ops_match_jax(ref, name):
    from incubator_mxnet_tpu_torch.ndarray import optimizer_ops as oo
    meta, data = ref
    with mx.cpu():
        w = mx.nd.array(data["mp_w32"], dtype="float16")
        m32 = mx.nd.array(data["mp_w32"])
        g = mx.nd.array(data["mp_g16"], dtype="float16")
        mm = mx.nd.array(data["mp_mom"])
        kw = dict(lr=0.05, wd=0.01, rescale_grad=0.5, clip_gradient=0.8)
        if name == "mp_sgd_update":
            oo.mp_sgd_update(w, g, m32, **kw)
        else:
            oo.mp_sgd_mom_update(w, g, mm, m32, momentum=0.9, **kw)
            assert np.array_equal(mm.asnumpy(), data[name + "/mom"])
    assert str(w.asnumpy().dtype) == meta[name + "/dtype"]
    assert np.array_equal(m32.asnumpy(), data[name + "/w32"])
    assert np.array_equal(w.asnumpy().astype(np.float32), data[name + "/w"])


# ----------------------------------------------------------- one-shot
def test_oneshot_bf16_encoder_matches_jax(ref):
    """``InferenceEngine.from_block`` over the bf16 encoder (int32 inputs,
    bucket 4, n = 3): outputs in bf16 as the JAX engine's, within
    ``HALF_ULPS``."""
    from incubator_mxnet_tpu_torch.serving import InferenceEngine
    meta, data = ref

    def build():
        with mx.cpu():
            enc = tbert.BERTModel(vocab_size=V, units=32, hidden_size=64,
                                  num_layers=2, num_heads=2, max_length=32,
                                  dropout=0.0, device="cpu")
        load_jax_params(enc, _group(data, "enc"))
        enc.cast("bfloat16")
        return enc
    enc = _in_thread(build)
    eng = InferenceEngine.from_block(
        enc, [((T,), "int32"), ((T,), "int32"), ((), "int32")],
        max_batch_size=4, ctx="cpu")
    res = eng.predict([data[f"oneshot/x{i}"] for i in range(3)])
    assert [_dt(o) for o in res] == meta["oneshot/dtypes"]
    for i, o in enumerate(res):
        want = data[f"oneshot/out{i}"]
        d = np.abs(o.float().numpy() - want)
        assert float(d.max()) <= _half_tol(want, "bfloat16"), (i, d.max())


# ------------------------------------------------- the port's own checks
def test_16bit_checkpoint_round_trip_keeps_the_bits(tmp_path):
    """bf16 and fp16 parameters through ``AsyncCheckpointer`` (the
    reference's byte format: bf16 as its raw 16 bits) and a Trainer's
    pickled bf16 states come back bit for bit and in their dtypes."""
    from incubator_mxnet_tpu_torch.checkpoint import AsyncCheckpointer
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(5, 3, generator=gen).to(torch.bfloat16),
              "b": torch.randn(7, generator=gen).to(torch.float16)}
    ck = AsyncCheckpointer(str(tmp_path / "m"))
    ck.save(1, params)
    ck.wait_until_finished()
    got = ck.restore(1, ctx="cpu")
    for k, v in params.items():
        t = got[k]._data if hasattr(got[k], "_data") else got[k]
        assert t.dtype == v.dtype and torch.equal(t, v), k
    import pickle
    nd = mx.nd.NDArray(params["a"])
    back = pickle.loads(pickle.dumps(nd))
    assert back._data.dtype == torch.bfloat16
    assert torch.equal(back._data, params["a"])


def test_resumed_fp16_multi_precision_run_is_bit_for_bit(tmp_path):
    """fp16 ``gpt_tiny`` with ``multi_precision=True``: 2 steps, a
    full-state checkpoint (weights, the fp32 masters inside the optimizer
    state, the RNG), 2 more steps; a fresh net and Trainer restored from
    it take the same 2 steps: every weight, master, moment and loss bit
    for bit."""
    from incubator_mxnet_tpu_torch.checkpoint import AsyncCheckpointer
    rng = np.random.RandomState(1)
    batches = [(rng.randint(0, V, (B, T)).astype(np.int32),
                rng.randint(0, V, (B * T,)).astype(np.float32))
               for _ in range(4)]

    def build(seed):
        def make():
            with mx.cpu():
                net = gpt.gpt_tiny(vocab_size=V, dropout=0.0, device="cpu",
                                   prefix="gptres_")
                mx.random.seed(seed)
                net.initialize(init=mx.init.Normal(0.02))
                net.cast("float16")
                tr = mx.gluon.Trainer(net.collect_params(), "adam",
                                      {"learning_rate": LR,
                                       "multi_precision": True})
            return net, tr
        return _in_thread(make)

    def steps(net, tr, bs):
        out = []
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        with mx.cpu():
            for x, y in bs:
                with ag.record():
                    L = loss_fn(net(mx.nd.array(x, dtype="int32")).reshape(
                        (-1, V)), mx.nd.array(y)).mean()
                L.backward()
                tr.step(1)
                out.append(float(L.asnumpy()))
        return out

    net, tr = build(0)
    steps(net, tr, batches[:2])
    ck = AsyncCheckpointer(str(tmp_path / "mp"))
    ck.save(2, {k: p.data() for k, p in net.collect_params().items()},
            trainer=tr)
    ck.wait_until_finished()
    want = steps(net, tr, batches[2:])
    net2, tr2 = build(5)
    assert ck.restore_into(params=net2.collect_params(), trainer=tr2) == 2
    got = steps(net2, tr2, batches[2:])
    assert got == want
    for (k, a), b in zip(net.collect_params().items(),
                         net2.collect_params().values()):
        assert a.data()._data.dtype == torch.float16
        assert torch.equal(a.data()._data, b.data()._data), k
    for i, st in tr._updaters.states.items():
        (w32, (m, v)), (w32b, (mb, vb)) = st, tr2._updaters.states[i]
        assert w32._data.dtype == torch.float32
        for x, y in ((w32, w32b), (m, mb), (v, vb)):
            assert torch.equal(x._data, y._data)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_dense_and_embedding_take_a_dtype(dtype):
    """``Dense(dtype=)`` and ``Embedding(dtype=)`` create their parameters
    in it, as the JAX layers do; a forward keeps it."""
    from incubator_mxnet_tpu_torch.gluon import nn
    dt = getattr(torch, dtype)
    d = nn.Dense(4, in_units=3, flatten=False, dtype=dtype, device="cpu")
    e = nn.Embedding(10, 3, dtype=dtype, device="cpu")
    assert d.weight.dtype == d.bias.dtype == e.weight.dtype == dt
    with mx.cpu():
        d.initialize(init=mx.init.Normal(0.1))
        e.initialize(init=mx.init.Normal(0.1))
    out = d(e(torch.tensor([[1, 2]])))
    assert out.dtype == dt and out.shape == (1, 2, 4)


def test_mfu_peak_follows_the_dtype_of_the_step():
    """The MFU collector's peak: the 16-bit tensor-core peak for a cast
    net's step, the fp32 one otherwise (by the card's name); a step of a
    cast net publishes its FLOPs with its GEMMs' dtype."""
    name = "NVIDIA H100 80GB HBM3"
    assert telemetry.card_peak_flops(name, torch.bfloat16) == 989e12
    assert telemetry.card_peak_flops(name, "float16") == 989e12
    assert telemetry.card_peak_flops(name, torch.float32) == 67e12
    assert telemetry.card_peak_flops("NVIDIA H100 PCIe", None) == 51e12
    assert telemetry.card_peak_flops("some other card", "bfloat16") is None
    from incubator_mxnet_tpu_torch import parallel
    seen = []

    def on_cost(where=None, flops=0.0, dtype=None, **kw):
        seen.append(dtype)
    with mx.cpu():
        net = tbert.BERTForPretrain(tbert.BERTModel(
            vocab_size=V, units=32, hidden_size=64, num_layers=1,
            num_heads=2, max_length=32, dropout=0.0, device="cpu"),
            vocab_size=V)
        mx.random.seed(0)
        net.initialize(init=mx.init.Normal(0.02))
        net.cast("bfloat16")
    tr = parallel.SPMDTrainer(net, tbert.BERTPretrainLoss(V), "sgd",
                              {"learning_rate": 1e-3},
                              mesh=parallel.make_mesh({"data": 1},
                                                      devices=["cpu"]))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (2, T)).astype(np.int32)
    labels = np.concatenate([rng.integers(0, V, (2, T)),
                             rng.integers(0, 2, (2, 1))], axis=1).astype(
                                 np.float32)
    telemetry.COST.subscribe(on_cost)
    try:
        tr.step(ids, np.zeros_like(ids), labels)
    finally:
        telemetry.COST.unsubscribe(on_cost)
    assert seen == [torch.bfloat16]
