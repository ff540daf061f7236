"""The port's one-shot serving (``InferenceEngine``, ``ModelServer``
``:predict``) on the CPU, against the JAX package and against the
contracts the reference's tests pin.

Parity: the reference tests' MLP (two ``Dense(16, relu)``, ``Xavier``
from ``mx.random.seed(7)``) and a small BERT (``BERTModel``: 2 layers of
64 units, 2 heads, FFN 128, vocab 100, T = 16, ``Normal(0.02)``) are
built by the JAX package in a child interpreter, once per module, with
every ``MXNET_*`` variable unset; it runs ``InferenceEngine.from_block(
..., max_batch_size=4).predict`` at n = 1, 3 and 5 (5 chunks into 4 + 1)
on numpy inputs from ``default_rng(0)`` (BERT: int32 ids, token types and
ragged valid lengths 1..16, per-example specs ``[((16,), int32), ((16,),
int32), ((), int32)]``), serves the MLP through a JAX ``ModelServer``
and writes the weights, inputs, outputs and HTTP answers into
``tmp_path``.  So no JAX-package global of this worker is touched.
The port loads the weights by name (``convert.load_jax_params``) and
must give the same outputs within atol/rtol 1e-4 (``test_torch_bert.py``'s
forward tolerance: fp32, different summation orders), the same number
of compiled programs, and the same key sets over HTTP.

Contracts (the port's engines on ``ctx="cpu"``): the engine tests of
``tests/test_serving.py`` (buckets, padding parity and the bounded
program count, warmup, chunking, live weights), its server tests, and the
server tests of ``tests/test_lifecycle.py`` and
``tests/test_request_trace.py`` (readiness and drain, 503 / 504 mapping,
async warmup, declared dtypes, registry churn, the SIGTERM drain,
request ids on every path, ``/trace``, the SLO blocker).  The symbol and
export formats are not ported (ROADMAP Queue A item 17): the
constructors refuse them by name.

``cuda``-marked tests (skipped without a card) hold the CUDA graphs to
the eager body bit for bit at the small BERT's width, count kernel K1's
launches per dispatched bucket, and re-capture after a weight changes
storage.  Hygiene: ``torch_serving_hygiene``."""
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import telemetry
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.models import bert as tbert
from incubator_mxnet_tpu_torch.serving import (GenerationEngine,
                                               InferenceEngine, ModelServer,
                                               derive_buckets, lifecycle)
from incubator_mxnet_tpu_torch.serving import metrics as smetrics
from incubator_mxnet_tpu_torch.serving import slo
from torch_serving_hygiene import (clean_state, closer,  # noqa: F401
                                   module_hygiene)

ROOT = Path(__file__).resolve().parents[1]
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-6)       # the reference tests' own
WAIT = 10.0
BERT = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
            num_heads=2, max_length=16)
T = 16
SIZES = (1, 3, 5)
MAX_BATCH = 4
BERT_SPECS = [((T,), np.int32), ((T,), np.int32), ((), np.int32)]

_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json, sys, urllib.request
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon import nn
from incubator_mxnet_tpu.models import bert as B
from incubator_mxnet_tpu.serving import InferenceEngine, ModelServer

path, cfg, T, sizes, mb = sys.argv[1], *eval(sys.argv[2])
out, info = {}, {}

mx.random.seed(7)
mlp = nn.HybridSequential()
for _ in range(2):
    mlp.add(nn.Dense(16, in_units=16, activation="relu"))
mlp.initialize(init=mx.init.Xavier())
mx.random.seed(0)
bert = B.BERTModel(dropout=0.0, **cfg)
bert.initialize(init=mx.init.Normal(0.02))
for tag, net in (("mlp", mlp), ("bert", bert)):
    pre = net.prefix
    for k, p in net.collect_params().items():
        k = k[len(pre):] if k.startswith(pre) else k
        out[tag + "/w/" + k] = p.data().asnumpy()

specs = {"mlp": [(16,)],
         "bert": [((T,), np.int32), ((T,), np.int32), ((), np.int32)]}
rng = np.random.default_rng(0)
engines = {}
for tag, net in (("mlp", mlp), ("bert", bert)):
    eng = engines[tag] = InferenceEngine.from_block(
        net, specs[tag], max_batch_size=mb, name=tag)
    info[tag + "/buckets"] = list(eng.buckets)
    for n in sizes:
        if tag == "mlp":
            xs = [rng.standard_normal((n, 16)).astype(np.float32)]
        else:
            xs = [rng.integers(0, cfg["vocab_size"], (n, T)).astype(np.int32),
                  rng.integers(0, 2, (n, T)).astype(np.int32),
                  rng.integers(1, T + 1, (n,)).astype(np.int32)]
        for i, x in enumerate(xs):
            out[f"{tag}/{n}/x{i}"] = x
        for i, o in enumerate(eng.predict(xs)):
            out[f"{tag}/{n}/y{i}"] = np.asarray(o)
    info[tag + "/programs"] = eng.compiled_programs()
    info[tag + "/inventory_keys"] = sorted(eng.program_inventory())

srv = ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0)
srv.add_model("mlp", engines["mlp"], warmup=True)
srv.start()
base = "http://127.0.0.1:%d" % srv.port

def call(path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"x-request-id": "rid-1"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())

x = out["mlp/3/x0"]
info["predict"] = call("/v1/models/mlp:predict", {"inputs": [x.tolist()]})
info["predict_named"] = call("/v1/models/mlp:predict",
                             {"inputs": {"data": x.tolist()}})
info["missing"] = call("/v1/models/nope:predict", {"inputs": [[0.0]]})
info["empty"] = call("/v1/models/mlp:predict", {"inputs": []})
info["models"] = call("/v1/models")
info["programs"] = call("/programs")
srv.stop()
np.savez(path, **out)
print(json.dumps(info))
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX side, computed once in a child interpreter."""
    path = tmp_path_factory.mktemp("oneshot_ref") / "ref.npz"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    # one compute thread in the child too: the files beside this one on
    # its worker include timing-sensitive reference tests
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")]
                                  if x]))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(path),
         repr((BERT, T, SIZES, MAX_BATCH))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(path) as z:
        data = dict(z)
    return info, data


def _weights(data, tag):
    pre = tag + "/w/"
    return {k[len(pre):]: v for k, v in data.items() if k.startswith(pre)}


def _port_mlp(data=None, seed=7):
    with mx.cpu():
        net = nn.HybridSequential()
        for _ in range(2):
            net.add(nn.Dense(16, in_units=16, activation="relu"))
    if data is None:
        return net.initialize(init=mx.init.Normal(0.3), seed=seed)
    return load_jax_params(net, _weights(data, "mlp"))


def _port_bert(data=None, device="cpu"):
    net = tbert.BERTModel(dropout=0.0, device=device, **BERT)
    if data is None:
        return net.initialize(init=mx.init.Normal(0.02), seed=0)
    return load_jax_params(net, _weights(data, "bert"))


def _port_engine(tag, data):
    if tag == "mlp":
        return InferenceEngine.from_block(_port_mlp(data), [(16,)],
                                          max_batch_size=MAX_BATCH,
                                          name=tag, ctx="cpu")
    return InferenceEngine.from_block(_port_bert(data), BERT_SPECS,
                                      max_batch_size=MAX_BATCH, name=tag,
                                      ctx="cpu")


# ------------------------------------------------------------- parity
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("tag", ["mlp", "bert"])
def test_predict_equals_jax(jax_ref, tag, n):
    info, data = jax_ref
    eng = _port_engine(tag, data)
    assert list(eng.buckets) == info[tag + "/buckets"]
    xs = [data[f"{tag}/{n}/x{i}"] for i in range(1 if tag == "mlp" else 3)]
    outs = eng.predict(xs)
    want = [data[f"{tag}/{n}/y{i}"] for i in range(len(outs))]
    assert len(outs) == len(want)
    for got, ref in zip(outs, want):
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, **FWD_TOL)


@pytest.mark.parametrize("tag", ["mlp", "bert"])
def test_program_count_and_inventory_keys_equal_jax(jax_ref, tag):
    info, data = jax_ref
    eng = _port_engine(tag, data)
    for n in SIZES:
        eng.predict([data[f"{tag}/{n}/x{i}"]
                     for i in range(1 if tag == "mlp" else 3)])
    assert eng.compiled_programs() == info[tag + "/programs"] == 2
    assert sorted(eng.program_inventory()) == info[tag + "/inventory_keys"]


def test_http_predict_equals_jax(jax_ref, closer):
    info, data = jax_ref
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0))
    srv.add_model("mlp", _port_engine("mlp", data), warmup=True)
    srv.start()
    x = data["mlp/3/x0"]
    got = {
        "predict": _call(srv, "/v1/models/mlp:predict",
                         {"inputs": [x.tolist()]}, rid="rid-1"),
        "predict_named": _call(srv, "/v1/models/mlp:predict",
                               {"inputs": {"data": x.tolist()}},
                               rid="rid-1"),
        "missing": _call(srv, "/v1/models/nope:predict",
                         {"inputs": [[0.0]]}, rid="rid-1"),
        "empty": _call(srv, "/v1/models/mlp:predict", {"inputs": []},
                       rid="rid-1"),
        "models": _call(srv, "/v1/models"),
        "programs": _call(srv, "/programs"),
    }
    for key in ("predict", "predict_named", "missing", "empty"):
        (code, _, body), (jcode, jbody) = got[key], info[key]
        assert code == jcode and sorted(body) == sorted(jbody), key
    for key in ("predict", "predict_named"):
        body, jbody = got[key][2], info[key][1]
        assert body["shapes"] == jbody["shapes"] == [[3, 16]]
        np.testing.assert_allclose(np.array(body["outputs"][0]),
                                   np.array(jbody["outputs"][0]), **FWD_TOL)
    assert got["missing"][2]["request_id"] == "rid-1"
    stats, jstats = (got["models"][2]["models"]["mlp"],
                     info["models"][1]["models"]["mlp"])
    assert sorted(stats) == sorted(jstats)
    assert sorted(stats["programs"]) == sorted(jstats["programs"])
    assert stats["compiled_programs"] == jstats["compiled_programs"] == 3
    eng_inv = got["programs"][2]["engines"]["mlp"]
    jeng_inv = info["programs"][1]["engines"]["mlp"]
    assert sorted(eng_inv) == sorted(jeng_inv)
    assert eng_inv["compiled_programs"] == eng_inv["expected_programs"]


# ------------------------------------------------------------ engine
def _block_engine(net=None, **kw):
    net = net or _port_mlp()
    kw.setdefault("max_batch_size", 8)
    return net, InferenceEngine.from_block(net, [(16,)], ctx="cpu", **kw)


def _x(n, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)


def _ref(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy()


def test_derive_buckets():
    assert derive_buckets(32) == (1, 2, 4, 8, 16, 32)
    assert derive_buckets(24) == (1, 2, 4, 8, 16, 24)
    assert derive_buckets(1) == (1,)
    with pytest.raises(MXNetError):
        derive_buckets(0)


def test_bucket_for():
    _, eng = _block_engine()
    assert eng.buckets == (1, 2, 4, 8)
    assert [eng.bucket_for(n) for n in (1, 3, 8)] == [1, 4, 8]
    assert eng.bucket_for(9) is None     # the caller chunks


def test_declared_buckets_override():
    _, eng = _block_engine(buckets=[4, 16])
    assert eng.buckets == (4, 16)
    assert eng.max_batch_size == 16
    assert eng.bucket_for(1) == 4


def test_padding_parity_and_bounded_programs():
    """A mixed-size stream: every output equals the block's forward row
    for row, and the programs are bounded by the buckets hit, not by the
    distinct request sizes."""
    net, eng = _block_engine()
    sizes = [1, 3, 2, 5, 8, 7, 3, 6, 1, 4]
    for i, n in enumerate(sizes):
        x = _x(n, seed=i)
        np.testing.assert_allclose(eng.predict([x])[0].numpy(),
                                   _ref(net, x), **TOL)
    assert eng.compiled_programs() == len({eng.bucket_for(n)
                                           for n in sizes})
    assert eng.compiled_programs() <= len(eng.buckets)


def test_warmup_makes_every_bucket():
    _, eng = _block_engine()
    assert not eng.warm
    assert eng.warmup() == len(eng.buckets)
    assert eng.warm and eng.compiled_programs() == len(eng.buckets)
    for n in (1, 2, 3, 5, 8):            # traffic adds no program
        eng.predict([_x(n)])
    assert eng.compiled_programs() == len(eng.buckets)


def test_warmup_needs_input_specs():
    eng = InferenceEngine(_double, ("data",), lambda: ((), ()), buckets=(2,),
                          ctx="cpu")
    with pytest.raises(MXNetError, match="input_specs"):
        eng.warmup()


def test_oversize_batch_chunks():
    net, eng = _block_engine()
    x = _x(19, seed=3)                   # > the largest bucket: 8 + 8 + 3
    np.testing.assert_allclose(eng.predict([x])[0].numpy(), _ref(net, x),
                               **TOL)
    assert eng.compiled_programs() == 2


def test_live_weight_updates_propagate():
    """The weights are read at every dispatch: ``set_data`` changes the
    next prediction without a new program."""
    net, eng = _block_engine()
    x = _x(2)
    before = eng.predict([x])[0].numpy()
    progs = eng.compiled_programs()
    for p in net.collect_params().values():
        p.set_data(p.data() * 2.0)
    after = eng.predict([x])[0].numpy()
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, _ref(net, x), **TOL)
    assert eng.compiled_programs() == progs


def test_run_exact_and_exact_shape_mode():
    eng = InferenceEngine(_double, ("data",), lambda: ((), ()), ctx="cpu",
                          input_specs=[((4,), np.float32)])
    assert eng.buckets == () and eng.max_batch_size is None and eng.warm
    assert eng.warmup() == 0
    for n in (3, 5, 3):
        x = _x(n, d=4)
        np.testing.assert_array_equal(eng.predict([x])[0].numpy(), 2 * x)
    assert eng.compiled_programs() == 2  # one per exact shape
    _, beng = _block_engine()
    x = _x(3)
    np.testing.assert_array_equal(beng.run_exact([x])[0].numpy(),
                                  beng.predict([x])[0].numpy())
    assert beng.compiled_programs() == 2     # 3 rows exact, bucket 4


def test_inputs_of_any_kind_at_canonical_dtypes():
    """numpy arrays, tensors and NDArrays all serve; 64-bit floats and
    ints narrow to 32 bits, as ``jnp.asarray`` does."""
    got = []
    eng = InferenceEngine(_double, ("data",), lambda: ((), ()),
                          buckets=(4,), ctx="cpu")
    x64 = np.arange(6, dtype=np.float64).reshape(3, 2)
    with mx.cpu():
        inputs = [x64, torch.from_numpy(x64), mx.nd.array(x64)]
    for x in inputs:
        out = eng.predict([x])[0]
        got.append(out)
        assert out.dtype == torch.float32 and tuple(out.shape) == (3, 2)
    for out in got:
        np.testing.assert_array_equal(out.numpy(), 2 * x64)
    ints = eng.predict([np.ones((2, 2), np.int64)])[0]
    assert ints.dtype == torch.int32
    # the shapes seen, as the JAX engine counts them without its jit
    # cache: float32 and int32 at (4, 2) are one
    assert eng.compiled_programs() == 1


def test_wrong_input_count_and_scalar_inputs_raise():
    _, eng = _block_engine()
    with pytest.raises(MXNetError, match="expected 1"):
        eng.predict([_x(1), _x(1)])
    with pytest.raises(MXNetError, match="batch dim"):
        eng.predict([np.float32(1.0)])


def test_engine_without_a_card_or_cpu_context_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        InferenceEngine(_double, ("data",), lambda: ((), ()), buckets=(1,))
    with pytest.raises(MXNetError, match="no CUDA device"):
        InferenceEngine.from_block(_port_mlp(), [(16,)])
    with mx.cpu():                       # a CPU scope is a CPU context
        eng = InferenceEngine(_double, ("data",), lambda: ((), ()),
                              buckets=(1,))
    assert eng.device.type == "cpu"


def test_symbol_constructors_are_refused_by_name():
    for ctor in ("from_symbol", "from_module", "from_export"):
        with pytest.raises(MXNetError, match="Queue A item 17"):
            getattr(InferenceEngine, ctor)("prefix")


def test_input_dtypes_repr_and_memory_owner():
    from incubator_mxnet_tpu_torch import telemetry_device
    eng = InferenceEngine.from_block(_port_bert(), BERT_SPECS,
                                     max_batch_size=4, name="bertsmall",
                                     ctx="cpu")
    assert eng.input_names == ["data0", "data1", "data2"]
    assert eng.input_dtypes == [np.dtype(np.int32)] * 3
    assert repr(eng) == ("<InferenceEngine 'bertsmall': inputs=['data0', "
                         "'data1', 'data2'], buckets=[1, 2, 4], "
                         "programs=0>")
    owners = telemetry_device.sample()["owners"]
    n_bytes = sum(p.numel() * 4 for p in eng._param_fn()[0])
    assert owners["params:bertsmall"] == n_bytes
    inv = eng.program_inventory()
    assert inv["expected_programs"] == 3 and inv["compiled_programs"] == 0
    assert eng.graph_stats() == {"expected": 3, "captured": 0,
                                 "captures": 0, "capture_seconds": 0.0,
                                 "pool_bytes": 0}


def test_training_block_runs_in_predict_mode():
    """A block left in training mode (dropout on) serves in predict mode
    and gets its mode back."""
    net = tbert.BERTModel(dropout=0.5, device="cpu", **BERT)
    net.initialize(init=mx.init.Normal(0.02), seed=0)
    net.train()
    eng = InferenceEngine.from_block(net, BERT_SPECS, max_batch_size=2,
                                     ctx="cpu")
    xs = [np.ones((2, T), np.int32), np.zeros((2, T), np.int32),
          np.array([T, 3], np.int32)]
    a, b = (eng.predict(xs)[0] for _ in range(2))
    assert torch.equal(a, b) and net.training
    net.eval()
    with torch.no_grad():
        want = net(*(torch.from_numpy(x) for x in xs))[0]
    assert torch.equal(a, want)


# ------------------------------------------------------------ server
def _double(in_vals, param_vals, aux_vals, key):
    return [in_vals[0] * 2]


def _engine(dim=4, dtype=np.float32, buckets=(1, 2, 4), name="m"):
    return InferenceEngine(_double, ("data",), lambda: ((), ()),
                           input_specs=[((dim,), dtype)], buckets=buckets,
                           name=name, ctx="cpu")


def _call(srv, path, payload=None, rid=None, raw=None):
    """(status, headers, JSON body) of a GET (no payload) or a POST; an
    HTTP error returns its response."""
    data = raw if raw is not None else \
        None if payload is None else json.dumps(payload).encode()
    hdrs = {"Content-Type": "application/json"}
    if rid is not None:
        hdrs["x-request-id"] = rid
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=data, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _metrics(srv):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                timeout=30) as r:
        return r.read().decode()


def _wait_for(pred, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return bool(pred())


def test_model_server_http_end_to_end(closer):
    net, eng = _block_engine(max_batch_size=8)
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=5.0))
    srv.add_model("mlp", eng, warmup=True)
    srv.start()
    x = _x(2, seed=4)
    status, _, resp = _call(srv, "/v1/models/mlp:predict",
                            {"inputs": [x.tolist()]})
    assert status == 200 and resp["shapes"] == [[2, 16]]
    np.testing.assert_allclose(np.array(resp["outputs"][0], np.float32),
                               _ref(net, x), rtol=1e-4, atol=1e-5)
    status, _, resp2 = _call(srv, "/v1/models/mlp:predict",
                             {"inputs": {"data": x.tolist()}})
    assert resp2["outputs"] == resp["outputs"]
    _, _, health = _call(srv, "/healthz")
    assert health["status"] == "ok" and health["models"] == ["mlp"]
    stats = _call(srv, "/v1/models")[2]["models"]["mlp"]
    assert stats["buckets"] == [1, 2, 4, 8]
    assert stats["compiled_programs"] == 4
    prom = _metrics(srv)
    for series in ("mxtpu_serve_batch_size", "mxtpu_serve_queue_wait_seconds",
                   "mxtpu_serve_requests"):
        assert series in prom
    assert _call(srv, "/v1/models/nope:predict",
                 {"inputs": [[0.0]]})[0] == 404
    assert _call(srv, "/v1/models/mlp:predict", {"inputs": []})[0] == 400
    srv.stop()
    assert srv.models() == []


def test_model_server_multi_model_registry(closer):
    _, eng_a = _block_engine(max_batch_size=4)
    with mx.cpu():
        small = nn.HybridSequential()
        small.add(nn.Dense(8, in_units=16, activation="relu"))
    small.initialize(init=mx.init.Normal(0.3), seed=11)
    _, eng_b = _block_engine(net=small, max_batch_size=4)
    srv = closer(ModelServer(port=0, host="127.0.0.1"))
    srv.add_model("a", eng_a)
    srv.add_model("b", eng_b)
    assert sorted(srv.models()) == ["a", "b"]
    assert smetrics.MODELS_LOADED.value == 2
    with pytest.raises(MXNetError):
        srv.add_model("a", eng_a)        # duplicate names refused
    out_a = srv.predict_json("a", {"inputs": [_x(1).tolist()]})
    out_b = srv.predict_json("b", {"inputs": [_x(1).tolist()]})
    assert out_a["shapes"] == [[1, 16]] and out_b["shapes"] == [[1, 8]]
    srv.remove_model("a")
    assert srv.models() == ["b"]
    assert smetrics.MODELS_LOADED.value == 1
    with pytest.raises(KeyError):
        srv.predict_json("a", {"inputs": [_x(1).tolist()]})
    srv.stop()
    assert smetrics.MODELS_LOADED.value == 0


def test_one_server_holds_both_engine_kinds(closer):
    """A generation model and a one-shot model side by side: each verb
    reaches only its own kind, and every report covers both."""
    from incubator_mxnet_tpu_torch import initializer as tinit
    from incubator_mxnet_tpu_torch.models.gpt import GPTModel
    gpt = GPTModel(vocab_size=50, units=32, hidden_size=64, num_layers=1,
                   num_heads=2, max_length=32, dropout=0.0, device="cpu")
    tinit.initialize(gpt, tinit.Normal(0.6), 3)
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0))
    srv.add_model("g", GenerationEngine(gpt, name="g", max_slots=1,
                                        max_len=32, scan_steps=0),
                  warmup=True)
    srv.add_model("m", _engine(), warmup=True)
    srv.start()
    assert _call(srv, "/v1/models/m:predict",
                 {"inputs": [[[1, 2, 3, 4]]]})[2]["outputs"] == \
        [[[2.0, 4.0, 6.0, 8.0]]]
    code, _, body = _call(srv, "/v1/models/m:generate", {"tokens": [1]})
    assert code == 400 and "use :predict" in body["error"]
    code, _, body = _call(srv, "/v1/models/g:predict", {"inputs": [[1.0]]})
    assert code == 400 and "use :generate" in body["error"]
    assert _call(srv, "/v1/models/g:generate",
                 {"tokens": [1, 2], "max_new_tokens": 3})[2]["count"] == 3
    models = _call(srv, "/v1/models")[2]["models"]
    assert models["g"]["kind"] == "generation"
    assert models["m"]["programs"]["expected_programs"] == 3
    engines = _call(srv, "/programs")[2]["engines"]
    assert set(engines) >= {"g", "m"}
    assert _call(srv, "/readyz")[0] == 200
    assert "models" not in _call(srv, "/health")[2]


def test_continuous_batcher_takes_the_references_knobs(closer):
    """A server's batcher defaults reach either kind, as in the
    reference (whose ContinuousBatcher passes them to DynamicBatcher)."""
    from incubator_mxnet_tpu_torch import fault
    from incubator_mxnet_tpu_torch.models.gpt import gpt_tiny
    from incubator_mxnet_tpu_torch.serving import (CircuitBreaker,
                                                   ContinuousBatcher)
    gen = GenerationEngine(gpt_tiny(dropout=0.0, device="cpu"), name="g",
                           max_slots=2, max_len=32)
    policy = fault.RetryPolicy(max_retries=0)
    breaker = CircuitBreaker("g", threshold=1)
    bat = closer(ContinuousBatcher(
        gen, ["t%d" % i for i in range(gen.vocab_size)], name="g",
        max_batch_size=8, max_delay_ms=3.0, queue_size=5,
        retry_policy=policy, breaker=breaker, default_timeout_ms=250.0))
    assert (bat.max_batch_size, bat.max_delay, bat.queue_size) == \
        (2, 0.003, 5)
    assert bat.retry_policy is policy and bat.breaker is breaker
    assert bat.default_timeout_ms == 250.0
    assert bat._token_strings()[3] == "t3"
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0,
                             default_timeout_ms=500.0))
    got = srv.add_model("g", gen)
    assert isinstance(got, ContinuousBatcher)
    assert got.default_timeout_ms == 500.0


def test_load_is_refused_by_name_with_the_references_checks(closer):
    srv = closer(ModelServer(port=0, host="127.0.0.1"))
    srv.start()
    code, _, body = _call(srv, "/v1/models/x:load", {"epoch": 0}, rid="l1")
    assert code == 400 and "prefix" in body["error"]
    assert body["request_id"] == "l1"
    code, _, body = _call(srv, "/v1/models/x:load", {"prefix": "m"})
    assert code == 400 and "Queue A item 17" in body["error"]
    srv.begin_drain()
    assert _call(srv, "/v1/models/x:load", {"prefix": "m"})[0] == 503


def test_server_readiness_and_drain_http(closer):
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0))
    srv.add_model("m", _engine(), warmup=True)
    srv.start()
    code, _, body = _call(srv, "/readyz")
    assert code == 200 and body["models"]["m"] == "SERVING"
    assert _call(srv, "/healthz")[0] == 200
    srv.begin_drain()
    code, hdrs, body = _call(srv, "/readyz")
    assert code == 503 and body["draining"] and "Retry-After" in hdrs
    code, hdrs, _ = _call(srv, "/v1/models/m:predict",
                          {"inputs": [[[1, 2, 3, 4]]]})
    assert code == 503 and "Retry-After" in hdrs
    assert _call(srv, "/v1/models/late:load", {"prefix": "x"})[0] == 503
    assert _call(srv, "/healthz")[0] == 200  # liveness is unaffected


def test_server_breaker_open_maps_to_503_retry_after(closer):
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0))
    batcher = srv.add_model("m", _engine(), warmup=True)
    batcher.breaker.trip("test")
    srv.start()
    code, hdrs, body = _call(srv, "/v1/models/m:predict",
                             {"inputs": [[[1, 2, 3, 4]]]})
    assert code == 503 and "Retry-After" in hdrs
    assert "breaker" in body["error"]
    code, _, body = _call(srv, "/readyz")
    assert code == 503 and body["models"]["m"] == "UNHEALTHY"
    assert body["blockers"] == ["m"]


def test_server_deadline_maps_to_504(closer):
    eng = _engine()
    gate = threading.Event()
    orig = eng.predict
    eng.predict = lambda arrays: (gate.wait(WAIT), orig(arrays))[1]
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0))
    srv.add_model("m", eng)
    srv.start()
    try:
        code, _, body = _call(srv, "/v1/models/m:predict",
                              {"inputs": [[[1, 2, 3, 4]]],
                               "timeout_ms": 100})
        assert code == 504 and "deadline" in body["error"]
    finally:
        gate.set()


def test_async_warmup_gates_readiness(closer):
    eng = _engine()
    gate = threading.Event()
    eng.warmup = lambda: gate.wait(WAIT)
    srv = closer(ModelServer(port=0, host="127.0.0.1"))
    srv.add_model("m", eng, warmup=True, async_warmup=True)
    try:
        assert srv.model_state("m") == lifecycle.STARTING
        ready, body = srv.readiness()
        assert not ready and body["blockers"] == ["m"]
    finally:
        gate.set()
    assert _wait_for(lambda: srv.readiness()[0])
    assert srv.model_state("m") == lifecycle.SERVING


def test_async_warmup_failure_shows_unhealthy(closer):
    eng = _engine()

    def broken():
        raise MXNetError("capture failed")
    eng.warmup = broken
    srv = closer(ModelServer(port=0, host="127.0.0.1"))
    srv.add_model("m", eng, warmup=True, async_warmup=True)
    assert _wait_for(lambda: srv.model_state("m") == lifecycle.UNHEALTHY)
    assert srv.readiness()[1]["blockers"] == ["m"]


def test_predict_json_honors_declared_dtypes(closer):
    """An int32 model served over HTTP gets int32 tensors: no float32
    cast (outputs come back as JSON integers)."""
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0))
    srv.add_model("ints", _engine(dim=3, dtype=np.int32, name="ints"))
    out = srv.predict_json("ints", {"inputs": [[[1, 2, 3]]]})
    assert out["outputs"][0] == [[2, 4, 6]]
    assert all(isinstance(v, int) for v in out["outputs"][0][0])


def test_predict_json_bert_over_int32_inputs_equals_engine(closer):
    """The small BERT's three int32 inputs by name over HTTP: the answer
    equals the engine's own predict."""
    eng = InferenceEngine.from_block(_port_bert(), BERT_SPECS,
                                     max_batch_size=4, name="bert",
                                     ctx="cpu")
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0))
    srv.add_model("bert", eng, warmup=True)
    srv.start()
    rng = np.random.default_rng(5)
    ids = rng.integers(0, BERT["vocab_size"], (3, T)).astype(np.int32)
    types = rng.integers(0, 2, (3, T)).astype(np.int32)
    valid = np.array([T, 1, 7], np.int32)
    code, _, body = _call(srv, "/v1/models/bert:predict", {"inputs": {
        "data0": ids.tolist(), "data1": types.tolist(),
        "data2": valid.tolist()}})
    assert code == 200 and body["shapes"] == [[3, T, 64], [3, 64]]
    want = eng.predict([ids, types, valid])
    for got, ref in zip(body["outputs"], want):
        np.testing.assert_array_equal(np.array(got, np.float32),
                                      ref.numpy())
    code, _, body = _call(srv, "/v1/models/bert:predict",
                          {"inputs": {"data0": ids.tolist()}})
    assert code == 400 and "missing inputs" in body["error"]


def test_registry_reads_are_locked_under_churn(closer):
    """add/remove churn racing readers never corrupts the registry or
    raises."""
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0))
    srv.add_model("keep", _engine(name="keep"))
    stop = threading.Event()
    errors = []

    def reader():
        while not stop.is_set():
            try:
                srv.models()
                srv.model_stats()
                srv.get_model("keep")
            except Exception as e:       # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for i in range(15):
            srv.add_model(f"m{i}", _engine(name=f"m{i}"))
            srv.remove_model(f"m{i}")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    assert not errors


def test_run_until_shutdown_drains_server(closer):
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0))
    srv.add_model("m", _engine(), warmup=True)
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"
    timer = threading.Timer(0.25, lifecycle.request_shutdown)
    timer.start()
    try:
        rc = lifecycle.run_until_shutdown(srv, drain_seconds=2,
                                          poll_seconds=0.05)
    finally:
        timer.join(timeout=WAIT)
    assert rc == 0
    assert srv.models() == []            # drained and stopped
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/healthz", timeout=1)


def test_http_echoes_request_id_on_every_path(closer):
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0))
    srv.add_model("m", _engine(), warmup=True)
    srv.start()
    st, h, _ = _call(srv, "/v1/models/m:predict",
                     {"inputs": [_x(1, d=4).tolist()]}, rid="client-ok-1")
    assert st == 200 and h["X-Request-Id"] == "client-ok-1"
    st, h, body = _call(srv, "/v1/models/nope:predict",
                        {"inputs": [_x(1, d=4).tolist()]}, rid="client-404")
    assert st == 404 and h["X-Request-Id"] == "client-404"
    assert body["request_id"] == "client-404"
    st, h, body = _call(srv, "/v1/models/m:predict", raw=b"{not json",
                        rid="client-400")
    assert st == 400 and h["X-Request-Id"] == "client-400"
    assert body["request_id"] == "client-400"
    st, h, _ = _call(srv, "/healthz")
    assert st == 200 and re.fullmatch(r"[0-9a-f]{16}", h["X-Request-Id"])
    st, h, _ = _call(srv, "/healthz", rid="a bad/id!" + "x" * 100)
    assert h["X-Request-Id"] == ("abadid" + "x" * 100)[:64]
    srv.begin_drain()
    st, h, body = _call(srv, "/v1/models/m:predict",
                        {"inputs": [_x(1, d=4).tolist()]},
                        rid="client-drain")
    assert st == 503 and h["X-Request-Id"] == "client-drain"
    assert body["request_id"] == "client-drain"


def test_trace_endpoint_bounded_and_request_lookup(closer):
    telemetry.start()
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0))
    srv.add_model("m", _engine(), warmup=True)
    srv.start()
    for i in range(6):
        assert _call(srv, "/v1/models/m:predict",
                     {"inputs": [_x(1, d=4, seed=i).tolist()]},
                     rid=f"t-{i}")[0] == 200
    st, _, body = _call(srv, "/trace?limit=2")
    assert st == 200 and len(body["finished"]) <= 2
    st, _, body = _call(srv, "/trace?request_id=t-3")
    assert st == 200 and body["request_id"] == "t-3"
    assert body["spans"] and body["spans"][0]["name"] == "serve.request"
    assert body["spans"][0]["attrs"]["request_id"] == "t-3"
    kids = [c["name"] for c in body["spans"][0].get("children", ())]
    assert "serve.batch" in kids


def test_slo_exhaustion_blocks_readiness(closer, monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_SLO_AVAILABILITY", "0.999")
    srv = closer(ModelServer(port=0, host="127.0.0.1", max_delay_ms=1.0))
    srv.add_model("m", _engine(), warmup=True)
    srv.start()
    assert _call(srv, "/readyz")[0] == 200
    for _ in range(9):
        slo.tracker.record("m", 0.01, ok=True)
    for _ in range(3):
        slo.tracker.record("m", 0.01, ok=False)
    st, _, body = _call(srv, "/readyz")
    assert st == 503 and "slo:m" in body.get("blockers", [])
    st, _, sbody = _call(srv, "/slo")
    assert st == 200 and sbody["models"]["m"]["exhausted"] is True
    assert sbody["models"]["m"]["burn_rate"] > 1.0
    prom = _metrics(srv)
    assert "mxtpu_slo_error_budget_remaining" in prom
    assert "mxtpu_slo_burn_rate" in prom


def test_add_model_refuses_what_is_not_an_engine(closer):
    srv = closer(ModelServer(port=0, host="127.0.0.1"))
    with pytest.raises(MXNetError, match="InferenceEngine"):
        srv.add_model("x", object())
    assert srv.models() == []


# ---------------------------------------------------------------- card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs and K1 run only on "
                    "the card")


def _card_engine(name="bertcard"):
    net = _port_bert(device="cuda")
    return net, InferenceEngine.from_block(net, BERT_SPECS, max_batch_size=8,
                                           name=name, ctx="cuda")


def _card_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, BERT["vocab_size"], (n, T)).astype(np.int32),
            rng.integers(0, 2, (n, T)).astype(np.int32),
            rng.integers(0, T + 1, (n,)).astype(np.int32)]


@pytest.mark.cuda
def test_cuda_graphs_equal_the_eager_body_bit_for_bit():
    _need_cuda()
    net, eng = _card_engine()
    assert eng.warmup() == 4 and eng.graph_stats()["captured"] == 4
    for n in (1, 3, 5, 8, 13):
        xs = _card_inputs(n, seed=n)
        got = eng.predict(xs)
        with eng._eager_bodies():
            want = eng.predict(xs)
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            assert torch.equal(g, w), f"n={n}"
    # a weight copied in place is read by the next replay, no re-capture
    w = net.pooler.weight
    w.data.mul_(2.0)
    xs = _card_inputs(3)
    got = eng.predict(xs)
    with eng._eager_bodies():
        want = eng.predict(xs)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert eng.graph_stats()["captures"] == 4


@pytest.mark.cuda
def test_cuda_k1_launches_once_per_layer_per_dispatch():
    _need_cuda()
    import importlib
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels.flash_attention")
    _, eng = _card_engine()
    eng.warmup()
    fa.reset_launch_counts()
    for n in (3, 5, 13):                 # 1 + 1 + 2 dispatches
        eng.predict(_card_inputs(n))
    torch.cuda.synchronize()
    want = {k: 0 for k in fa.launch_counts}
    want["flash_fwd"] = 4 * BERT["num_layers"]
    assert dict(fa.launch_counts) == want


@pytest.mark.cuda
def test_cuda_weight_given_new_storage_recaptures():
    _need_cuda()
    net, eng = _card_engine()
    eng.warmup()
    xs = _card_inputs(3)
    before = eng.predict(xs)[1]
    p = net.collect_params()[next(iter(net.collect_params()))]
    # held, the old storage cannot be handed back by the allocator
    old = p.data()._data.data
    p.cast("float64")                    # new storage ...
    p.cast("float32")                    # ... and back: same values
    assert p.data()._data.data_ptr() != old.data_ptr()
    after = eng.predict(xs)[1]
    st = eng.graph_stats()
    assert st["captures"] == 5 and st["captured"] == 4
    assert torch.equal(before, after)
    with eng._eager_bodies():
        assert torch.equal(eng.predict(xs)[1], after)
