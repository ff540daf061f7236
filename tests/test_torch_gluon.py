"""Gluon's core in the port (``gluon/parameter.py``, ``gluon/block.py``,
``gluon/nn``, ``gluon/loss.py``) against the JAX package, fp32 on the
CPU.

The JAX side runs in a child interpreter with every ``MXNET_*`` variable
unset: it builds ``gpt_tiny``, ``bert_tiny`` and a ``HybridSequential``
of ``Dense`` layers with activations in a fresh process (block-name
counters at zero), writes their ``collect_params()`` keys (all, and with
``select``), saves each with ``save_parameters`` and writes outputs on
fixed inputs, plus the activation layers' and every loss's outputs on
numpy inputs, into ``tmp_path``.  The port builds the same blocks in a
fresh thread (the name counters are per thread, as the reference's).  A
second child loads the port's ``save_parameters`` files into the JAX
blocks and writes their outputs.

Tolerances (fp32, the two sides sum in different orders): outputs
within 1e-5 of each output's largest magnitude (atol) and 1e-5 relative;
names and keys exactly."""
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
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon import loss as gloss
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.models import bert, gpt

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5

# the blocks both packages build, in this order, in a fresh process/thread
_BUILD = r"""
def build(mx, nn, gpt, bert, **dev):
    mx.random.seed(0)
    g = gpt.gpt_tiny(vocab_size=64, dropout=0.0, **dev)
    b = bert.bert_tiny(vocab_size=100, dropout=0.0, **dev)
    seq = nn.HybridSequential()
    with seq.name_scope():
        seq.add(nn.Dense(8, activation="relu", in_units=4, **dev),
                nn.Dense(8, activation="tanh", in_units=8, **dev),
                nn.Dense(6, activation="sigmoid", in_units=8, **dev),
                nn.Dense(3, activation="softrelu", in_units=6, **dev))
    return g, b, seq
"""

ACTS = ["relu", "sigmoid", "tanh", "softrelu", "softsign"]
LOSSES = [
    ("L2Loss", {}, ("pred", "label")),
    ("L1Loss", {"weight": 0.5}, ("pred", "label", "sw")),
    ("SigmoidBinaryCrossEntropyLoss", {}, ("pred", "bin")),
    ("SigmoidBinaryCrossEntropyLoss", {}, ("pred", "bin", None, "pw")),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True},
     ("prob", "bin")),
    ("SoftmaxCrossEntropyLoss", {}, ("pred", "cls")),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, ("pred", "dist")),
    ("SoftmaxCrossEntropyLoss", {"from_logits": True, "weight": 2.0},
     ("logp", "cls", "sw")),
    ("KLDivLoss", {}, ("logp", "dist")),
    ("KLDivLoss", {"from_logits": False}, ("pred", "dist")),
    ("HuberLoss", {"rho": 0.5}, ("pred", "label")),
    ("HingeLoss", {}, ("pred", "sign")),
    ("SquaredHingeLoss", {"margin": 2}, ("pred", "sign")),
    ("LogisticLoss", {}, ("pred", "sign")),
    ("LogisticLoss", {"label_format": "binary"}, ("pred", "bin")),
    ("TripletLoss", {}, ("pred", "label", "pred2")),
    ("PoissonNLLLoss", {}, ("pred", "count")),
    ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
     ("prob", "count")),
    ("CosineEmbeddingLoss", {"margin": 0.1}, ("pred", "pred2", "pm1")),
]

_CHILD = _BUILD + r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json, sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as ag
from incubator_mxnet_tpu.gluon import nn
from incubator_mxnet_tpu.gluon import loss as gloss
from incubator_mxnet_tpu.models import bert, gpt

out_dir, mode = sys.argv[1], sys.argv[2]
acts, losses, inputs = json.loads(open(out_dir + "/spec.json").read())
x = {k: np.asarray(v, np.float32) for k, v in inputs.items()}
g, b, seq = build(mx, nn, gpt, bert)
blocks = {"gpt": g, "bert": b, "seq": seq}
res, keys = {}, {}
if mode == "save":
    for name, blk in blocks.items():
        blk.initialize(init=mx.init.Normal(0.02))
        blk.save_parameters(out_dir + "/jax_%s.params" % name)
    np.savez(out_dir + "/jax_gpt_weights.npz", **{
        k[len(g.prefix):]: p.data().asnumpy()
        for k, p in g.collect_params().items()})
else:
    for name, blk in blocks.items():
        blk.load_parameters(out_dir + "/port_%s.params" % name)
for name, blk in blocks.items():
    keys[name] = list(blk.collect_params().keys())
keys["seq_weights"] = list(seq.collect_params(".*weight").keys())
keys["gpt_cell1"] = list(g.collect_params("gptmodel0_gptcell1_.*").keys())
ids = mx.nd.array(x["ids"], dtype="int32")
res["gpt"] = g(ids).asnumpy()
s, p = b(ids, mx.nd.zeros(ids.shape, dtype="int32"))
res["bert_seq"], res["bert_pooled"] = s.asnumpy(), p.asnumpy()
res["seq"] = seq(mx.nd.array(x["feat"])).asnumpy()
seq.hybridize()
res["seq_hybrid"] = seq(mx.nd.array(x["feat"])).asnumpy()
if mode == "save":
    for a in acts:
        res["act_" + a] = nn.Activation(a)(mx.nd.array(x["pred"])).asnumpy()
    for nm, layer in (("leaky", nn.LeakyReLU(0.1)), ("elu", nn.ELU(0.7)),
                      ("selu", nn.SELU()), ("swish", nn.Swish(1.5)),
                      ("gelu", nn.GELU())):
        res["act_" + nm] = layer(mx.nd.array(x["pred"])).asnumpy()
    for i, (cls, kw, args) in enumerate(losses):
        blk = getattr(gloss, cls)(**kw)
        nd = [None if a is None else mx.nd.array(x[a]) for a in args]
        res["loss%d" % i] = blk(*nd).asnumpy()
np.savez(out_dir + "/jax_%s.npz" % mode, **res)
json.dump(keys, open(out_dir + "/jax_%s_keys.json" % mode, "w"))
print("ok")
"""


def _inputs():
    rng = np.random.RandomState(7)
    pred = rng.randn(5, 6).astype(np.float32)
    dist = rng.rand(5, 6).astype(np.float32)
    dist /= dist.sum(-1, keepdims=True)
    logp = np.log(dist + 0.05).astype(np.float32)
    arrays = {
        "ids": rng.randint(0, 64, (2, 12)),
        "feat": rng.randn(3, 4),
        "pred": pred, "pred2": rng.randn(5, 6),
        "label": rng.randn(5, 6),
        "prob": 1 / (1 + np.exp(-rng.randn(5, 6))),
        "bin": (rng.rand(5, 6) > 0.5), "pw": rng.rand(5, 6) * 2,
        "sign": np.where(rng.rand(5, 6) > 0.5, 1.0, -1.0),
        "cls": np.array([0, 5, 2, 9, 3]), "dist": dist, "logp": logp,
        "sw": rng.rand(5, 1), "count": rng.randint(0, 6, (5, 6)),
        "pm1": np.array([1, -1, 1, 1, -1]),
    }
    # as the JAX child reads them back: float32
    return {k: np.asarray(v, np.float32) for k, v in arrays.items()}


def _child(tmp, mode):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp), mode],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / f"jax_{mode}.npz") as z:
        res = dict(z)
    return res, json.loads((tmp / f"jax_{mode}_keys.json").read_text())


def _build_port():
    """The blocks, built on the CPU in a fresh thread: fresh name
    counters, as in the JAX child's fresh process."""
    ns = {}
    exec(_BUILD, ns)
    out = {}

    def run():
        with mx.cpu():
            out["blocks"] = ns["build"](mx, nn, gpt, bert)
    t = threading.Thread(target=run)
    t.start()
    t.join()
    return out["blocks"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gluon_ref")
    spec = (ACTS, LOSSES, {k: np.asarray(v, np.float64).tolist()
                           for k, v in _inputs().items()})
    (tmp / "spec.json").write_text(json.dumps(spec))
    res, keys = _child(tmp, "save")
    return tmp, res, keys


def _close(got, want, what=""):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    np.testing.assert_allclose(
        got, want, rtol=TOL,
        atol=TOL * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _outputs(g, b, seq, x):
    with mx.cpu():
        ids = mx.nd.array(x["ids"], dtype="int32")
        s, p = b(ids, mx.nd.zeros(ids.shape, dtype="int32"))
        return {"gpt": g(ids), "bert_seq": s, "bert_pooled": p,
                "seq": seq(mx.nd.array(x["feat"]))}


# ------------------------------------------------------------ names
@pytest.mark.parametrize("block", ["gpt", "bert", "seq", "seq_weights",
                                   "gpt_cell1"])
def test_collect_params_keys_equal_jax(ref, block):
    _, _, keys = ref
    g, b, seq = _build_port()
    got = {"gpt": g.collect_params(), "bert": b.collect_params(),
           "seq": seq.collect_params(),
           "seq_weights": seq.collect_params(".*weight"),
           "gpt_cell1": g.collect_params("gptmodel0_gptcell1_.*")}[block]
    assert list(got.keys()) == keys[block]


def test_name_scopes_number_per_thread_and_scope():
    """A second model in one thread gets the next number; children are
    numbered in their parent's scope."""
    def run(out):
        with mx.cpu():
            a = gpt.gpt_tiny(vocab_size=16, num_layers=1)
            b2 = gpt.gpt_tiny(vocab_size=16, num_layers=1)
            out += [a.prefix, b2.prefix, a.cells[0].prefix,
                    a.cells[0].attention.query.prefix]
    got = []
    t = threading.Thread(target=run, args=(got,))
    t.start()
    t.join()
    assert got == ["gptmodel0_", "gptmodel1_", "gptmodel0_gptcell0_",
                   "gptmodel0_gptcell0_multiheadattention0_dense0_"]


# ------------------------------------------------- save / load, both ways
def test_jax_save_parameters_loads_into_the_port(ref):
    tmp, res, _ = ref
    g, b, seq = _build_port()
    for name, blk in (("gpt", g), ("bert", b), ("seq", seq)):
        blk.load_parameters(str(tmp / f"jax_{name}.params"))
    for k, v in _outputs(g, b, seq, _inputs()).items():
        _close(v, res[k], k)


def test_port_save_parameters_loads_into_jax(ref):
    tmp, _, _ = ref
    g, b, seq = _build_port()
    with mx.cpu():
        for name, blk in (("gpt", g), ("bert", b), ("seq", seq)):
            blk.initialize(init=mx.init.Normal(0.02), seed=3)
            blk.save_parameters(str(tmp / f"port_{name}.params"))
    res, keys = _child(tmp, "load")
    for k, v in _outputs(g, b, seq, _inputs()).items():
        _close(v, res[k], k)


# ------------------------------------------------------- hybridize
def test_hybridized_output_equals_eager(ref):
    tmp, res, _ = ref
    _, _, seq = _build_port()
    seq.load_parameters(str(tmp / "jax_seq.params"))
    x = _inputs()["feat"]
    with mx.cpu():
        eager = seq(mx.nd.array(x)).asnumpy()
        seq.hybridize()
        assert seq._active
        hyb = seq(mx.nd.array(x)).asnumpy()
    np.testing.assert_array_equal(hyb, eager)
    _close(hyb, res["seq_hybrid"])


def test_hybridize_flag_propagates_as_the_reference():
    """A plain Block passes the flag on; a HybridBlock keeps it to itself
    when activated and clears its children when deactivated."""
    with mx.cpu():
        seq = nn.Sequential()
        with seq.name_scope():
            inner = nn.HybridSequential()
            with inner.name_scope():
                d = nn.Dense(2, in_units=2)
                inner.add(d)
            seq.add(inner)
        seq.hybridize()
        assert inner._active and not d._active
        d.hybridize()
        inner.hybridize(False)
        assert not inner._active and not d._active


# -------------------------------------------------------- layers
@pytest.mark.parametrize("act", ACTS + ["leaky", "elu", "selu", "swish",
                                        "gelu"])
def test_activation_layers_match_jax(ref, act):
    _, res, _ = ref
    layers = {"leaky": lambda: nn.LeakyReLU(0.1), "elu": lambda: nn.ELU(0.7),
              "selu": nn.SELU, "swish": lambda: nn.Swish(1.5),
              "gelu": nn.GELU}
    with mx.cpu():
        layer = layers[act]() if act in layers else nn.Activation(act)
        got = layer(mx.nd.array(_inputs()["pred"]))
    _close(got, res["act_" + act], act)


def test_dense_takes_every_activation_and_flattens():
    with mx.cpu():
        x = mx.nd.array(np.random.RandomState(0).randn(2, 3, 4))
        d = nn.Dense(5, in_units=12, activation="softsign")
        d.initialize(init=mx.init.Normal(0.3), seed=0)
        got = d(x).asnumpy()
        w, bias = (p.data().asnumpy() for p in d.collect_params().values())
    want = x.asnumpy().reshape(2, 12) @ w.T + bias
    np.testing.assert_allclose(got, want / (1 + np.abs(want)), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(MXNetError, match="in_units"):
        with mx.cpu():
            nn.Dense(5)


def test_prelu_learns_its_alpha():
    with mx.cpu():
        layer = nn.PReLU()
        layer.initialize()
        x = mx.nd.array([[-2.0, 3.0]])
        assert layer.collect_params()[layer.prefix + "alpha"].data() \
            .asnumpy().tolist() == [0.25]
        with ag.record():
            y = layer(x).sum()
        y.backward()
        p = layer.collect_params()[layer.prefix + "alpha"]
        assert p.grad().asnumpy().tolist() == [-2.0]


def test_dropout_follows_train_and_predict_mode():
    """Called with NDArrays, Dropout drops exactly in train mode (inside
    ``record()`` by default, or ``train_mode()``); called with tensors it
    follows the module's ``training`` flag, as serving sets it."""
    with mx.cpu():
        drop = nn.Dropout(0.5)
        drop.eval()
        x = mx.nd.ones((64, 64))
        assert (drop(x).asnumpy() == 1).all()
        with ag.train_mode():
            got = drop(x).asnumpy()
        assert (got == 0).any() and set(np.unique(got)) <= {0.0, 2.0}
        with ag.record():
            assert (drop(x).asnumpy() == 0).any()
        with ag.record(train_mode=False):
            assert (drop(x).asnumpy() == 1).all()
        with ag.train_mode(), ag.predict_mode():
            assert (drop(x).asnumpy() == 1).all()
        with ag.train_mode():
            assert torch.equal(drop(torch.ones(4, 4)), torch.ones(4, 4))
        drop.train()
        assert (drop(torch.ones(64, 64)) == 0).any()


def test_sequential_lambda_and_flatten():
    with mx.cpu():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Flatten(), nn.HybridLambda("relu"),
                    nn.HybridLambda(lambda F, x: F.clip(x, 0, 1)),
                    nn.Identity())
        x = np.linspace(-2, 2, 24, dtype=np.float32).reshape(2, 3, 4)
        got = net(mx.nd.array(x)).asnumpy()
        assert got.shape == (2, 12)
        np.testing.assert_array_equal(got, np.clip(x.reshape(2, 12), 0, 1))
        lam = nn.Lambda(lambda x: x * 2)
        assert (lam(mx.nd.ones(3)).asnumpy() == 2).all()
        assert len(net) == 4 and isinstance(net[1], nn.HybridLambda)


def test_a_users_hybrid_forward_block_trains():
    """A block written as the reference's users write one: parameters
    from ``self.params.get`` in its name scope, ``hybrid_forward(F, x,
    weight)`` over NDArrays; it records, backprops and steps."""
    class Scale(nn.HybridBlock):
        def __init__(self, n, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.weight = self.params.get("weight", shape=(n,))

        def hybrid_forward(self, F, x, weight):
            return F.broadcast_mul(x, weight) + F.tanh(x)

    with mx.cpu():
        blk = Scale(3)
        blk.initialize(init=mx.init.One())
        assert list(blk.collect_params().keys()) == [blk.prefix + "weight"]
        tr = mx.gluon.Trainer(blk.collect_params(), "adam",
                              {"learning_rate": 0.1})
        x = mx.nd.array([[1.0, -2.0, 3.0]])
        with ag.record():
            y = (blk(x) ** 2).sum()
        y.backward()
        p = blk.collect_params()[blk.prefix + "weight"]
        want = 2 * (x.asnumpy() + np.tanh(x.asnumpy())) * x.asnumpy()
        np.testing.assert_allclose(p.grad().asnumpy(), want[0], rtol=1e-6)
        tr.step(1)
        # Adam's first step moves each weight by lr against its gradient
        np.testing.assert_allclose(p.data().asnumpy(),
                                   1 - 0.1 * np.sign(want[0]), rtol=1e-5)


# --------------------------------------------------------- parameters
def test_parameter_wraps_the_module_tensor():
    with mx.cpu():
        d = nn.Dense(3, in_units=2)
        p = d.collect_params()[d.prefix + "weight"]
        assert p.data()._data is d.weight
        p.set_data(np.ones((3, 2), np.float32))
        assert bool((d.weight == 1).all())
        p.lr_mult, p.wd_mult = 0.5, 0.0
        p.grad_req = "null"
        assert not d.weight.requires_grad
        with pytest.raises(MXNetError, match="grad_req='null'"):
            p.grad()
        p.grad_req = "add"
        assert d.weight.requires_grad
        d.cast("float64")
        assert p.dtype == np.float64 and d.weight.dtype == torch.float64


def test_block_zero_grad_and_grad_req_add():
    with mx.cpu():
        d = nn.Dense(2, in_units=2, use_bias=False)
        d.initialize(init=mx.init.One())
        p = d.collect_params()[d.prefix + "weight"]
        p.grad_req = "add"
        x = mx.nd.array([[1.0, 2.0]])
        for _ in range(2):
            with ag.record():
                y = d(x).sum()
            y.backward()
        assert p.grad().asnumpy().tolist() == [[2.0, 4.0], [2.0, 4.0]]
        d.zero_grad()
        assert not p.grad().asnumpy().any()


def test_initialize_skips_what_is_initialized_unless_forced():
    with mx.cpu():
        d = nn.Dense(2, in_units=2)
        d.initialize(init=mx.init.One())
        d.initialize(init=mx.init.Zero())
        assert bool((d.weight == 1).all())
        d.initialize(init=mx.init.Zero(), force_reinit=True)
        assert not bool(d.weight.any())


# ------------------------------------------------------------- losses
@pytest.mark.parametrize("i", range(len(LOSSES)),
                         ids=[f"{c}-{j}" for j, (c, _, _) in
                              enumerate(LOSSES)])
def test_losses_match_jax(ref, i):
    _, res, _ = ref
    cls, kw, args = LOSSES[i]
    x = _inputs()
    with mx.cpu():
        blk = getattr(gloss, cls)(**kw)
        got = blk(*[None if a is None else mx.nd.array(x[a])
                    for a in args])
    _close(got, res[f"loss{i}"], cls)


def test_losses_refuse_nothing_but_ctc():
    assert not hasattr(gloss, "CTCLoss")
    with pytest.raises(MXNetError):
        gloss.LogisticLoss(label_format="bogus")


# ------------------------------------------ serving a params file (CLI)
def test_serve_cli_serves_a_jax_params_file(ref):
    """``mxtpu-serve-torch --gen-model`` with a config whose ``"params"``
    is the JAX package's ``save_parameters`` file of ``gpt_tiny``: its
    greedy tokens equal those of an engine over the same weights loaded
    by name (``load_jax_params``)."""
    import re
    import signal
    import time
    import urllib.request
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.serving import GenerationEngine
    tmp, _, _ = ref
    arch = {"vocab_size": 64, "units": 64, "hidden_size": 128,
            "num_layers": 2, "num_heads": 2, "max_length": 128}
    cfg = tmp / "served.json"
    cfg.write_text(json.dumps(dict(arch, params="jax_gpt.params",
                                   max_slots=2, max_len=32)))
    with np.load(tmp / "jax_gpt_weights.npz") as z:
        weights = dict(z)
    net = gpt.GPTModel(dropout=0.0, device="cpu", **arch)
    load_jax_params(net, weights)
    eng = GenerationEngine(net, max_slots=2, max_len=32)
    prompt = [5, 9, 2, 33, 7]
    want = eng.generate(prompt, max_new_tokens=8)

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch._cli",
         "--gen-model", f"g={cfg}", "--device", "cpu", "--port", "0",
         "--host", "127.0.0.1", "--warmup"],
        env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stderr),
                              daemon=True)
    reader.start()
    try:
        port, deadline = None, time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)",
                          "".join(lines))
            port = int(m.group(1)) if m else None
            assert proc.poll() is None, "".join(lines)
            time.sleep(0.05)
        assert port, "".join(lines)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/g:generate",
            data=json.dumps({"tokens": prompt,
                             "max_new_tokens": 8}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert body["tokens"] == want, (body, want)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
