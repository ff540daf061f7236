"""The Gluon ``Trainer`` on a 16-bit net: its fused update
(``FusedUpdater``: K8, K9 or their plain versions) against its
``fused=False`` loop (the eager optimizer per parameter), bit for bit,
for every rule the fused path takes but LAMB (no 16-bit K10 yet); and the
eager ``AdamW`` at bf16 against the JAX package's eager ``AdamW``, bit
for bit.  Its bias corrections 1 - beta^t divide as weak-typed constants
there (bf16 divisions); the port's divided by fp32 tensors, which
promoted the step to fp32 and left it off both.

The JAX side runs in a child interpreter (every ``MXNET_*`` variable
unset), writing an ``.npz`` into ``tmp_path``."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as ag
from incubator_mxnet_tpu_torch.models import gpt

ROOT = Path(__file__).resolve().parents[1]
V, B, T = 64, 2, 8
RULES = [("adam", {}), ("adamw", {"wd": 0.01}), ("sgd", {}),
         ("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}),
         ("rmsprop", {}), ("adagrad", {"wd": 0.01})]


def _net(dtype):
    mx.random.seed(0)
    net = gpt.gpt_tiny(vocab_size=V, units=32, hidden_size=64,
                       max_length=T, dropout=0.0, prefix="fl_")
    net.initialize(init=mx.init.Normal(0.02))
    net.cast(dtype)
    return net


def _step(net, trainer, i):
    x = np.random.RandomState(200 + i).randint(0, V, (B, T + 1))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with ag.record():
        out = net(mx.nd.array(x[:, :-1], dtype="int32"))
        L = loss_fn(out.reshape((-1, V)), mx.nd.array(
            x[:, 1:].reshape(-1).astype(np.float32))).mean()
    L.backward()
    trainer.step(1)
    return float(L.asnumpy())


def _same(x, y):
    """Equal element for element, NaN where the other is NaN (fp16's
    epsilon is 0: an Adam step may divide 0 by 0 in both)."""
    return x.dtype == y.dtype and bool(
        ((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("rule,opts", RULES,
                         ids=[f"{r}{'_' + '_'.join(o) if o else ''}"
                              for r, o in RULES])
def test_fused_update_equals_the_loop_at_16_bits(rule, opts, dtype):
    """Three steps of a cast GPT: the fused trainer's losses, weights and
    optimizer states equal the ``fused=False`` trainer's bit for bit (NaN
    where the other is NaN)."""
    with mx.cpu():
        runs = []
        for fused in (True, False):
            net = _net(dtype)
            tr = mx.gluon.Trainer(net.collect_params(), rule,
                                  dict({"learning_rate": 1e-3}, **opts),
                                  fused=fused)
            losses = [_step(net, tr, i) for i in range(3)]
            runs.append((losses, net, tr))
        (la, na, ta), (lb, nb, tb) = runs
        assert ta._fused is not None and tb._fused is None
        assert _same(torch.tensor(la), torch.tensor(lb))
        for (k, p), q in zip(na.collect_params().items(),
                             nb.collect_params().values()):
            assert p.data()._data.dtype == getattr(torch, dtype), k
            assert _same(p.data()._data, q.data()._data), k
        from incubator_mxnet_tpu_torch.optimizer import fused as fmod
        for i, st in ta._updaters.states.items():
            a = fmod._state_list(st)
            b = fmod._state_list(tb._updaters.states[i])
            assert all(_same(x._data, y._data) for x, y in zip(a, b))


_CHILD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import incubator_mxnet_tpu as mx
d = np.load(sys.argv[1])
o = mx.optimizer.create("adamw", learning_rate=1e-3, wd=0.01)
w = mx.nd.array(d["w"]).astype("bfloat16")
u = mx.optimizer.get_updater(o)
for g in d["g"]:
    u(0, mx.nd.array(g).astype("bfloat16"), w)
np.savez(sys.argv[2], w=np.asarray(w.astype("float32").asnumpy()))
"""


def test_eager_adamw_at_bf16_matches_jax(tmp_path):
    """Four eager ``AdamW`` steps of a bf16 weight, wd 0.01: the JAX
    package's and the port's weights are equal bit for bit."""
    rng = np.random.RandomState(0)
    w0 = (rng.randn(4096) * 0.02).astype(np.float32)
    gs = (rng.randn(4, 4096) * 1e-3).astype(np.float32)
    np.savez(tmp_path / "in.npz", w=w0, g=gs)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MXNET_")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", _CHILD,
                           str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")["w"]
    with mx.cpu():
        o = mx.optimizer.create("adamw", learning_rate=1e-3, wd=0.01)
        w = mx.nd.array(w0).astype("bfloat16")
        u = mx.optimizer.get_updater(o)
        for g in gs:
            u(0, mx.nd.array(g).astype("bfloat16"), w)
        got = w.astype("float32").asnumpy()
    assert np.array_equal(got, want), int((got != want).sum())
