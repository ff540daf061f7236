"""The port's ``autograd`` (over ``torch.autograd``) against the JAX
package's tape, on the CPU.

Each scenario is a few lines over ``nd`` and ``ag`` that leave a dict of
results in ``r`` (arrays, flags, or the name of the error raised); the
JAX side runs every scenario in one child interpreter (every ``MXNET_*``
variable unset) and writes the results to a JSON file; the port runs them
in-process under ``with mx.cpu():``.  Values within 1e-6 (relative and
absolute, fp32), flags and errors equal."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as ag
from incubator_mxnet_tpu_torch import nd

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6

_PRELUDE = r"""
def val(a):
    return a.asnumpy().tolist()

def err(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return None

x0 = [[0.5, -1.25, 2.0], [1.5, 0.25, -0.75]]
"""

SCENARIOS = {
    "modes": """
r = {"outside": [ag.is_recording(), ag.is_training()]}
with ag.record():
    r["record"] = [ag.is_recording(), ag.is_training()]
    with ag.pause():
        r["pause"] = [ag.is_recording(), ag.is_training()]
        with ag.train_mode():
            r["pause_train"] = [ag.is_recording(), ag.is_training()]
    with ag.predict_mode():
        r["predict"] = [ag.is_recording(), ag.is_training()]
with ag.record(train_mode=False):
    r["record_predict"] = [ag.is_recording(), ag.is_training()]
r["after"] = [ag.is_recording(), ag.is_training()]
""",
    "write": """
x = nd.array(x0); x.attach_grad()
for k in range(2):
    with ag.record():
        y = (x * x * (k + 2)).sum()
    y.backward()
r = {"grad": val(x.grad), "req": x.grad_req}
""",
    "add": """
x = nd.array(x0); x.attach_grad("add")
for k in range(2):
    with ag.record():
        y = (x * x * (k + 2)).sum()
    y.backward()
r = {"grad": val(x.grad)}
""",
    "null": """
x = nd.array(x0); x.attach_grad("null")
with ag.record():
    y = (x * x).sum()
r = {"grad_none": x.grad is None, "err": err(y.backward)}
""",
    "not_recorded": """
x = nd.array(x0); x.attach_grad()
y = (x * x).sum()
r = {"err": err(y.backward), "grad": val(x.grad)}
""",
    "paused_op": """
x = nd.array(x0); x.attach_grad()
with ag.record():
    a = x * 3
    with ag.pause():
        b = x * x
    y = (a + b).sum()
y.backward()
r = {"grad": val(x.grad)}
""",
    "retain_graph": """
x = nd.array(x0); x.attach_grad("add")
with ag.record():
    y = (nd.exp(x) * x).sum()
y.backward(retain_graph=True)
y.backward()
r = {"grad": val(x.grad), "err": err(y.backward)}
""",
    "head_grad": """
x = nd.array(x0); x.attach_grad()
with ag.record():
    y = nd.tanh(x) * 2
y.backward(nd.array([[1, 2, 3], [-1, 0.5, 0]]))
r = {"grad": val(x.grad)}
""",
    "two_vars_bcast": """
x = nd.array(x0); x.attach_grad()
w = nd.array([0.3, -0.2, 1.1]); w.attach_grad()
with ag.record():
    h = nd.dot(x * w + nd.sin(x), nd.array([[1.0], [2.0], [-1.0]]))
    y = nd.log_softmax(h.reshape((1, -1)), axis=-1).sum() + (w ** 2).sum()
y.backward()
r = {"gx": val(x.grad), "gw": val(w.grad), "y": val(y)}
""",
    "grad_fn": """
x = nd.array(x0); x.attach_grad()
with ag.record():
    y = (x * x * x).sum()
g = ag.grad(y, x)
r = {"g": val(g), "x_grad": val(x.grad)}
""",
    "second_order": """
x = nd.array(x0); x.attach_grad()
with ag.record():
    y = (x * x * x).sum()
    gx = ag.grad(y, x, create_graph=True)
    z = (gx * gx).sum()
z.backward()
r = {"gx": val(gx), "x_grad": val(x.grad)}
""",
    "grad_list": """
x = nd.array(x0); x.attach_grad()
v = nd.array([[2.0], [3.0]]); v.attach_grad()
with ag.record():
    y = (nd.sigmoid(x) * v).sum()
gs = ag.grad([y], [x, v])
r = {"gx": val(gs[0]), "gv": val(gs[1])}
""",
    "function": """
class Sq(ag.Function):
    def forward(self, a):
        self.save_for_backward(a)
        return a * a
    def backward(self, dy):
        a, = self.saved_tensors
        return dy * 2 * a + 1
x = nd.array(x0); x.attach_grad()
with ag.record():
    y = (Sq()(x) * 3).sum()
y.backward()
out = Sq()(nd.array(x0))
r = {"grad": val(x.grad), "fwd": val(out)}
""",
    "mark_variables": """
x = nd.array(x0)
g = nd.zeros((2, 3))
ag.mark_variables([x], [g], "add")
for _ in range(2):
    with ag.record():
        y = (nd.relu(x) * 5).sum()
    y.backward()
r = {"g": val(g), "same": x.grad is g}
""",
    "setitem_cuts_history": """
x = nd.array(x0); x.attach_grad()
with ag.record():
    y = x * 2
z = y.copy()
y[:] = 7
with ag.record():
    w = (y * x).sum()
w.backward()
r = {"grad": val(x.grad), "y": val(y)}
""",
    "int_ops_not_differentiated": """
x = nd.array(x0); x.attach_grad()
with ag.record():
    i = nd.argmax(x, axis=1)
    y = (nd.pick(x, i) * 2).sum() + nd.one_hot(i, 3).sum()
y.backward()
r = {"grad": val(x.grad), "i": val(i)}
""",
}

_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json, sys
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as ag
from incubator_mxnet_tpu import nd
scen = json.loads(open(sys.argv[1] + "/scen.json").read())
out = {}
for name, code in scen["cases"].items():
    env = {"nd": nd, "ag": ag, "mx": mx}
    exec(scen["prelude"], env)
    exec(code, env)
    out[name] = env["r"]
json.dump(out, open(sys.argv[1] + "/jax.json", "w"))
print("ok")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("autograd_ref")
    (tmp / "scen.json").write_text(json.dumps(
        {"prelude": _PRELUDE, "cases": SCENARIOS}))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp)], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((tmp / "jax.json").read_text())


def _run(code):
    env = {"nd": nd, "ag": ag, "mx": mx}
    exec(_PRELUDE, env)
    with mx.cpu():
        exec(code, env)
    return json.loads(json.dumps(env["r"]))


def _same(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, float)) and not (
            isinstance(want, list) and want and isinstance(want[0], bool)):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=TOL,
                                   atol=TOL, err_msg=what)
    else:
        assert got == want, (what, got, want)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autograd_matches_jax(ref, name):
    _same(_run(SCENARIOS[name]), ref[name], name)


def test_recording_sets_torch_grad_mode_and_restores_it():
    """``record()`` turns torch's grad mode on for its scope and
    ``pause()`` off; both restore it, and ops outside ``record()`` build
    no graph even on a variable."""
    with mx.cpu():
        x = nd.array([1.0, 2.0])
        x.attach_grad()
        with torch.no_grad():
            with ag.record():
                assert torch.is_grad_enabled()
                with ag.pause():
                    assert not torch.is_grad_enabled()
                assert torch.is_grad_enabled()
            assert not torch.is_grad_enabled()
        assert torch.is_grad_enabled()
        assert not (x * 2)._data.requires_grad
        with ag.record():
            assert (x * 2)._data.requires_grad


def test_gradient_buffer_keeps_its_address():
    """Each backward writes into the same buffer (K8's leaf table and a
    captured graph hold its address)."""
    with mx.cpu():
        x = nd.array([[1.0, 2.0]])
        x.attach_grad()
        ptrs = []
        for _ in range(3):
            with ag.record():
                y = (x * x).sum()
            y.backward()
            ptrs.append(x.grad._data.data_ptr())
    assert len(set(ptrs)) == 1
