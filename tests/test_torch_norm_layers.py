"""The normalisation and concatenation layers of the port
(``ndarray/nn.py`` ``BatchNorm``, ``InstanceNorm``, ``GroupNorm``;
``gluon.nn`` ``BatchNorm``, ``InstanceNorm``, ``GroupNorm``,
``HybridConcatenate``, ``Concatenate``) against the JAX package, fp32 on
the CPU.

The JAX side runs in a child interpreter with every ``MXNET_*`` variable
unset: the three ops over a grid of numpy inputs and options (channel
axis 1 and -1, ``fix_gamma``, ``use_global_stats``, ``output_mean_var``;
InstanceNorm's eps; GroupNorm's group counts), and each layer, loaded
with this file's weights, over 3 recorded calls of a weighted-sum loss
(outputs, parameter gradients, running statistics after each call) and a
predict-mode call, then ``save_parameters``.  The port runs the same in
process, and loads the JAX files; a second child loads the port's
files into fresh JAX layers.

Tolerances (fp32, the two packages sum in different orders): every
array within 1e-5 of its largest magnitude and 1e-5 relative; a
parameter gradient within 1e-5 of its step's largest gradient.  Loading
a saved file: bit for bit."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as ag
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.gluon import nn

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5

# the ops' cases: (name, kwargs); the inputs are _inputs()'s
OP_CASES = [("BatchNorm", dict(axis=ax, fix_gamma=fg, use_global_stats=gs,
                               output_mean_var=om))
            for ax in (1, -1) for fg in (True, False)
            for gs in (False, True) for om in (False, True)] \
    + [("InstanceNorm", {}), ("InstanceNorm", dict(eps=1e-5))] \
    + [("GroupNorm", dict(num_groups=g)) for g in (1, 2, 4)]

# the layers both packages build: name -> (constructor source, input)
_LAYERS = r"""
def layers(nn):
    def cat(kind):
        c = kind(axis=-1)
        c.add(nn.Dense(2, flatten=False, in_units=5),
              nn.Dense(3, flatten=False, in_units=5))
        return c
    return {
        "bn1": nn.BatchNorm(axis=1, in_channels=3),
        "bnm1": nn.BatchNorm(axis=-1, momentum=0.8, scale=False,
                             in_channels=3),
        "bng": nn.BatchNorm(in_channels=3, use_global_stats=True),
        "in": nn.InstanceNorm(in_channels=3, scale=True),
        "gn": nn.GroupNorm(num_groups=3, in_channels=6),
        "hcat": cat(nn.HybridConcatenate),
        "cat": cat(nn.Concatenate),
    }
"""
LAYERS = ["bn1", "bnm1", "bng", "in", "gn", "hcat", "cat"]
X_SHAPES = {"bn1": (8, 3, 4), "bnm1": (8, 4, 3), "bng": (6, 3, 2),
            "in": (4, 3, 5), "gn": (4, 6, 5), "hcat": (4, 5), "cat": (4, 5)}
OUT_SHAPES = dict(X_SHAPES, hcat=(4, 5), cat=(4, 5))

_CHILD = _LAYERS + r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json, sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as ag
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon import nn

out_dir, mode = sys.argv[1], sys.argv[2]
inp = dict(np.load(out_dir + "/inputs.npz"))
cases = json.loads(open(out_dir + "/cases.json").read())
res = {}
if mode == "save":
    for i, (op, kw) in enumerate(cases):
        x = nd.array(inp["op_x%d" % i])
        args = [x] + [nd.array(inp["op_%s%d" % (k, i)])
                      for k in ("g", "b", "mm", "mv")
                      if "op_%s%d" % (k, i) in inp]
        r = getattr(nd, op)(*args, **kw)
        for j, a in enumerate(r if isinstance(r, (list, tuple)) else [r]):
            res["op%d/%d" % (i, j)] = a.asnumpy()
for name, blk in layers(nn).items():
    blk.initialize()
    params = blk._collect_params_with_prefix()
    if mode == "save":
        for k, p in params.items():
            p.set_data(inp["w/%s/%s" % (name, k)])
        for s in range(3):
            x = nd.array(inp["x/%s" % name] + s)
            with ag.record():
                y = blk(x)
                loss = (y * nd.array(inp["wy/%s" % name])).sum()
            loss.backward()
            res["%s/out%d" % (name, s)] = y.asnumpy()
            for k, p in params.items():
                if p.grad_req != "null":
                    res["%s/grad%d/%s" % (name, s, k)] = p.grad().asnumpy()
                res["%s/param%d/%s" % (name, s, k)] = p.data().asnumpy()
        blk.save_parameters(out_dir + "/jax_%s.params" % name)
    else:
        blk.load_parameters(out_dir + "/port_%s.params" % name)
        for k, p in params.items():
            res["%s/loaded/%s" % (name, k)] = p.data().asnumpy()
    res["%s/predict" % name] = blk(nd.array(inp["x/%s" % name])).asnumpy()
np.savez(out_dir + "/jax_%s.npz" % mode, **res)
print("ok")
"""


def _inputs():
    rng = np.random.RandomState(31)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    out = {}
    for i, (op, kw) in enumerate(OP_CASES):
        if op == "BatchNorm":
            shape = (4, 3, 5) if kw["axis"] == 1 else (4, 5, 3)
            c = 3
        else:
            shape, c = (2, 4, 3, 5), 4
        out[f"op_x{i}"] = f(*shape) * 2 + 0.5
        out[f"op_g{i}"] = f(c)
        out[f"op_b{i}"] = f(c)
        if op == "BatchNorm" and kw["use_global_stats"]:
            out[f"op_mm{i}"] = f(c)
            out[f"op_mv{i}"] = np.abs(f(c)) + 0.5
    w = {"bn1": {"gamma": 3, "beta": 3, "running_mean": 3,
                 "running_var": 3},
         "in": {"gamma": 3, "beta": 3}, "gn": {"gamma": 6, "beta": 6}}
    w["bnm1"] = w["bng"] = w["bn1"]
    w["hcat"] = w["cat"] = {"0.weight": (2, 5), "0.bias": 2,
                            "1.weight": (3, 5), "1.bias": 3}
    for name, ps in w.items():
        for k, s in ps.items():
            a = f(*(s if isinstance(s, tuple) else (s,)))
            out[f"w/{name}/{k}"] = np.abs(a) + 0.5 \
                if k == "running_var" else a
        out[f"x/{name}"] = f(*X_SHAPES[name]) * 1.5 + 0.5
        out[f"wy/{name}"] = f(*OUT_SHAPES[name])
    return out


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
        return dict(z)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("norm_ref")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    (tmp / "cases.json").write_text(json.dumps(OP_CASES))
    return tmp, inp, _child(tmp, "save")


def _close(got, want, what="", atol=None):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    if atol is None:
        atol = TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=atol, err_msg=what)


def _layers():
    ns = {}
    exec(_LAYERS, ns)
    with mx.cpu():
        return ns["layers"](nn)


def _run_layer(name, blk, inp):
    """3 recorded calls and a predict call of ``blk`` with this file's
    weights: {key: array} as the JAX child names them."""
    got = {}
    with mx.cpu():
        blk.initialize()
        params = blk._collect_params_with_prefix()
        for k, p in params.items():
            p.set_data(inp[f"w/{name}/{k}"])
        for s in range(3):
            with ag.record():
                y = blk(nd.array(inp[f"x/{name}"] + s))
                loss = (y * nd.array(inp[f"wy/{name}"])).sum()
            loss.backward()
            got[f"out{s}"] = y.asnumpy()
            for k, p in params.items():
                if p.grad_req != "null":
                    got[f"grad{s}/{k}"] = p.grad().asnumpy()
                got[f"param{s}/{k}"] = p.data().asnumpy()
        got["predict"] = blk(nd.array(inp[f"x/{name}"])).asnumpy()
    return got


# ---------------------------------------------------------------- ops
@pytest.mark.parametrize("i", range(len(OP_CASES)), ids=[
    op + "".join(f"-{k}{v}" for k, v in kw.items()) for op, kw in OP_CASES])
def test_norm_ops_match_jax(ref, i):
    """``nd.BatchNorm`` / ``InstanceNorm`` / ``GroupNorm`` on the same
    numpy inputs equal the JAX ops (every output of
    ``output_mean_var``)."""
    _, inp, res = ref
    op, kw = OP_CASES[i]
    with mx.cpu():
        args = [nd.array(inp[f"op_x{i}"])] + [
            nd.array(inp[f"op_{k}{i}"]) for k in ("g", "b", "mm", "mv")
            if f"op_{k}{i}" in inp]
        r = getattr(nd, op)(*args, **kw)
    outs = r if isinstance(r, (list, tuple)) else [r]
    want = sorted(k for k in res if k.startswith(f"op{i}/"))
    assert len(outs) == len(want)
    for j, a in enumerate(outs):
        _close(a, res[f"op{i}/{j}"], f"output {j}")


def test_batchnorm_op_keeps_the_moving_statistics():
    """The op returns the batch's biased statistics and never writes the
    moving ones (the layer does, through ``update_aux``)."""
    rng = np.random.RandomState(2)
    x = rng.randn(6, 3, 4).astype(np.float32)
    with mx.cpu():
        mm, mv = nd.zeros((3,)), nd.ones((3,))
        out, mean, var = nd.BatchNorm(nd.array(x), nd.ones((3,)),
                                      nd.zeros((3,)), mm, mv,
                                      fix_gamma=False, output_mean_var=True)
    np.testing.assert_allclose(mean.asnumpy(), x.mean(axis=(0, 2)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.asnumpy(), x.var(axis=(0, 2)),
                               rtol=1e-5, atol=1e-6)
    assert mm.asnumpy().tolist() == [0.0] * 3
    assert mv.asnumpy().tolist() == [1.0] * 3
    with mx.cpu(), pytest.raises(mx.MXNetError, match="moving_mean"):
        nd.BatchNorm(nd.array(x), nd.ones((3,)), nd.zeros((3,)),
                     use_global_stats=True)


# ------------------------------------------------------------- layers
@pytest.mark.parametrize("name", LAYERS)
def test_layers_match_jax(ref, name):
    """Each layer over 3 recorded calls: outputs, parameter gradients and
    the parameters after each call (running statistics moved while
    training, by ``momentum``), then a predict-mode call, equal JAX's."""
    _, inp, res = ref
    got = _run_layer(name, _layers()[name], inp)
    for k, v in got.items():
        want = res[f"{name}/{k}"]
        if k.startswith("grad"):
            step = k.split("/")[0]
            top = max(float(np.abs(a).max()) for n, a in res.items()
                      if n.startswith(f"{name}/{step}/"))
            _close(v, want, k, atol=TOL * top)
        else:
            _close(v, want, k)
    assert set(got) == {k[len(name) + 1:] for k in res
                        if k.startswith(name + "/")}


def test_layers_hybridized_equal_eager(ref):
    """Each layer hybridized gives the eager layer's numbers bit for bit
    (on the CPU a key binds the eager body), running statistics
    included."""
    _, inp, _ = ref
    eager = {n: _run_layer(n, b, inp) for n, b in _layers().items()}
    blocks = _layers()
    for name, blk in blocks.items():
        if isinstance(blk, nn.HybridBlock):
            blk.hybridize()
        got = _run_layer(name, blk, inp)
        for k, v in got.items():
            np.testing.assert_array_equal(v, eager[name][k], err_msg=k)


def test_layer_names_and_grad_reqs():
    """The reference's parameter names and order, and which take a
    gradient: no gamma gradient without ``scale``, none for the running
    statistics, which the initializers set to 0 and 1."""
    with mx.cpu():
        bn = nn.BatchNorm(scale=False, in_channels=2, prefix="b_")
        inst = nn.InstanceNorm(in_channels=2, prefix="i_")
        gn = nn.GroupNorm(in_channels=2, prefix="g_")
        for b in (bn, inst, gn):
            b.initialize(init=mx.init.Normal(5.0))
    assert [(k, p.grad_req) for k, p in bn.collect_params().items()] == [
        ("b_gamma", "null"), ("b_beta", "write"),
        ("b_running_mean", "null"), ("b_running_var", "null")]
    assert [p.grad_req for p in inst.collect_params().values()] \
        == ["null", "write"]
    assert [p.grad_req for p in gn.collect_params().values()] \
        == ["write", "write"]
    vals = [p.data().asnumpy().tolist() for p in bn.collect_params().values()]
    assert vals == [[1.0, 1.0], [0.0, 0.0], [0.0, 0.0], [1.0, 1.0]]


def test_batchnorm_tensor_calls_follow_the_module_mode():
    """Called with tensors, BatchNorm follows the module's ``training``
    flag, as Dropout does: eval normalises with the running statistics
    and moves nothing."""
    import torch
    with mx.cpu():
        bn = nn.BatchNorm(in_channels=3)
        bn.initialize()
        x = torch.randn(5, 3, 2, generator=torch.Generator().manual_seed(0))
        bn.eval()
        out = bn(x)
        assert torch.allclose(out, x / torch.sqrt(torch.tensor(1 + 1e-5)),
                              rtol=1e-6, atol=0)
        assert bn.running_mean.tolist() == [0.0] * 3
        bn.train()
        bn(x)
        assert bn.running_mean.abs().sum() > 0


# ------------------------------------------------------- save / load
@pytest.mark.parametrize("name", LAYERS)
def test_jax_save_parameters_loads_into_the_port(ref, name):
    tmp, inp, res = ref
    blk = _layers()[name]
    with mx.cpu():
        blk.load_parameters(str(tmp / f"jax_{name}.params"))
        for k, p in blk._collect_params_with_prefix().items():
            np.testing.assert_array_equal(p.data().asnumpy(),
                                          res[f"{name}/param2/{k}"], k)
        _close(blk(nd.array(inp[f"x/{name}"])), res[f"{name}/predict"])


def test_port_save_parameters_loads_into_jax(ref):
    tmp, inp, _ = ref
    mine = {}
    for name, blk in _layers().items():
        got = _run_layer(name, blk, inp)
        with mx.cpu():
            blk.save_parameters(str(tmp / f"port_{name}.params"))
        mine[name] = (got, blk)
    res = _child(tmp, "load")
    for name, (got, blk) in mine.items():
        for k, p in blk._collect_params_with_prefix().items():
            np.testing.assert_array_equal(res[f"{name}/loaded/{k}"],
                                          p.data().asnumpy(), k)
        _close(got["predict"], res[f"{name}/predict"], name)
