"""The port's ``nd`` (``ndarray/ndarray.py``, ``ndarray/ops.py``,
``ndarray/utils.py``, ``ndarray/random.py``) against the JAX package's on
the same numpy inputs, on the CPU.

Each case is a few lines over ``nd`` and the inputs that leave the result
in ``r``; the JAX side runs every case in one child interpreter (every
``MXNET_*`` variable unset) and writes the results to an ``.npz``; the
port runs them in-process under ``with mx.cpu():``.  Integer results
must be equal exactly, fp32 results within 1e-6 (relative and absolute);
shapes and dtypes must be equal.  The ``.params`` byte format is held to
the golden fixtures in ``tests/golden/``: loading ``list_v0|v1|v2`` gives
what the JAX package loads, and the writer reproduces ``list_v2.params``
byte for byte (the contract of ``test_golden.py``)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.base import MXNetError

ROOT = Path(__file__).resolve().parents[1]
GOLD = ROOT / "tests" / "golden"
TOL = 1e-6

CASES = {
    # creation
    "array_f64": "r = nd.array(a.astype(np.float64))",
    "array_i64": "r = nd.array(i.astype(np.int64))",
    "array_list": "r = nd.array([[1, 2], [3, 4]])",
    "array_dtype": "r = nd.array(a, dtype='int32')",
    "zeros": "r = nd.zeros((2, 3))",
    "ones_int": "r = nd.ones(4, dtype='int32')",
    "full": "r = nd.full((2, 2), 7.5)",
    "empty": "r = nd.zeros(nd.empty((3, 1)).shape)",
    "arange": "r = nd.arange(2, 11, 3)",
    "arange_stop": "r = nd.arange(5)",
    "arange_repeat": "r = nd.arange(0, 4, 1, repeat=2)",
    "concatenate": "r = nd.concatenate([nd.array(a), nd.array(b)], axis=1)",
    # arithmetic, scalars on either side, integer arrays
    "add": "r = nd.array(a) + nd.array(b)",
    "sub_scalar": "r = 2.5 - nd.array(a)",
    "mul_bcast": "r = nd.array(a) * nd.array(row)",
    "div": "r = nd.array(a) / nd.array(b)",
    "rdiv": "r = 1.0 / nd.array(pos)",
    "pow": "r = nd.array(pos) ** 1.5",
    "mod": "r = nd.array(a) % 0.7",
    "floordiv": "r = nd.array(a) // 0.3",
    "neg": "r = -nd.array(a)",
    "int_add": "r = nd.array(i) + nd.array(i)",
    "int_mul_scalar": "r = nd.array(i) * 3",
    "int_div": "r = nd.array(i) / 2",
    "int_mod": "r = nd.array(i) % 3",
    "eq": "r = nd.array(i) == 2",
    "gt": "r = nd.array(a) > nd.array(b)",
    "le_int": "r = nd.array(i) <= 1",
    "ne": "r = nd.array(a) != nd.array(a)",
    # in-place
    "iadd": "r = nd.array(a); r += nd.array(b); r *= 2; r -= 1; r /= 4",
    "iadd_int": "r = nd.array(i); r += 2",
    # reshape codes
    "reshape_0": "r = nd.array(c).reshape((0, -1))",
    "reshape_m2": "r = nd.array(c).reshape((4, -2))",
    "reshape_m3": "r = nd.array(c).reshape((-3, 0, 5))",
    "reshape_m4": "r = nd.array(c).reshape((-4, 2, -1, 0, 0, 0))",
    "reshape_m4b": "r = nd.array(c).reshape((0, -4, -1, 1, 0, 0))",
    "reshape_args": "r = nd.array(c).reshape(4, 30)",
    "reshape_shape_kw": "r = nd.array(c).reshape(shape=(-1, 5))",
    "reshape_reverse": "r = nd.reshape(nd.array(c), (-1, 0), reverse=True)",
    # indexing
    "getitem_int": "r = nd.array(c)[1]",
    "getitem_slices": "r = nd.array(c)[1:3, ::2]",
    "getitem_tuple": "r = nd.array(c)[:, 1, -1]",
    "getitem_nd": "r = nd.array(c)[nd.array([0, 2], dtype='int32')]",
    "setitem_int": "r = nd.array(c); r[1] = 0",
    "setitem_slice": "r = nd.array(c); r[:, 1] = nd.ones((4, 2, 5)) * 7",
    "setitem_all": "r = nd.array(a); r[:] = 3",
    "setitem_bcast": "r = nd.array(a); r[1:3] = nd.array(row)",
    "setitem_int_array": "r = nd.array(i); r[0] = 9.7",
    # conversion and copies
    "astype": "r = nd.array(a).astype('int32')",
    "astype_f16": "r = nd.array(a).astype('float16')",
    "copyto_nd": "r = nd.zeros(a.shape); nd.array(a).copyto(r)",
    "copyto_ctx": "r = nd.array(a).copyto(mx.cpu())",
    "as_in_context": "r = nd.array(a).as_in_context(mx.cpu())",
    "copy_indep": "x = nd.array(a); r = x.copy(); x[:] = 0",
    "detach": "r = nd.array(a).detach()",
    # ops the layers, losses and tests call
    "sum_axis": "r = nd.sum(nd.array(c), axis=(1, 3))",
    "sum_all": "r = nd.array(c).sum()",
    "sum_int": "r = nd.array(i).sum(axis=1)",
    "mean_keep": "r = nd.mean(nd.array(c), axis=2, keepdims=True)",
    "max": "r = nd.array(c).max(axis=0)",
    "min": "r = nd.min(nd.array(a), axis=1, keepdims=True)",
    "prod": "r = nd.prod(nd.array(pos), axis=(0, 1))",
    "argmax": "r = nd.argmax(nd.array(a), axis=1)",
    "argmin_flat": "r = nd.array(a).argmin()",
    "norm": "r = nd.norm(nd.array(a), axis=1)",
    "exp_log": "r = nd.log(nd.exp(nd.array(a)) + 1)",
    "sqrt_sq": "r = nd.sqrt(nd.square(nd.array(a)))",
    "unary": "r = nd.tanh(nd.array(a)) + nd.sigmoid(nd.array(a)) + "
             "nd.relu(nd.array(a)) + nd.abs(nd.array(a)) * nd.sign("
             "nd.array(a))",
    "softmax": "r = nd.softmax(nd.array(a), axis=-1)",
    "softmax_len": "r = nd.softmax(nd.array(a), axis=1, "
                   "length=nd.array([1, 3, 6, 2], dtype='int32'))",
    "log_softmax": "r = nd.log_softmax(nd.array(c), axis=1)",
    "softmax_temp": "r = nd.softmax(nd.array(a), temperature=2.0)",
    "pick": "r = nd.pick(nd.array(a), nd.array([0, 5, 7, 2]), axis=1)",
    "pick_keep": "r = nd.pick(nd.array(a), nd.array([1, 0, 3, 2]), "
                 "keepdims=True)",
    "one_hot": "r = nd.one_hot(nd.array([0, 3, 1]), 5, on_value=2.0, "
               "off_value=-1.0)",
    "dot": "r = nd.dot(nd.array(a), nd.array(b).T)",
    "dot_trans": "r = nd.dot(nd.array(a), nd.array(b), transpose_a=True)",
    "batch_dot": "r = nd.batch_dot(nd.array(c[0]), nd.array(c[1]), "
                 "transpose_b=True)",
    "clip": "r = nd.clip(nd.array(a), -0.5, 0.5)",
    "where": "r = nd.where(nd.array(a) > 0, nd.array(a), nd.array(b))",
    "concat": "r = nd.concat(nd.array(a), nd.array(b), dim=0)",
    "stack": "r = nd.stack(nd.array(a), nd.array(b), axis=1)",
    "split": "r = nd.stack(*nd.split(nd.array(c), 2, axis=0))",
    "split_squeeze": "r = nd.split(nd.array(a), 6, axis=1, "
                     "squeeze_axis=True)[4]",
    "slice_axis": "r = nd.slice_axis(nd.array(c), 2, 1, None)",
    "slice": "r = nd.slice(nd.array(c), (1, 0), (3, 2))",
    "take": "r = nd.take(nd.array(c), nd.array([[3, 0], [9, -1]]), axis=0)",
    "take_axis": "r = nd.take(nd.array(c), nd.array([1, 1]), axis=2)",
    "take_wrap": "r = nd.take(nd.array(a), nd.array([7, -1]), axis=1, "
                 "mode='wrap')",
    "broadcast_to": "r = nd.broadcast_to(nd.array(row), (3, 6))",
    "broadcast_like": "r = nd.broadcast_like(nd.array(row), nd.array(a))",
    "broadcast_axis": "r = nd.broadcast_axis(nd.array(row).reshape((1, "
                      "6)), axis=0, size=2)",
    "broadcast_ops": "r = nd.broadcast_maximum(nd.array(a), nd.array(row))"
                     " + nd.broadcast_minimum(nd.array(a), 0.1)",
    "zeros_like": "r = nd.zeros_like(nd.array(a)) + nd.ones_like("
                  "nd.array(b))",
    "expand_squeeze": "r = nd.squeeze(nd.expand_dims(nd.array(a), 1))",
    "transpose": "r = nd.transpose(nd.array(c), axes=(2, 0, 3, 1))",
    "T": "r = nd.array(a).T",
    "swapaxes": "r = nd.swapaxes(nd.array(c), 1, 3)",
    "flatten": "r = nd.flatten(nd.array(c))",
    "tile": "r = nd.tile(nd.array(row), (2, 2))",
    "repeat": "r = nd.repeat(nd.array(a), 2, axis=1)",
    "flip": "r = nd.flip(nd.array(c), axis=1)",
    "reshape_like": "r = nd.reshape_like(nd.array(c), nd.zeros((6, 20)))",
    "activation": "r = nd.Activation(nd.array(a), act_type='softrelu') + "
                  "nd.Activation(nd.array(a), act_type='softsign')",
    "gelu": "r = nd.gelu(nd.array(a))",
    "leaky": "r = nd.leaky_relu(nd.array(a), slope=0.2) + "
             "nd.leaky_relu(nd.array(a), act_type='elu', slope=0.5)",
    "cast": "r = nd.cast(nd.array(a), 'float16')",
    "stop_gradient": "r = nd.stop_gradient(nd.array(a))",
    "add_n": "r = nd.add_n(nd.array(a), nd.array(b), nd.array(a))",
    "fc": "r = nd.FullyConnected(nd.array(c), nd.array(w), nd.array(row),"
          " num_hidden=6)",
    "embedding": "r = nd.Embedding(nd.array([[0, 2], [3, 1]]), nd.array(b))",
    "matmul": "r = nd.array(a) @ nd.array(b).T",
}


def _inputs():
    rng = np.random.RandomState(3)
    return {"a": rng.randn(4, 6).astype(np.float32),
            "b": rng.randn(4, 6).astype(np.float32),
            "row": rng.randn(6).astype(np.float32),
            "pos": (rng.rand(4, 6) + 0.5).astype(np.float32),
            "i": rng.randint(-5, 6, (3, 4)).astype(np.int32),
            "c": rng.randn(4, 3, 2, 5).astype(np.float32),
            "w": rng.randn(6, 30).astype(np.float32)}


_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json, sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd

out = sys.argv[1]
cases = json.loads(open(out + "/cases.json").read())
with np.load(out + "/inputs.npz") as z:
    env0 = dict(z)
res, errs = {}, {}
for name, code in cases.items():
    env = dict(env0, nd=nd, mx=mx, np=np)
    try:
        exec(code, env)
        r = env["r"]
        res[name] = r.asnumpy() if hasattr(r, "asnumpy") else np.asarray(r)
    except Exception as e:
        errs[name] = repr(e)
golden = {}
for v in ("v0", "v1", "v2"):
    got = nd.load(sys.argv[2] + "/list_%s.params" % v)
    items = got.items() if isinstance(got, dict) else enumerate(got)
    for k, arr in items:
        res["gold_%s_%s" % (v, k)] = arr.asnumpy()
nd.save(out + "/jax.params", {"x": nd.array(env0["a"]),
                              "n": nd.array(env0["i"])})
np.savez(out + "/jax.npz", **res)
json.dump(errs, open(out + "/errs.json", "w"))
print("ok")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ndarray_ref")
    import json
    (tmp / "cases.json").write_text(json.dumps(CASES))
    np.savez(tmp / "inputs.npz", **_inputs())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp),
                           str(GOLD)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "jax.npz") as z:
        res = dict(z)
    return tmp, res, json.loads((tmp / "errs.json").read_text())


def _run(code):
    env = dict(_inputs(), nd=nd, mx=mx, np=np)
    with mx.cpu():
        exec(code, env)
    r = env["r"]
    return r.asnumpy() if hasattr(r, "asnumpy") else np.asarray(r)


def _same(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(ref, name):
    _, res, errs = ref
    assert name not in errs, errs.get(name)
    _same(_run(CASES[name]), res[name], name)


# ------------------------------------------------------ the byte format
@pytest.mark.parametrize("version", ["v0", "v1", "v2"])
def test_golden_files_load_as_jax_loads_them(ref, version):
    """The port's ``load`` of ``list_<version>.params`` gives the JAX
    package's values.  The v0 fixture holds a float64 chunk: the port
    keeps float64 where the JAX package (x64 off) holds float32; the
    values are equal."""
    _, res, _ = ref
    with mx.cpu():
        got = nd.load(str(GOLD / f"list_{version}.params"))
    items = got.items() if isinstance(got, dict) else enumerate(got)
    n = 0
    for k, arr in items:
        want = res[f"gold_{version}_{k}"]
        a = arr.asnumpy()
        if a.dtype == np.float64:
            assert want.dtype == np.float32
            a = a.astype(np.float32)
        _same(a, want, f"{version}/{k}")
        n += 1
    assert n == len([k for k in res if k.startswith(f"gold_{version}_")])


def test_golden_v2_keeps_names_and_order():
    with mx.cpu():
        d = nd.load(str(GOLD / "list_v2.params"))
    assert list(d.keys()) == ["w", "b", "idx", "small", "bytes"]
    assert [v.dtype for v in d.values()] == [
        np.float32, np.float16, np.int32, np.int8, np.uint8]


def test_writer_is_byte_exact_against_golden(tmp_path):
    sys.path.insert(0, str(GOLD))
    try:
        import make_golden
    finally:
        sys.path.pop(0)
    with mx.cpu():
        d = {k: nd.array(v, dtype=v.dtype)
             for k, v in make_golden.arrays_v2().items()}
    out = tmp_path / "roundtrip.params"
    nd.save(str(out), d)
    assert out.read_bytes() == (GOLD / "list_v2.params").read_bytes()


def test_jax_saved_file_loads_into_the_port(ref):
    tmp, _, _ = ref
    with mx.cpu():
        d = nd.load(str(tmp / "jax.params"))
    x = _inputs()
    _same(d["x"].asnumpy(), x["a"], "x")
    _same(d["n"].asnumpy(), x["i"], "n")


def test_save_load_roundtrip_list_and_bfloat16(tmp_path):
    with mx.cpu():
        arrs = [nd.array([[1.5, -2.0]]), nd.array([1, 2], dtype="int64"),
                nd.array([0.5, 3.0]).astype("bfloat16")]
        nd.save(str(tmp_path / "l.params"), arrs)
        back = nd.load_frombuffer((tmp_path / "l.params").read_bytes())
    assert isinstance(back, list) and len(back) == 3
    for a, b in zip(arrs, back):
        assert a._data.dtype == b._data.dtype
        assert torch.equal(a._data, b._data)


def test_load_refuses_sparse_and_bad_magic(tmp_path):
    p = tmp_path / "bad.params"
    p.write_bytes(b"\0" * 32)
    with pytest.raises(MXNetError, match="magic"):
        nd.load(str(p))
    with mx.cpu(), pytest.raises(MXNetError, match="sparse"):
        nd.load(str(GOLD / "list_sparse.params"))


# -------------------------------------------------------- the array
def test_default_context_is_the_card_and_cpu_scopes_it():
    with mx.cpu():
        assert nd.zeros(2).context == mx.cpu()
        assert mx.current_context() == mx.cpu()
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA"):
            nd.zeros(2)


def test_scalar_helpers_and_errors():
    with mx.cpu():
        x = nd.array([3.5])
        assert float(x) == 3.5 and int(x) == 3 and x.asscalar() == 3.5
        assert bool(nd.array([1.0])) and not bool(nd.array([0.0]))
        with pytest.raises(MXNetError):
            bool(nd.ones(2))
        with pytest.raises(MXNetError):
            nd.ones((2, 3)) + nd.ones((4, 5))
        assert len(nd.ones((4, 2))) == 4
        assert [v.asscalar() for v in nd.arange(3)] == [0.0, 1.0, 2.0]


def test_random_samplers_follow_the_seed():
    with mx.cpu():
        mx.random.seed(11)
        a = nd.random.uniform(-1, 1, (3, 4)).asnumpy()
        b = nd.random.normal(0, 2, (5,)).asnumpy()
        c = nd.random.randint(0, 7, (6,)).asnumpy()
        mx.random.seed(11)
        assert np.array_equal(a, nd.random.uniform(-1, 1, (3, 4)).asnumpy())
        assert np.array_equal(b, nd.random.normal(0, 2, (5,)).asnumpy())
        assert np.array_equal(c, nd.random.randint(0, 7, (6,)).asnumpy())
        assert nd.random.randn(2, 3).shape == (2, 3)
    assert a.min() >= -1 and a.max() < 1 and c.dtype == np.int32
    assert c.min() >= 0 and c.max() < 7


def test_ndarray_pickles_and_deep_copies():
    import copy
    import pickle
    with mx.cpu():
        x = nd.array([[1.0, 2.0]])
        y = pickle.loads(pickle.dumps(x))
        z = copy.deepcopy(x)
    assert torch.equal(x._data, y._data) and torch.equal(x._data, z._data)
    z[:] = 0
    assert x.asnumpy().tolist() == [[1.0, 2.0]]
