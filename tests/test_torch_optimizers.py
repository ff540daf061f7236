"""The port's eager optimizers and learning-rate schedulers against the
JAX package's, fp32 on the CPU.

* every scheduler's lr at a list of ``num_update`` values equals the JAX
  scheduler's (the same host arithmetic in Python doubles: exact);
* every optimizer the JAX package registers, driven through its
  ``Updater`` over 4 steps on the same seeded numpy weights and
  gradients of three leaves, with the gradient stages off, and on (wd,
  clip, rescale and a ``FactorScheduler``), and with each class's own
  options, leaves the same weights and states as the JAX class.  Bit for
  bit, except where a reduction is involved (LAMB and LARS norms,
  GroupAdaGrad's row mean): relative ``REDUCE_RTOL``.  SGLD's noise comes
  from another generator: its deterministic part and its noise's scale
  are held instead;
* every name the port refused before it was ported resolves, and
  multi-precision stays refused by name.

The JAX optimizers run in a child interpreter with every ``MXNET_*``
variable unset (the test file itself, run as a script), writing an
``.npz`` into ``tmp_path``; only the pure JAX schedulers run in-process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(4, 3), (5,), (2, 3, 2)]
STEPS = 4
REDUCE_RTOL = 1e-6      # norms and means sum in another order
STAGES = {"wd": 0.01, "clip_gradient": 0.05, "rescale_grad": 0.5}
SCHED = ("FactorScheduler", {"step": 2, "factor": 0.5})

# (name, kwargs, with a scheduler): kwargs are JSON, both sides build them
CASES = []
for _name, _own in [
        ("sgd", {}), ("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}),
        ("adam", {}), ("adamax", {}), ("nadam", {}), ("adagrad", {}),
        ("rmsprop", {}), ("rmsprop", {"centered": True,
                                      "clip_weights": 0.5}),
        ("adadelta", {}), ("ftrl", {}), ("ftml", {}), ("signum", {}),
        ("signum", {"momentum": 0.0}), ("lamb", {}),
        ("lamb", {"lower_bound": 0.1, "upper_bound": 0.5,
                  "bias_correction": False}),
        ("dcasgd", {}), ("dcasgd", {"momentum": 0.9}), ("lars", {}),
        ("lars", {"momentum": 0.0}), ("groupadagrad", {}), ("adamw", {}),
        ("test", {})]:
    CASES.append((_name, dict(_own), False))
    stages = dict(STAGES, **_own)
    if _name == "groupadagrad":
        stages.pop("wd")                # it refuses weight decay
    CASES.append((_name, stages, True))
REDUCING = ("lamb", "lars", "groupadagrad")


def _case_id(case):
    name, kw, sched = case
    return name + "-" + "-".join(f"{k}={v}" for k, v in sorted(kw.items())) \
        + ("-sched" if sched else "")


def _inputs():
    rng = np.random.RandomState(3)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
          for _ in range(STEPS)]
    return ws, gs


def _flat_state(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [a for x in s for a in _flat_state(x)]
    return [s.asnumpy()]


def run_cases(mx, sched_mod):
    """Every case through ``mx``'s optimizers (either package): {key:
    array} of the weights and flattened states after ``STEPS`` steps."""
    out = {}
    ws0, gs = _inputs()
    for c, (name, kw, sched) in enumerate(CASES):
        kw = dict(kw, learning_rate=0.01 if name != "ftrl" else 0.1)
        if sched:
            cls, skw = SCHED
            kw["lr_scheduler"] = getattr(sched_mod, cls)(**skw)
        opt = mx.optimizer.create(name, **kw)
        upd = mx.optimizer.get_updater(opt)
        ws = [mx.nd.array(w) for w in ws0]
        for s in range(STEPS):
            for i, w in enumerate(ws):
                upd(i, mx.nd.array(gs[s][i]), w)
        for i, w in enumerate(ws):
            out[f"{c}/w{i}"] = w.asnumpy()
            for j, a in enumerate(_flat_state(upd.states[i])):
                out[f"{c}/s{i}.{j}"] = a
    return out


def _jax_child(out_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu import lr_scheduler
    mx.random.seed(0)
    np.savez(out_path, **run_cases(mx, lr_scheduler))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_optimizers") / "ref.npz"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, __file__, "--jax", str(path)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port():
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import lr_scheduler
    with tmx.cpu():
        tmx.random.seed(0)
        return run_cases(tmx, lr_scheduler)


@pytest.mark.parametrize("c", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_optimizer_matches_jax(ref, port, c):
    name = CASES[c][0]
    keys = sorted(k for k in ref if k.startswith(f"{c}/"))
    assert keys and keys == sorted(k for k in port if k.startswith(f"{c}/"))
    for k in keys:
        got, want = port[k], ref[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if name in REDUCING:
            np.testing.assert_allclose(got, want, rtol=REDUCE_RTOL,
                                       atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_sgld_is_the_reference_step_plus_its_own_noise():
    """w' = w - lr/2 g + sqrt(lr) N(0, 1), the noise drawn from the
    weight's device generator: replaying the generator gives the same
    bits, and the noise has the scale sqrt(lr)."""
    import torch
    import incubator_mxnet_tpu_torch as tmx
    lr = 0.04
    rng = np.random.RandomState(5)
    w0 = rng.randn(256, 64).astype(np.float32)
    g = rng.randn(256, 64).astype(np.float32)
    with tmx.cpu():
        tmx.random.seed(11)
        w = tmx.nd.array(w0)
        opt = tmx.optimizer.create("sgld", learning_rate=lr)
        opt.update(0, w, tmx.nd.array(g), None)
        tmx.random.seed(11)
        noise = torch.randn(w0.shape, generator=tmx.random.generator("cpu"))
    want = (torch.from_numpy(w0) - lr / 2 * torch.from_numpy(g)
            + noise * torch.sqrt(torch.tensor(lr)))
    assert torch.equal(w._data, want)
    got_noise = w.asnumpy() - (w0 - np.float32(lr / 2) * g)
    assert abs(got_noise.std() / np.sqrt(lr) - 1) < 0.02


SCHEDULERS = [
    ("FactorScheduler", {"step": 3, "factor": 0.7, "base_lr": 0.1}),
    ("FactorScheduler", {"step": 2, "factor": 0.5, "stop_factor_lr": 0.01,
                         "base_lr": 0.2, "warmup_steps": 4,
                         "warmup_begin_lr": 0.001}),
    ("MultiFactorScheduler", {"step": [2, 5, 9], "factor": 0.3,
                              "base_lr": 0.05}),
    ("MultiFactorScheduler", {"step": [4, 6], "factor": 0.5, "base_lr": 0.1,
                              "warmup_steps": 3, "warmup_mode": "constant",
                              "warmup_begin_lr": 0.02}),
    ("PolyScheduler", {"max_update": 20, "base_lr": 0.1, "pwr": 2,
                       "final_lr": 0.001}),
    ("PolyScheduler", {"max_update": 20, "base_lr": 0.1, "pwr": 1,
                       "warmup_steps": 5, "warmup_begin_lr": 0.0}),
    ("CosineScheduler", {"max_update": 15, "base_lr": 0.1,
                         "final_lr": 0.002}),
    ("CosineScheduler", {"max_update": 15, "base_lr": 0.1, "warmup_steps": 4,
                         "warmup_begin_lr": 0.01}),
]
NUM_UPDATES = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 12, 15, 19, 20, 21, 30]


@pytest.mark.parametrize("cls,kw", SCHEDULERS,
                         ids=[f"{c}-{i}" for i, (c, _) in
                              enumerate(SCHEDULERS)])
def test_scheduler_matches_jax(cls, kw):
    from incubator_mxnet_tpu import lr_scheduler as jsched
    from incubator_mxnet_tpu_torch import lr_scheduler as tsched
    a, b = getattr(jsched, cls)(**kw), getattr(tsched, cls)(**kw)
    assert [b(n) for n in NUM_UPDATES] == [a(n) for n in NUM_UPDATES]


def test_scheduler_refusals_match_jax():
    from incubator_mxnet_tpu.base import MXNetError as JErr
    from incubator_mxnet_tpu_torch import lr_scheduler as tsched
    from incubator_mxnet_tpu_torch.base import MXNetError
    from incubator_mxnet_tpu import lr_scheduler as jsched
    for mod, err in ((jsched, JErr), (tsched, MXNetError)):
        with pytest.raises(err):
            mod.FactorScheduler(step=0)
        with pytest.raises(err):
            mod.MultiFactorScheduler(step=[3, 2])
        with pytest.raises(err):
            mod.LRScheduler(warmup_mode="cubic")


def test_every_formerly_refused_name_resolves():
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch.optimizer import optimizer as topt
    formerly = ("sgd", "nag", "adamax", "nadam", "adagrad", "rmsprop",
                "adadelta", "ftrl", "ftml", "signum", "signsgd", "lamb",
                "lars", "adamw", "groupadagrad", "sgld", "dcasgd", "test")
    for name in formerly:
        opt = tmx.optimizer.create(name)
        assert isinstance(opt, topt.Optimizer), name
    assert not hasattr(topt, "_NOT_PORTED")


def test_port_registers_every_name_the_jax_package_registers():
    from incubator_mxnet_tpu.optimizer import optimizer as jopt
    from incubator_mxnet_tpu_torch.optimizer import optimizer as topt
    assert set(jopt._REGISTRY) <= set(topt._REGISTRY)


@pytest.mark.parametrize("name", ["sgd", "adam", "lamb", "nag"])
def test_multi_precision_is_refused_by_name(name):
    """``multi_precision`` is ported (it was refused by name before): an
    fp16 weight's state is (its fp32 master, the rule's state for the
    master); any other dtype keeps the rule's own state, as the JAX
    optimizer's (fp16 only)."""
    import incubator_mxnet_tpu_torch as tmx
    opt = tmx.optimizer.create(name, multi_precision=True, momentum=0.9) \
        if name in ("sgd", "nag") else \
        tmx.optimizer.create(name, multi_precision=True)
    assert opt.multi_precision
    with tmx.cpu():
        w16 = tmx.nd.array(np.arange(6, dtype=np.float32) / 7,
                           dtype="float16")
        wbf = tmx.nd.array(np.arange(6, dtype=np.float32) / 7,
                           dtype="bfloat16")
    master, inner = opt.create_state_multi_precision(0, w16)
    assert master.dtype == np.float32
    assert np.array_equal(master.asnumpy(), w16.asnumpy().astype(np.float32))
    assert inner is not None
    st = opt.create_state_multi_precision(1, wbf)

    def kinds(state):
        if state is None:
            return None
        return [x.dtype for x in (state if isinstance(state, tuple)
                                  else (state,))]
    assert kinds(st) == kinds(opt.create_state(1, wbf))


def test_nd_exports_every_optimizer_op_of_the_jax_package():
    from incubator_mxnet_tpu.ndarray import optimizer_ops as jops
    import incubator_mxnet_tpu_torch as tmx
    for name in jops.__all__:
        assert callable(getattr(tmx.nd, name)), name


def test_mp_ops_are_refused_by_name():
    """The multi-precision ops are ported (they were refused by name
    before): the fp32 master steps from the gradient in fp32 and the fp16
    weight is the master rounded, term for term the reference's
    ``mp_sgd_update``/``mp_sgd_mom_update`` (held to the JAX ops in
    ``test_torch_half_training.py``)."""
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch.ndarray import optimizer_ops as oo
    rng = np.random.RandomState(5)
    w32 = rng.randn(7).astype(np.float32)
    g = rng.randn(7).astype(np.float16)
    with tmx.cpu():
        weight = tmx.nd.array(w32, dtype="float16")
        master = tmx.nd.array(w32)
        mom = tmx.nd.array(rng.randn(7).astype(np.float32) * 0.1)
        m0 = mom.asnumpy()
        oo.mp_sgd_update(weight, tmx.nd.array(g, dtype="float16"), master,
                         lr=0.1, wd=0.01)
        want = w32 - np.float32(0.1) * (g.astype(np.float32)
                                        + np.float32(0.01) * w32)
        assert np.array_equal(master.asnumpy(), want)
        assert np.array_equal(weight.asnumpy(), want.astype(np.float16))
        oo.mp_sgd_mom_update(weight, tmx.nd.array(g, dtype="float16"), mom,
                             master, lr=0.1, momentum=0.9)
        m1 = np.float32(0.9) * m0 - np.float32(0.1) * g.astype(np.float32)
        assert np.array_equal(mom.asnumpy(), m1)
        assert np.array_equal(master.asnumpy(), want + m1)
        assert np.array_equal(weight.asnumpy(),
                              (want + m1).astype(np.float16))


def test_ops_write_into_out_and_leave_the_weight():
    """``out=`` receives the new weight and the weight stays as it was,
    as the reference's ops."""
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch.ndarray import optimizer_ops as oo
    rng = np.random.RandomState(0)
    with tmx.cpu():
        w = tmx.nd.array(rng.randn(6).astype(np.float32))
        g = tmx.nd.array(rng.randn(6).astype(np.float32))
        out = tmx.nd.zeros((6,))
        keep = w.asnumpy().copy()
        oo.sgd_update(w, g, lr=0.1, wd=0.01, out=out)
        np.testing.assert_array_equal(w.asnumpy(), keep)
        oo.sgd_update(w, g, lr=0.1, wd=0.01)
        np.testing.assert_array_equal(out.asnumpy(), w.asnumpy())


def test_trainer_steps_the_lr_scheduler_per_update():
    """A scheduler in the Trainer's optimizer parameters is called with
    the update count at every step, as the reference's."""
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import autograd as ag
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.lr_scheduler import FactorScheduler
    with tmx.cpu():
        net = nn.Dense(2, in_units=3)
        net.initialize()
        sched = FactorScheduler(step=1, factor=0.5)
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.4, "lr_scheduler": sched})
        seen = []
        for _ in range(3):
            with ag.record():
                loss = (net(tmx.nd.ones((1, 3))) ** 2).sum()
            loss.backward()
            tr.step(1)
            seen.append(tr.learning_rate)
    assert seen == [0.4, 0.2, 0.1]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        _jax_child(sys.argv[2])
    else:
        print(json.dumps([_case_id(c) for c in CASES]))
