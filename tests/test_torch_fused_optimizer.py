"""The port's whole-tree update (``optimizer/fused.py``) for every rule the
JAX package fuses, fp32 on the CPU, and its kernels K9 and K10 on the
card.

* ``FusedUpdater`` on the JAX package's ``FUSED_CONFIGS``
  (tests/test_fused_optimizer.py), and on LAMB with bounds of 0 and below
  (the reference clamps only at a bound > 0), over 4 ``gluon.Trainer``
  steps equals
  the port's per-parameter loop (``fused=False``) bit for bit, and the
  JAX ``Trainer``'s weights and states within ``JAX_RTOL`` (the two
  frameworks' Dense forward and backward sum in other orders; the JAX
  package's own fused-vs-loop tolerance is 2e-6);
* an optimizer outside the seven rules (AdaDelta), a centered RMSProp:
  the per-parameter fallback, equal to ``fused=False`` bit for bit;
* ``functional_twin`` against the JAX package's, over 3 updates of raw
  arrays (in-process: pure functions) within ``TWIN_RTOL`` (the bias
  corrections are fp32 powers of the step on the device), and its
  refusals;
* the ``skip_nonfinite`` guard under each rule: a poisoned step leaves
  every weight and state bit for bit, zeroes the gradients and is
  counted once;
* on the card (``cuda``-marked, skipped without one): K9 per rule ==
  its plain loop bit for bit, gradient stages off and on, on leaves of
  ragged and unaligned sizes; K10's m and v == its plain loop bit for
  bit, its weights within ``K10_RTOL`` of each leaf's largest magnitude
  (its norms sum in another order), and two runs bit-equal; the guarded
  kernels write only zero gradients.

The JAX side's Trainers run in a child interpreter (this file run as a
script) with every ``MXNET_*`` variable unset, writing an ``.npz`` into
``tmp_path``."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
STEPS = 4
JAX_RTOL, JAX_ATOL = 2e-5, 1e-6
TWIN_RTOL = 1e-6
K10_RTOL = 1e-6
# tests/test_fused_optimizer.py FUSED_CONFIGS, copied
FUSED_CONFIGS = [
    ("sgd", {"learning_rate": 0.05}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "wd": 1e-4}),
    ("adagrad", {"learning_rate": 0.05, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01, "clip_gradient": 0.1}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
             "clip_gradient": 0.05}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01,
              "bias_correction": False}),
]
# LAMB bounds that are given but not > 0: the reference clamps ||w|| only
# where a bound is > 0, so these equal the unbounded update
BOUND_CONFIGS = [
    ("lamb", {"learning_rate": 0.01, "wd": 0.01, "lower_bound": 0.0,
              "upper_bound": 0.0}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01, "lower_bound": -1.0,
              "upper_bound": 0.5}),
]
CONFIGS = FUSED_CONFIGS + BOUND_CONFIGS
IDS = [f"{o}-{i}" for i, (o, _) in enumerate(CONFIGS)]


def _data():
    rng = np.random.RandomState(7)
    return (rng.randn(5, 6).astype(np.float32),
            rng.randn(5, 3).astype(np.float32))


def _flat_state(s):
    if s is None:
        return []
    if isinstance(s, tuple):
        return [a for x in s for a in _flat_state(x)]
    return [s.asnumpy()]


def _jax_child(out_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu import autograd as ag
    from incubator_mxnet_tpu.gluon import Trainer, nn
    out = {}
    x, y = _data()
    for c, (name, kw) in enumerate(CONFIGS):
        mx.random.seed(7)
        net = nn.Sequential()
        net.add(nn.Dense(8, activation="relu"), nn.Dense(3))
        net.initialize()
        xs, ys = mx.nd.array(x), mx.nd.array(y)
        net(xs)
        for i, p in enumerate(net.collect_params().values()):
            out[f"{c}/init{i}"] = p.data().asnumpy()
        tr = Trainer(net.collect_params(), name, dict(kw))
        loss_fn = mx.gluon.loss.L2Loss()
        for _ in range(STEPS):
            with ag.record():
                loss = loss_fn(net(xs), ys)
            loss.backward()
            tr.step(5)
        for i, p in enumerate(net.collect_params().values()):
            out[f"{c}/w{i}"] = p.data().asnumpy()
        for i in sorted(tr._updaters.states):
            for j, a in enumerate(_flat_state(tr._updaters.states[i])):
                out[f"{c}/s{i}.{j}"] = a
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_fused") / "ref.npz"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, __file__, "--jax", str(path)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def _net(init=None):
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch.gluon import nn
    tmx.random.seed(7)
    net = nn.Sequential()
    net.add(nn.Dense(8, in_units=6, activation="relu"),
            nn.Dense(3, in_units=8))
    net.initialize()
    if init is not None:
        for p, a in zip(net.collect_params().values(), init):
            p.set_data(a)
    return net


def _train(name, kw, fused, init=None, steps=STEPS, skip_nonfinite=None):
    """The port's Trainer over ``steps`` steps of the test's batch:
    (weights, flattened states, trainer)."""
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import autograd as ag
    x, y = _data()
    with tmx.cpu():
        net = _net(init)
        tr = tmx.gluon.Trainer(net.collect_params(), name, dict(kw),
                               fused=fused, skip_nonfinite=skip_nonfinite)
        loss_fn = tmx.gluon.loss.L2Loss()
        xs, ys = tmx.nd.array(x), tmx.nd.array(y)
        for _ in range(steps):
            with ag.record():
                loss = loss_fn(net(xs), ys)
            loss.backward()
            tr.step(5)
        ws = [p.data().asnumpy() for p in net.collect_params().values()]
        sts = [_flat_state(tr._updaters.states[i])
               for i in sorted(tr._updaters.states)]
    return ws, sts, tr


@pytest.mark.parametrize("c", range(len(CONFIGS)), ids=IDS)
def test_fused_matches_loop_bit_for_bit(c):
    name, kw = CONFIGS[c]
    fw, fs, ftr = _train(name, kw, True)
    lw, ls, ltr = _train(name, kw, False)
    assert ftr._fused is not None and ltr._fused is None
    for a, b in zip(fw, lw):
        np.testing.assert_array_equal(a, b)
    assert [len(s) for s in fs] == [len(s) for s in ls]
    for sa, sb in zip(fs, ls):
        for a, b in zip(sa, sb):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("c", range(len(CONFIGS)), ids=IDS)
def test_fused_matches_the_jax_trainer(ref, c):
    name, kw = CONFIGS[c]
    init = [ref[f"{c}/init{i}"] for i in range(4)]
    ws, sts, _ = _train(name, kw, True, init=init)
    for i, w in enumerate(ws):
        np.testing.assert_allclose(w, ref[f"{c}/w{i}"], rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=f"w{i}")
    keys = sorted(k for k in ref if k.startswith(f"{c}/s"))
    assert len(keys) == sum(len(s) for s in sts)
    for i, st in enumerate(sts):
        for j, a in enumerate(st):
            np.testing.assert_allclose(a, ref[f"{c}/s{i}.{j}"],
                                       rtol=JAX_RTOL, atol=JAX_ATOL,
                                       err_msg=f"s{i}.{j}")


@pytest.mark.parametrize("name,kw", [
    ("adadelta", {}), ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    ("rmsprop", {"learning_rate": 0.01, "clip_weights": 0.2}),
    ("ftml", {}), ("signum", {})])
def test_fallback_outside_the_rules_equals_the_loop(name, kw):
    fw, fs, ftr = _train(name, kw, True)
    lw, ls, _ = _train(name, kw, False)
    assert ftr._fused is not None
    handled, flag = ftr._fused.step(ftr._updatable, guard=False)
    assert handled is False and flag is None
    for a, b in zip(fw, lw):
        np.testing.assert_array_equal(a, b)
    for sa, sb in zip(fs, ls):
        for a, b in zip(sa, sb):
            np.testing.assert_array_equal(a, b)


def test_fused_dispatches_one_group_per_lr_and_wd():
    """Biases take wd_mult 0: two groups of (lr, wd) for SGD with wd."""
    from incubator_mxnet_tpu_torch import telemetry
    _train("sgd", {"learning_rate": 0.1, "wd": 0.01, "momentum": 0.5},
           True, steps=1)
    assert telemetry.gauge("mxtpu_optimizer_dispatches_per_step").value \
        in (1, 2)


TWINS = [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}),
    ("sgd", {"learning_rate": 0.05}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
             "clip_gradient": 0.3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3, "rescale_grad": 0.5}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "wd": 1e-4}),
    ("adagrad", {"learning_rate": 0.05, "wd": 1e-3}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}),
]


@pytest.mark.parametrize("name,kw", TWINS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(TWINS)])
def test_functional_twin_matches_jax(name, kw):
    import jax.numpy as jnp
    import torch
    from incubator_mxnet_tpu import optimizer as jopt
    from incubator_mxnet_tpu.optimizer.fused import functional_twin as jtwin
    from incubator_mxnet_tpu_torch import optimizer as topt
    rng = np.random.RandomState(2)
    shapes = [(4, 3), (7,)]
    w0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rng.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(3)]
    jf = jtwin(jopt.create(name, **kw))
    tf = topt.functional_twin(topt.create(name, **kw))
    assert tf.elementwise == jf.elementwise
    jw = [jnp.asarray(w) for w in w0]
    tw = [torch.from_numpy(w.copy()) for w in w0]
    jst, tst = jf.init(jw), tf.init(tw)
    for s in range(3):
        jw, jst = jf.update(jw, [jnp.asarray(g) for g in gs[s]], jst,
                            jnp.asarray(s + 1, jnp.int32))
        tf.update(tw, [torch.from_numpy(g) for g in gs[s]], tst,
                  torch.tensor(s + 1, dtype=torch.int32))
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TWIN_RTOL,
                                   atol=1e-8)
    assert sorted(tst) == sorted(jst)
    for key in tst:
        for a, b in zip(tst[key], jst[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=TWIN_RTOL, atol=1e-8)


@pytest.mark.parametrize("name,kw", [
    ("adadelta", {}),
    ("sgd", {"lr_scheduler": "factor"}),
    ("rmsprop", {"centered": True}),
    ("rmsprop", {"clip_weights": 0.5}),
    ("lamb", {"lower_bound": 0.1}),
    ("lamb", {"bias_correction": False}),
])
def test_functional_twin_refusals(name, kw):
    from incubator_mxnet_tpu_torch import optimizer as topt
    from incubator_mxnet_tpu_torch.base import MXNetError
    from incubator_mxnet_tpu_torch.lr_scheduler import FactorScheduler
    if kw.get("lr_scheduler") == "factor":
        kw = dict(kw, lr_scheduler=FactorScheduler(step=2))
    with pytest.raises(MXNetError):
        topt.functional_twin(topt.create(name, **kw))


GUARDED = [("sgd", {"learning_rate": 0.1}),
           ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
           ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
           ("adam", {"learning_rate": 0.01}),
           ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
           ("rmsprop", {"learning_rate": 0.01}),
           ("adagrad", {"learning_rate": 0.05}),
           ("lamb", {"learning_rate": 0.01, "wd": 0.01})]


@pytest.mark.parametrize("name,kw", GUARDED,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(GUARDED)])
def test_guard_skips_a_poisoned_step_under_each_rule(name, kw):
    import torch
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import autograd as ag, fault, telemetry
    skipped = []

    def on_fault(site="?", event="?", **k):
        if event == "skipped_step":
            skipped.append(site)

    x, y = _data()
    telemetry.FAULT.subscribe(on_fault)
    try:
        with tmx.cpu():
            net = _net()
            params = net.collect_params()
            tr = tmx.gluon.Trainer(params, name, dict(kw),
                                   skip_nonfinite=True, fused=True)
            loss_fn = tmx.gluon.loss.L2Loss()
            xs, ys = tmx.nd.array(x), tmx.nd.array(y)

            def step():
                with ag.record():
                    loss = loss_fn(net(xs), ys)
                loss.backward()
                tr.step(5)

            step()
            snap = [p.data()._data.clone() for p in params.values()]
            states = [s._data.clone() for i in sorted(tr._updaters.states)
                      for s in _state_arrays(tr._updaters.states[i])]
            fault.install_plan("trainer.grad:nonfinite@1")
            try:
                step()
            finally:
                fault.clear_plan()
            tr.sync_nonfinite_guard()
            for p, s in zip(params.values(), snap):
                assert torch.equal(p.data()._data, s), p.name
            got = [s._data for i in sorted(tr._updaters.states)
                   for s in _state_arrays(tr._updaters.states[i])]
            assert all(torch.equal(a, b) for a, b in zip(got, states))
            assert all(not bool(p.grad()._data.any())
                       for p in params.values())
            assert len(skipped) == 1
            step()
            tr.sync_nonfinite_guard()
            assert len(skipped) == 1
            assert not all(torch.equal(p.data()._data, s)
                           for p, s in zip(params.values(), snap))
    finally:
        telemetry.FAULT.unsubscribe(on_fault)


def _state_arrays(s):
    if s is None:
        return []
    return list(s) if isinstance(s, tuple) else [s]


def test_kernel_wrappers_refuse_mismatched_inputs():
    import torch
    from incubator_mxnet_tpu_torch.base import MXNetError
    from incubator_mxnet_tpu_torch.optimizer import fused
    w, g = [torch.zeros(3)], [torch.zeros(3)]
    with pytest.raises(MXNetError, match="unknown rule"):
        fused.multi_tensor_update("adadelta", w, g, [], torch.ones(1))
    with pytest.raises(MXNetError, match="slots"):
        fused.multi_tensor_update("sgd_mom", w, g, [], torch.ones(1))
    with pytest.raises(MXNetError):
        fused.lamb_update(w, g, [torch.zeros(3)], [], torch.ones(3))


# ------------------------------------------------ on the card (cuda mark)
K9_CASES = [("sgd", 0), ("sgd_mom", 1), ("nag", 1), ("adamw", 2),
            ("rmsprop", 1), ("adagrad", 1)]
# ragged, unaligned (an odd offset into one buffer) and multi-chunk leaves
K_SHAPES = [(3,), (1000, 37), (16384 * 2 + 5,), (64, 64), (1,), (777,)]


def _fa():
    # the module (the kernels package exports a function of its name)
    import importlib
    return importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels.flash_attention")


def _need_cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _leaves(scale, gen, dev, unaligned=True):
    import torch
    out = []
    for i, s in enumerate(K_SHAPES):
        n = int(np.prod(s))
        if unaligned and i == 1:        # a view 1 float past a 16-byte edge
            buf = torch.randn(n + 1, generator=gen, device=dev) * scale
            out.append(buf[1:].view(s))
        else:
            out.append(torch.randn(s, generator=gen, device=dev) * scale)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rule,slots", K9_CASES)
@pytest.mark.parametrize("stages", [(1.0, None, 0.0), (0.25, 0.004, 0.02)],
                         ids=["stages-off", "stages-on"])
def test_cuda_k9_matches_plain_bit_for_bit(rule, slots, stages):
    _need_cuda()
    import torch
    tfa = _fa()
    from incubator_mxnet_tpu_torch.optimizer import fused
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    w, g = _leaves(0.02, gen, dev), _leaves(1e-3, gen, dev)
    # adamw's v, rmsprop's n and adagrad's history are sums of squares
    positive = {"adamw": (1,), "rmsprop": (0,), "adagrad": (0,)}.get(rule,
                                                                     ())
    states = [[x.abs() if j in positive else x
               for x in _leaves(1e-3, gen, dev)] for j in range(slots)]
    hp = torch.tensor([1e-3, 0.271, 0.00299], device=dev)
    kw = dict(momentum=0.9, beta1=0.9, beta2=0.999, gamma1=0.95,
              epsilon=1e-8, rescale=stages[0], clip=stages[1], wd=stages[2])
    got = [[x.clone() for x in w]] + [[x.clone() for x in st]
                                      for st in states]
    want = [[x.clone() for x in w]] + [[x.clone() for x in st]
                                       for st in states]
    tfa.reset_launch_counts()
    fused.multi_tensor_update(rule, got[0], g, got[1:], hp, **kw)
    fused._plain_update(rule, want[0], g, want[1:], hp, kw["momentum"],
                        kw["beta1"], kw["beta2"], kw["gamma1"],
                        kw["epsilon"], *stages)
    torch.cuda.synchronize()
    assert tfa.launch_counts["multi_tensor_update"] == 1
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("bounds", [(None, None), (0.05, 0.3), (0.0, 0.0),
                                    (-1.0, 0.3)])
def test_cuda_k10_matches_plain_and_is_deterministic(bounds):
    _need_cuda()
    import torch
    tfa = _fa()
    from incubator_mxnet_tpu_torch.optimizer import fused
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    w, g = _leaves(0.02, gen, dev), _leaves(1e-3, gen, dev)
    m = _leaves(1e-4, gen, dev)
    v = [x * x for x in _leaves(1e-3, gen, dev)]
    hp = torch.tensor([1e-3, 0.271, 0.00299], device=dev)
    runs = []
    tfa.reset_launch_counts()
    for _ in range(2):
        got = [[x.clone() for x in xs] for xs in (w, m, v)]
        fused.lamb_update(got[0], g, got[1], got[2], hp, 0.9, 0.999, 1e-6,
                          0.5, 0.01, 0.01, *bounds)
        runs.append(got)
    want = [[x.clone() for x in xs] for xs in (w, m, v)]
    fused._plain_lamb_update(want[0], g, want[1], want[2], hp, 0.9, 0.999,
                             1e-6, 0.5, 0.01, 0.01, *bounds)
    torch.cuda.synchronize()
    assert tfa.launch_counts["multi_tensor_lamb"] == 4   # 2 calls of 2
    for a, b in zip(runs[0], runs[1]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for x, y in zip(runs[0][1] + runs[0][2], want[1] + want[2]):
        assert torch.equal(x, y)            # m, v: elementwise, exact
    for x, y in zip(runs[0][0], want[0]):   # of each leaf's largest
        assert float((x - y).abs().max()) <= K10_RTOL * float(y.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["sgd_mom", "adamw", "lamb"])
def test_cuda_guarded_kernels_write_only_zero_grads(rule):
    _need_cuda()
    import torch
    from incubator_mxnet_tpu_torch.optimizer import fused
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    w, g = _leaves(0.02, gen, dev), _leaves(1e-3, gen, dev)
    m, v = _leaves(1e-4, gen, dev), [x.abs() for x in _leaves(1e-3, gen,
                                                              dev)]
    g[2].view(-1)[-1] = float("nan")
    flag = fused.all_finite(g)
    before = [[x.clone() for x in xs] for xs in (w, m, v)]
    hp = torch.tensor([1e-3, 0.271, 0.00299], device=dev)
    if rule == "lamb":
        fused.lamb_update(w, g, m, v, hp, nonfinite=flag)
    else:
        slots = [m] if rule == "sgd_mom" else [m, v]
        fused.multi_tensor_update(rule, w, g, slots, hp, momentum=0.9,
                                  nonfinite=flag)
    torch.cuda.synchronize()
    for a, b in zip((w, m, v), before):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(not bool(x.any()) for x in g)


@pytest.mark.cuda
def test_cuda_fused_trainer_with_each_rule_equals_the_loop():
    """The Gluon Trainer on the card: K9/K10 through ``FusedUpdater``
    against the ``fused=False`` loop (the plain version on the card), 3
    steps; bit for bit but LAMB (its norms)."""
    _need_cuda()
    import torch
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import autograd as ag
    x, y = _data()
    for name, kw in GUARDED:
        got = []
        for fused_flag in (True, False):
            with tmx.gpu(0):
                net = _net()
                tr = tmx.gluon.Trainer(net.collect_params(), name, dict(kw),
                                       fused=fused_flag)
                loss_fn = tmx.gluon.loss.L2Loss()
                xs, ys = tmx.nd.array(x), tmx.nd.array(y)
                for _ in range(3):
                    with ag.record():
                        loss = loss_fn(net(xs), ys)
                    loss.backward()
                    tr.step(5)
                got.append([p.data()._data.clone()
                            for p in net.collect_params().values()])
        for a, b in zip(*got):
            if name == "lamb":
                assert float((a - b).abs().max()) <= \
                    K10_RTOL * float(b.abs().max()), name
            else:
                assert torch.equal(a, b), name


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        _jax_child(sys.argv[2])
