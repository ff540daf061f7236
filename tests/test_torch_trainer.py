"""The imperative training loop of the port (``gluon.Trainer`` with its
``FusedUpdater``, ``optimizer.Adam``, ``autograd``, ``nd``) against the
JAX package's, fp32 on the CPU, and its kernels on the card.

The slice as a whole is ``example/language_model/train_gpt.py``'s loop at
``gpt_tiny`` (vocab 64, T 24, B 4, dropout 0, Adam lr 2e-3): the JAX side
runs it in a child interpreter with every ``MXNET_*`` variable unset and
writes its initial weights, batches, losses, final weights and Adam
states to an ``.npz`` in ``tmp_path``; the port loads those weights by
name and runs the same loop with ``with mx.cpu():``.

Tolerances (fp32; the two sides sum in different orders):
- losses: 1e-5 relative;
- every final parameter and Adam state: 1e-5 of its leaf's largest
  magnitude.  Adam's m / sqrt(v) turns a gradient's sign into a whole
  lr-sized step, so an element whose gradient sits at the rounding floor
  (|g| below 1e-4 of the model's largest gradient in a step) may step the
  other way; such elements are counted and must stay under 0.1 % of all
  elements (the rule of ``test_torch_bert.py``).  The attention's key
  bias is left out of that count: its gradient is zero in exact
  arithmetic (the softmax over keys ignores a shift shared by every key),
  so in both packages it is rounding noise, which Adam turns into steps
  of either sign; both packages' key-bias gradients must be at the
  floor.
The fused update against ``fused=False``, and the guard, are held bit
for bit."""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as ag
from incubator_mxnet_tpu_torch import fault, telemetry
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import gpt
from incubator_mxnet_tpu_torch.optimizer import fused

ROOT = Path(__file__).resolve().parents[1]
V, T, B, LR, STEPS = 64, 24, 4, 2e-3, 3
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-5             # of each leaf's largest magnitude
GRAD_FLOOR = 1e-4           # of the model's largest gradient in a step
FLIP_SHARE = 1e-3

_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as ag
from incubator_mxnet_tpu.models import gpt

V, T, B, lr, steps = eval(sys.argv[2])


def make_batch(rng, batch_size, seq_len, vocab):
    start = rng.randint(0, vocab, (batch_size, 1))
    stride = rng.randint(1, 4, (batch_size, 1))
    seq = (start + stride * np.arange(seq_len + 1)[None]) % vocab
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


mx.random.seed(0)
net = gpt.gpt_tiny(vocab_size=V, dropout=0.0)
net.initialize(init=mx.init.Normal(0.02))
net.hybridize()
params = net.collect_params()
pre = net.prefix
out = {"w0/" + k[len(pre):]: p.data().asnumpy() for k, p in params.items()}
loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": lr})
rng = np.random.RandomState(0)
losses = []
for s in range(steps + 1):
    if s == steps:                      # the lr change before the last
        trainer.set_learning_rate(lr / 4)
    x, y = make_batch(rng, B, T, V)
    out["x%d" % s], out["y%d" % s] = x, y
    with ag.record():
        logits = net(mx.nd.array(x, dtype="int32"))
        L = loss_fn(logits.reshape((-1, V)),
                    mx.nd.array(y.reshape(-1).astype(np.float32))).mean()
    L.backward()
    for k, p in params.items():
        out["g%d/" % s + k[len(pre):]] = p.grad().asnumpy()
    trainer.step(1)
    losses.append(float(L.asnumpy()))
    for i, (k, p) in enumerate(params.items()):
        out["w%d/" % (s + 1) + k[len(pre):]] = p.data().asnumpy()
        m, v = trainer._updaters.states[i]
        out["m%d/" % (s + 1) + k[len(pre):]] = m.asnumpy()
        out["v%d/" % (s + 1) + k[len(pre):]] = v.asnumpy()
out["losses"] = np.asarray(losses, np.float64)
np.savez(sys.argv[1], **out)
print("ok")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX loop's numbers, computed once in a child interpreter."""
    path = tmp_path_factory.mktemp("trainer_ref") / "ref.npz"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(path), repr((V, T, B, LR, STEPS))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


def _group(data, tag):
    pre = tag + "/"
    return {k[len(pre):]: v for k, v in data.items() if k.startswith(pre)}


def _net(weights=None, device="cpu"):
    net = gpt.gpt_tiny(vocab_size=V, dropout=0.0, device=device)
    if weights is None:
        mx.random.seed(0)
        net.initialize(init=mx.init.Normal(0.02))
    else:
        load_jax_params(net, weights)
    net.hybridize()
    return net


def _step(net, trainer, x, y):
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with ag.record():
        logits = net(mx.nd.array(x, dtype="int32"))
        L = loss_fn(logits.reshape((-1, V)),
                    mx.nd.array(y.reshape(-1).astype(np.float32))).mean()
    L.backward()
    trainer.step(1)
    return L


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        start = rng.randint(0, V, (B, 1))
        stride = rng.randint(1, 4, (B, 1))
        seq = (start + stride * np.arange(T + 1)[None]) % V
        out.append((seq[:, :-1].astype(np.int32),
                    seq[:, 1:].astype(np.int32)))
    return out


def _mx_names(net):
    pre = net.prefix
    return [k[len(pre):] for k in net.collect_params().keys()]


def _close(what, got, want, grads, tops):
    """``got`` within LEAF_TOL of ``want``'s largest magnitude, except
    elements whose gradient is at the rounding floor of the model's
    largest gradient in some step (counted)."""
    tol = LEAF_TOL * max(float(np.abs(want).max()), 1e-30)
    bad = np.abs(got - want) > tol
    floor = np.zeros_like(bad)
    for g, top in zip(grads, tops):
        floor |= np.abs(g) <= GRAD_FLOOR * top
    assert not (bad & ~floor).any(), (what, float(np.abs(got - want).max()),
                                      tol)
    return int((bad & floor).sum())


def _key_bias(name):
    return name.endswith("multiheadattention0_dense1_bias")


# ------------------------------------------------- the slice as a whole
def test_train_gpt_loop_matches_jax(ref):
    """``train_gpt.py``'s loop: 3 Adam steps, then one more after
    ``set_learning_rate``, from the JAX weights: losses, final parameters
    and Adam states equal the JAX ``Trainer``'s within the stated
    tolerances."""
    with mx.cpu():
        net = _net(_group(ref, "w0"))
        params = net.collect_params()
        trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": LR})
        losses = []
        for s in range(STEPS + 1):
            if s == STEPS:
                trainer.set_learning_rate(LR / 4)
            L = _step(net, trainer, ref[f"x{s}"], ref[f"y{s}"])
            losses.append(float(L.asnumpy()))
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    names = _mx_names(net)
    last = STEPS + 1
    tops = [max(float(np.abs(ref[f"g{s}/{n}"]).max()) for n in names)
            for s in range(last)]
    flips = total = 0
    for i, (name, p) in enumerate(zip(names, params.values())):
        grads = [ref[f"g{s}/{name}"] for s in range(last)]
        if _key_bias(name):
            assert all(np.abs(g).max() <= GRAD_FLOOR * t
                       for g, t in zip(grads, tops)), name
            continue
        m, v = trainer._updaters.states[i]
        for what, got in (("w", p.data()), ("m", m), ("v", v)):
            want = ref[f"{what}{last}/{name}"]
            flips += _close(f"{what} {name}", got.asnumpy(), want, grads,
                            tops)
            total += want.size
    assert flips <= FLIP_SHARE * total, (flips, total)


def test_trainer_gradients_match_jax(ref):
    """Step 1's gradient buffers (``grad_req='write'``) equal JAX's."""
    with mx.cpu():
        net = _net(_group(ref, "w0"))
        params = net.collect_params()
        trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": LR})
        _step(net, trainer, ref["x0"], ref["y0"])
    names = _mx_names(net)
    top = max(float(np.abs(ref[f"g0/{n}"]).max()) for n in names)
    for name, p in zip(names, params.values()):
        want = ref[f"g0/{name}"]
        got = p.grad().asnumpy()
        if _key_bias(name):         # rounding noise in both packages
            assert np.abs(got).max() <= GRAD_FLOOR * top, name
            continue
        # the guard-free fused step leaves the gradient it read
        np.testing.assert_allclose(
            got, want, atol=1e-6 * top + 1e-4 * float(np.abs(want).max()),
            err_msg=name)


# --------------------------------------------------- fused against loop
@pytest.mark.parametrize("opts", [
    {},
    {"wd": 0.01, "clip_gradient": 0.05, "mult": True},
], ids=["plain", "wd-clip-mult"])
def test_fused_update_equals_the_loop_bit_for_bit(opts):
    """The fused update (the plain per-leaf version of K8 on the CPU, one
    call per (lr, wd) group) equals ``fused=False``'s per-parameter
    ``Adam.update`` bit for bit: every loss, parameter and state, with
    weight decay, clipping and per-parameter multipliers too."""
    opts = dict(opts)
    mult = opts.pop("mult", False)
    nets, trainers = [], []
    with mx.cpu():
        for fused_flag in (True, False):
            net = _net()
            params = net.collect_params()
            if mult:
                for k, p in params.items():
                    if k.endswith("_bias"):
                        p.wd_mult = 0.0
                    if "gptcell1" in k:
                        p.lr_mult = 0.5
            nets.append(net)
            trainers.append(mx.gluon.Trainer(
                params, "adam", dict(learning_rate=LR, **opts),
                fused=fused_flag))
        for x, y in _batches(STEPS):
            la, lb = (float(_step(n, t, x, y).asnumpy())
                      for n, t in zip(nets, trainers))
            assert la == lb
    pa, pb = (n.collect_params() for n in nets)
    for (k, a), b in zip(pa.items(), pb.values()):
        assert torch.equal(a.data()._data, b.data()._data), k
    sa, sb = (t._updaters.states for t in trainers)
    for i in sa:
        for a, b in zip(sa[i], sb[i]):
            assert torch.equal(a._data, b._data), i
    groups = 3 if mult else 1
    assert telemetry.gauge("mxtpu_optimizer_dispatches_per_step").value \
        in (groups, len(pa))


# ------------------------------------------------------------ the guard
@pytest.mark.parametrize("fused_flag", [True, False], ids=["fused", "loop"])
def test_poisoned_step_is_skipped_and_counted(fused_flag):
    """``skip_nonfinite``: a step poisoned by ``trainer.grad:nonfinite``
    leaves every parameter and Adam state bit for bit, zeroes the
    gradients and counts 1 skipped step; the steps either side update
    (the contract of ``test_fused_optimizer.py``'s guard test)."""
    skipped = []

    def on_fault(site="?", event="?", **kw):
        if event == "skipped_step":
            skipped.append(site)

    batches = _batches(3, seed=1)
    telemetry.FAULT.subscribe(on_fault)
    try:
        with mx.cpu():
            net = _net()
            params = net.collect_params()
            tr = mx.gluon.Trainer(params, "adam", {"learning_rate": LR},
                                  skip_nonfinite=True, fused=fused_flag)
            before = [p.data()._data.clone() for p in params.values()]
            _step(net, tr, *batches[0])
            assert not all(torch.equal(p.data()._data, b)
                           for p, b in zip(params.values(), before))
            snap = [p.data()._data.clone() for p in params.values()]
            states = [s._data.clone() for st in tr._updaters.states.values()
                      for s in st]
            fault.install_plan("trainer.grad:nonfinite@1")
            try:
                _step(net, tr, *batches[1])
            finally:
                fault.clear_plan()
            tr.sync_nonfinite_guard()
            for p, s in zip(params.values(), snap):
                assert torch.equal(p.data()._data, s), p.name
            got = [s._data for st in tr._updaters.states.values()
                   for s in st]
            assert all(torch.equal(a, b) for a, b in zip(got, states))
            assert all(not bool(p.grad()._data.any())
                       for p in params.values())
            assert len(skipped) == 1
            _step(net, tr, *batches[2])
            tr.sync_nonfinite_guard()
            assert len(skipped) == 1
            assert not all(torch.equal(p.data()._data, s)
                           for p, s in zip(params.values(), snap))
    finally:
        telemetry.FAULT.unsubscribe(on_fault)


def test_all_finite_plain_version_flags_nan_and_inf():
    leaves = [torch.ones(5), torch.zeros(3, 7), torch.ones(1)]
    assert int(fused.all_finite(leaves)) == 0
    for bad in (float("nan"), float("inf"), -float("inf")):
        leaves[1][2, 3] = bad
        assert int(fused.all_finite(leaves)) == 1
        leaves[1][2, 3] = 0.0


# ------------------------------------------------------ states and lr
def test_save_and_load_states_resume_bit_for_bit(tmp_path):
    """``save_states`` after step 2, then ``load_states`` into a fresh
    trainer over the step-2 weights: step 3 equals the uninterrupted
    run's bit for bit."""
    batches = _batches(3, seed=2)
    with mx.cpu():
        net = _net()
        params = net.collect_params()
        tr = mx.gluon.Trainer(params, "adam", {"learning_rate": LR})
        for x, y in batches[:2]:
            _step(net, tr, x, y)
        tr.save_states(str(tmp_path / "adam.states"))
        net.save_parameters(str(tmp_path / "net.params"))
        _step(net, tr, *batches[2])

        net2 = gpt.gpt_tiny(vocab_size=V, dropout=0.0, device="cpu")
        net2.load_parameters(str(tmp_path / "net.params"))
        tr2 = mx.gluon.Trainer(net2.collect_params(), "adam",
                               {"learning_rate": 1.0})
        tr2.load_states(str(tmp_path / "adam.states"))
        assert tr2.learning_rate == LR
        _step(net2, tr2, *batches[2])
    for (k, a), b in zip(params.items(), net2.collect_params().values()):
        assert torch.equal(a.data()._data, b.data()._data), k


def test_set_learning_rate_takes_effect_at_the_next_step():
    """After ``set_learning_rate`` the next fused step equals a loop step
    at the new rate, bit for bit."""
    batches = _batches(2, seed=3)
    with mx.cpu():
        nets = [_net(), _net()]
        trs = [mx.gluon.Trainer(n.collect_params(), "adam",
                                {"learning_rate": LR}, fused=f)
               for n, f in zip(nets, (True, False))]
        for n, t in zip(nets, trs):
            _step(n, t, *batches[0])
            t.set_learning_rate(LR * 3)
            assert t.learning_rate == LR * 3
            _step(n, t, *batches[1])
    for a, b in zip(*(n.collect_params().values() for n in nets)):
        assert torch.equal(a.data()._data, b.data()._data)


# --------------------------------------------------------- the surface
@pytest.mark.parametrize("kwargs,what", [
    (dict(kvstore="dist_sync"), "kvstore"),
    (dict(update_on_kvstore=True), "update_on_kvstore"),
    (dict(zero1=True), "ZeRO-1"),
    (dict(compression_params={"type": "2bit"}), "compression"),
])
def test_trainer_refuses_what_is_not_ported(kwargs, what):
    with mx.cpu():
        net = _net()
    with pytest.raises(MXNetError, match="not ported"):
        mx.gluon.Trainer(net.collect_params(), "adam", {}, **kwargs)


@pytest.mark.parametrize("name", ["sgd", "adamw", "lamb"])
def test_other_optimizers_are_refused_by_name(name):
    """Every optimizer is ported, and so is multi-precision now (it was
    refused by name before): the Trainer passes ``multi_precision`` to
    its optimizer (the fp16 path is held to the JAX Trainer in
    ``test_torch_half_gluon.py``)."""
    with mx.cpu():
        net = _net()
    mx.gluon.Trainer(net.collect_params(), name, {})
    tr = mx.gluon.Trainer(net.collect_params(), name,
                          {"multi_precision": True})
    assert tr.optimizer.multi_precision


def test_step_publishes_spans_and_the_trainer_topic():
    seen = []

    def on_step(phase=None, seconds=None, **kw):
        seen.append(phase)

    telemetry.TRAINER.subscribe(on_step)
    try:
        with mx.cpu():
            net = _net()
            tr = mx.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": LR})
            x, y = _batches(1)[0]
            _step(net, tr, x, y)
            tr.update(1)
    finally:
        telemetry.TRAINER.unsubscribe(on_step)
    assert seen == ["step", "update"]


def _dense_net(device, dtype):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(8, activation="tanh", in_units=4,
                                  device=device),
                mx.gluon.nn.Dense(3, in_units=8, device=device))
    mx.random.seed(0)
    net.initialize(init=mx.init.Normal(0.5))
    return net.cast(dtype)


def _dense_step(net, trainer, dtype):
    rng = np.random.RandomState(3)
    x = mx.nd.array(rng.randn(5, 4), dtype=dtype)
    y = mx.nd.array(rng.randn(5, 3), dtype=dtype)
    with ag.record():
        L = mx.gluon.loss.L2Loss()(net(x), y).mean()
    L.backward()
    trainer.step(1)


def test_fused_trainer_takes_a_non_fp32_net_on_the_cpu_through_the_loop():
    """K8 takes fp32 leaves only.  On the CPU a float64 net under the
    default (fused) Trainer is updated by the per-parameter loop, bit for
    bit what ``fused=False`` gives, one update per parameter."""
    with mx.cpu():
        nets = [_dense_net("cpu", "float64") for _ in range(2)]
        trs = [mx.gluon.Trainer(n.collect_params(), "adam",
                                {"learning_rate": LR}, fused=f)
               for n, f in zip(nets, (None, False))]
        for n, t in zip(nets, trs):
            _dense_step(n, t, "float64")
            assert telemetry.gauge(
                "mxtpu_optimizer_dispatches_per_step").value == 4
    for a, b in zip(*(n.collect_params().values() for n in nets)):
        assert a.data()._data.dtype == torch.float64
        assert torch.equal(a.data()._data, b.data()._data), a.name


# ------------------------------------------------ on the card (cuda mark)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.cuda
def test_cuda_fused_updater_equals_the_loop_bit_for_bit():
    """K8 through the fused Trainer equals the per-parameter loop on the
    card, bit for bit, over 3 steps of the Gluon loop at ``gpt_tiny``."""
    _need_cuda()
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels.flash_attention")
    nets = [_net(device="cuda"), _net(device="cuda")]
    trs = [mx.gluon.Trainer(n.collect_params(), "adam",
                            {"learning_rate": LR}, fused=f)
           for n, f in zip(nets, (True, False))]
    with mx.gpu(0):
        for x, y in _batches(STEPS):
            fa.reset_launch_counts()
            la = float(_step(nets[0], trs[0], x, y).asnumpy())
            assert fa.launch_counts["multi_tensor_adam"] == 1
            lb = float(_step(nets[1], trs[1], x, y).asnumpy())
            assert la == lb
    for a, b in zip(*(n.collect_params().values() for n in nets)):
        assert torch.equal(a.data()._data, b.data()._data), a.name


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [None, float("nan"), float("inf"),
                                 -float("inf")])
def test_cuda_all_finite_matches_plain(bad):
    """The all-finite kernel against its plain version on finite leaves
    and with one NaN / +Inf / -Inf, in an aligned and an unaligned leaf;
    one launch per call."""
    _need_cuda()
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels.flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(1024, 768), (7,), (33, 5), (50257, 16), (1,)]
    for leaf, pos in ((0, 1000), (1, 6), (2, 164), (3, 50257 * 16 - 1)):
        g = [torch.randn(s, device="cuda", generator=gen) for s in shapes]
        if bad is not None:
            g[leaf].view(-1)[pos] = bad
        fa.reset_launch_counts()
        got = int(fused.all_finite(g).item())
        assert fa.launch_counts["all_finite"] == 1
        want = int(fused._plain_all_finite(
            g, torch.zeros(1, dtype=torch.int32, device="cuda")).item())
        assert got == want == (0 if bad is None else 1)


@pytest.mark.cuda
def test_cuda_guarded_k8_with_the_flag_set_writes_only_zero_grads():
    _need_cuda()
    from incubator_mxnet_tpu_torch.parallel import optim as fopt
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(256, 64), (13,), (4097,)]
    w, g, m = ([torch.randn(s, device="cuda", generator=gen) for s in shapes]
               for _ in range(3))
    v = [x * x for x in g]
    g[1][5] = float("nan")
    before = [[x.clone() for x in xs] for xs in (w, m, v)]
    flag = fused.all_finite(g)
    lr_t = fopt.bias_corrected_lr(1e-3, 0.9, 0.999, torch.tensor(
        1, dtype=torch.int32, device="cuda"))
    fused.adam_update(w, g, m, v, lr_t, nonfinite=flag)
    torch.cuda.synchronize()
    for xs, ys in zip((w, m, v), before):
        assert all(torch.equal(a, b) for a, b in zip(xs, ys))
    assert all(not bool(x.any()) for x in g)
    # a clear flag: the guarded update equals the unguarded one
    g = [torch.randn(s, device="cuda", generator=gen) for s in shapes]
    flag = fused.all_finite(g)
    got = [[x.clone() for x in xs] for xs in (w, m, v)]
    fused.adam_update(*got[:1], [x.clone() for x in g], *got[1:], lr_t,
                      nonfinite=flag)
    fused.adam_update(w, g, m, v, lr_t)
    torch.cuda.synchronize()
    for xs, ys in zip(got, (w, m, v)):
        assert all(torch.equal(a, b) for a, b in zip(xs, ys))


@pytest.mark.cuda
def test_cuda_fused_trainer_refuses_a_leaf_k8_cannot_take():
    """On the card the default Trainer does not give way to the plain
    per-parameter loop: a float64 leaf (K8 takes fp32, bf16 and fp16)
    raises, naming the parameter, and ``fused=False`` trains the same
    net."""
    _need_cuda()
    with mx.gpu(0):
        net = _dense_net("cuda", "float64")
        tr = mx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": LR})
        with pytest.raises(MXNetError, match="fp32.*dense0_weight"):
            _dense_step(net, tr, "float64")
        tr = mx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": LR}, fused=False)
        before = [p.data()._data.clone()
                  for p in net.collect_params().values()]
        _dense_step(net, tr, "float64")
    assert not any(torch.equal(a, p.data()._data) for a, p in
                   zip(before, net.collect_params().values()))
