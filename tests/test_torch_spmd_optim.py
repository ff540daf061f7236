"""The port's ``SPMDTrainer`` with each of the seven functional rules
against the JAX ``SPMDTrainer``, fp32 on the CPU: a ``bert_tiny``-width
``BERTForPretrain`` (2 layers, 64 units, FFN 128, 2 heads; vocab 256,
B = 4, T = 32) from the same weights and batch, 3 steps per rule.  LAMB
takes a linear warm-up + polynomial decay ``lr_schedule``, computed from
the step tensor on each side.

The JAX side runs in a child interpreter once per module (this file as a
script, every ``MXNET_*`` variable unset): one net, its initial weights
restored before each rule's trainer, every loss and parameter after each
step written to an ``.npz`` in ``tmp_path``.

Tolerances (fp32; the two frameworks' forward and backward sum in other
orders, the gradients agree to ~1e-4 of each tensor's largest value,
tests/test_torch_bert.py): losses rtol ``LOSS_RTOL``; parameters
``PARAM_ATOL``, except that a rule whose step normalises the gradient
(adam, adamw, rmsprop, adagrad, lamb) can turn the sign of a gradient at
the rounding floor (|g| below ``GRAD_FLOOR`` of its tensor's largest)
into a whole step the other way: such elements may differ by up to two
steps per step taken and must stay under ``FLIP_SHARE`` of all
elements."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=256, units=64, hidden_size=128, num_layers=2,
           num_heads=2, max_length=64)
V, B, T, STEPS = CFG["vocab_size"], 4, 32, 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
GRAD_FLOOR = 1e-3
FLIP_SHARE = 1e-3
WARMUP, MAX_UPDATE, POWER = 2, 10, 2.0
# (rule, optimizer_params without the schedule, largest step per element)
RULES = [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}, None),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}, None),
    ("adam", {"learning_rate": 1e-4, "wd": 1e-3}, 1e-4),
    ("adamw", {"learning_rate": 1e-4, "wd": 0.01}, 1e-4),
    ("rmsprop", {"learning_rate": 1e-4, "wd": 1e-4}, 4e-4),
    ("adagrad", {"learning_rate": 1e-3, "clip_gradient": 1.0}, 1e-3),
    ("lamb", {"learning_rate": 1e-2, "wd": 0.01, "rescale_grad": 0.5},
     1e-2),
]
IDS = [r for r, _, _ in RULES]


def schedule(np_mod, where, step, lr):
    """Linear warm-up for ``WARMUP`` steps, then polynomial decay to 0 at
    ``MAX_UPDATE`` (the LAMB paper's schedule), in either framework."""
    t = step.astype(np_mod.float32) if hasattr(step, "astype") else \
        step.to(np_mod.float32)
    warm = lr * t / WARMUP
    frac = 1.0 - (t - WARMUP) / (MAX_UPDATE - WARMUP)
    decay = lr * frac ** POWER
    return where(t <= WARMUP, warm, decay)


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (B, T)).astype(np.int32)
    types = np.zeros((B, T), np.int32)
    labels = np.concatenate([rng.integers(0, V, (B, T)),
                             rng.integers(0, 2, (B, 1))],
                            axis=1).astype(np.float32)
    return ids, types, labels


def _jax_child(out_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu import parallel
    from incubator_mxnet_tpu.models import bert as Bm
    mx.random.seed(0)
    net = Bm.BERTForPretrain(Bm.BERTModel(dropout=0.0, **CFG), vocab_size=V)
    net.initialize(init=mx.init.Normal(0.02))
    pre = net.prefix

    def strip(name):
        return name[len(pre):] if name.startswith(pre) else name

    params = list(net.collect_params().items())
    init = [p.data().asnumpy().copy() for _, p in params]
    out = {"p0/" + strip(k): a for (k, _), a in zip(params, init)}
    ids, types, labels = _batch()
    mesh = parallel.make_mesh({"data": 1}, devices=jax.devices()[:1])
    for rule, kw, _ in RULES:
        for (_, p), a in zip(params, init):
            p.set_data(mx.nd.array(a))
        kw = dict(kw)
        if rule == "lamb":
            lr = kw["learning_rate"]
            kw["lr_schedule"] = lambda step, lr=lr: schedule(
                jnp, jnp.where, step, lr)
        tr = parallel.SPMDTrainer(net, Bm.BERTPretrainLoss(V), rule, kw,
                                  mesh=mesh)
        losses = []
        for s in range(1, STEPS + 1):
            losses.append(float(np.asarray(tr.step(ids, types, labels))))
            for k, v in tr.params.items():
                out[f"{rule}/p{s}/" + strip(k)] = np.asarray(v)
        out[f"{rule}/losses"] = np.asarray(losses, np.float32)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_spmd_optim") / "ref.npz"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, __file__, "--jax", str(path)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def _params(data, prefix):
    return {k[len(prefix):]: v for k, v in data.items()
            if k.startswith(prefix)}


def _trainer(data, rule, kw):
    import torch
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models import bert as tbert
    from incubator_mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    net = tbert.BERTForPretrain(
        tbert.BERTModel(dropout=0.0, device="cpu", **CFG), vocab_size=V)
    load_jax_params(net, _params(data, "p0/"))
    kw = dict(kw)
    if rule == "lamb":
        lr = kw["learning_rate"]
        kw["lr_schedule"] = lambda step: schedule(torch, torch.where, step,
                                                  lr)
    return SPMDTrainer(net, tbert.BERTPretrainLoss(V), rule, kw,
                       mesh=make_mesh({"data": 1}, devices=["cpu"]))


@pytest.mark.parametrize("rule,kw,step_cap", RULES, ids=IDS)
def test_spmd_rule_matches_jax(ref, rule, kw, step_cap):
    tr = _trainer(ref, rule, kw)
    batch = _batch()
    _, grads = tr._loss_and_grads(*batch)
    g1 = {n: g.numpy() for n, g in zip(tr.params, grads)}
    losses = []
    flipped = total = 0
    for s in range(1, STEPS + 1):
        losses.append(float(tr.step(*batch)))
        want = _params(ref, f"{rule}/p{s}/")
        assert sorted(want) == sorted(tr.params)
        for n, p in tr.params.items():
            diff = np.abs(p.detach().numpy() - want[n])
            bad = diff > PARAM_ATOL
            if step_cap is None:
                assert not bad.any(), (rule, n, s, float(diff.max()))
                continue
            g = np.abs(g1[n])
            floor = g <= GRAD_FLOOR * g.max()
            assert not (bad & ~floor).any(), (rule, n, s, float(diff.max()))
            assert diff.max() <= 2 * step_cap * s + PARAM_ATOL, (rule, n, s)
            flipped += int(bad.sum())
            total += diff.size
    np.testing.assert_allclose(losses, ref[f"{rule}/losses"],
                               rtol=LOSS_RTOL)
    assert flipped <= FLIP_SHARE * max(total, 1), (flipped, total)
    assert losses[-1] < losses[0]


def test_lamb_schedule_values_match_jax():
    """The warm-up + poly schedule gives the same fp32 lr on both sides at
    every step the tests take, and beyond the warm-up."""
    import jax.numpy as jnp
    import torch
    for s in range(1, MAX_UPDATE + 1):
        a = schedule(jnp, jnp.where, jnp.asarray(s, jnp.int32), 1e-2)
        b = schedule(torch, torch.where, torch.tensor(s, dtype=torch.int32),
                     1e-2)
        np.testing.assert_allclose(float(b), float(a), rtol=1e-6)


@pytest.mark.parametrize("bad", ["float", "numpy", "shape"])
def test_schedule_that_is_not_a_device_tensor_is_refused(bad):
    import torch
    from incubator_mxnet_tpu_torch.base import MXNetError
    from incubator_mxnet_tpu_torch.parallel import optim as fopt
    fn = {"float": lambda step: 0.01,
          "numpy": lambda step: np.float32(0.01),
          "shape": lambda step: torch.full((1,), 0.01)}[bad]
    step = torch.tensor(1, dtype=torch.int32)
    for rule in ("sgd", "nag", "adam", "adamw", "rmsprop", "adagrad",
                 "lamb"):
        opt = fopt.create(rule, lr_schedule=fn)
        w, g = [torch.zeros(3)], [torch.ones(3)]
        with pytest.raises(MXNetError, match="lr_schedule"):
            opt.update(w, g, opt.init(w), step)


def test_create_accepts_the_seven_rules_and_sgd_defaults_to_no_momentum():
    import torch
    from incubator_mxnet_tpu_torch.parallel import optim as fopt
    for rule in ("sgd", "nag", "adam", "adamw", "rmsprop", "adagrad",
                 "lamb"):
        f = fopt.create(rule)
        assert isinstance(f, fopt.FunctionalOptimizer)
        assert f.elementwise == (rule != "lamb")
    assert fopt.create("sgd").init([torch.zeros(2)]) == {}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        _jax_child(sys.argv[2])
