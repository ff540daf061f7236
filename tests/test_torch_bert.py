"""The port's BERT training slice (``incubator_mxnet_tpu_torch``:
``models/bert.py``, ``gluon/loss.py``, ``optimizer/cores.py``,
``parallel/``) against the JAX package on the same weights and batch, at
the width of ``bench.py``'s CPU BERT (2 layers, 128 units, FFN 256, 2
heads, vocab 1024; B = 4, T = 64), fp32 on the CPU.

The JAX side runs in a child interpreter, once per module: it builds the
JAX ``BERTForPretrain`` (``Normal(0.02)``, ``mx.random.seed(0)``), the
JAX ``Dense`` with ``activation="tanh"``, a JAX ``SPMDTrainer`` (Adam, lr
1e-4, mesh ``{"data": 1}``) and takes three steps, and writes every
number to an ``.npz`` under ``tmp_path``.  So no JAX-package global of
this worker (telemetry registry, health ring, ``mx.random``'s key stream,
mesh context, block-name counters, ``MXNET_*`` variables) is read or
changed, and the child runs with every ``MXNET_*`` variable unset (health
plane and telemetry off).  Weights cross by name through
:func:`load_jax_params`.

Tolerances (fp32; the two sides sum in different orders):
- forward scores and Dense: atol/rtol 1e-4; losses rtol 1e-5;
- step-1 gradients: atol 1e-6 + rtol 1e-4 of each tensor's largest value;
- parameters after each Adam step: atol 2e-6 (an Adam step moves an
  element by ~lr = 1e-4).  Adam's m / sqrt(v) turns the sign of the
  gradient into a whole lr-sized step, so an element whose gradients sit
  at the rounding floor (|g| below 1e-4 of its tensor's largest) may step
  the other way: such elements may differ by up to 2 lr per step taken;
  they are counted and must stay under 0.1 % of all elements."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import initializer as tinit
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import load_jax_params, mx_param_names
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.nn import Dense
from incubator_mxnet_tpu_torch.models import bert as tbert
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=1024, units=128, hidden_size=256, num_layers=2,
           num_heads=2, max_length=128)
V, B, T = CFG["vocab_size"], 4, 64
LR, STEPS = 1e-4, 3
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
PARAM_ATOL = 2e-6
GRAD_FLOOR = 1e-4       # of the tensor's largest gradient
FLIP_SHARE = 1e-3

_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import parallel
from incubator_mxnet_tpu.gluon import nn
from incubator_mxnet_tpu.models import bert as B

cfg, nb, nt, lr, steps = eval(sys.argv[2])
V = cfg["vocab_size"]
out = {}

# the pooler's / NSP head's layer: Dense with tanh, flatten False and True
rng = np.random.RandomState(0)
for flat, shape in ((False, (3, 2, 7)), (True, (3, 7))):
    d = nn.Dense(5, activation="tanh", flatten=flat, in_units=7,
                 prefix="tanh%d_" % flat)
    d.initialize(init=mx.init.Normal(0.5))
    x = rng.randn(*shape).astype(np.float32)
    out["dense%d/x" % flat] = x
    out["dense%d/y" % flat] = d(mx.nd.array(x)).asnumpy()
    out["dense%d/weight" % flat] = d.weight.data().asnumpy()
    out["dense%d/bias" % flat] = d.bias.data().asnumpy()

# SoftmaxCrossEntropyLoss with its weighting: float labels, one out of range
from incubator_mxnet_tpu.gluon import loss as gloss
pred = rng.randn(6, 5).astype(np.float32)
lab = np.array([0, 4, 2, 7, 1, 3], np.float32)
sw = rng.rand(6, 1).astype(np.float32)
out.update(ce_pred=pred, ce_label=lab, ce_sw=sw)
out["ce/loss"] = gloss.SoftmaxCrossEntropyLoss(weight=0.5)(
    mx.nd.array(pred), mx.nd.array(lab), mx.nd.array(sw)).asnumpy()

# bench.py's BERT set-up and batch (bench.py:174-202)
mx.random.seed(0)
net = B.BERTForPretrain(B.BERTModel(dropout=0.0, **cfg), vocab_size=V)
net.initialize(init=mx.init.Normal(0.02))
rng = np.random.default_rng(0)
# every shape is declared, so bench.py's settling forward is not needed
ids = rng.integers(0, V, (nb, nt)).astype(np.int32)
types = np.zeros((nb, nt), np.int32)
labels = np.concatenate([rng.integers(0, V, (nb, nt)),
                         rng.integers(0, 2, (nb, 1))], axis=1).astype(
                             np.float32)
valid = np.array([nt, 1, nt // 2, 37], np.float32)
out.update(ids=ids, types=types, labels=labels, valid=valid)
pre = net.prefix


def strip(name):
    return name[len(pre):] if name.startswith(pre) else name


names = [strip(n) for n in net.collect_params()]
for k, p in net.collect_params().items():
    out["p0/" + strip(k)] = p.data().asnumpy()
loss_blk = B.BERTPretrainLoss(V)
net.hybridize()
for tag, vl in (("novl", None), ("vl", valid)):
    args = [mx.nd.array(ids, dtype=np.int32),
            mx.nd.array(types, dtype=np.int32)]
    if vl is not None:
        args.append(mx.nd.array(vl))
    with mx.autograd.pause():
        mlm, nsp = net(*args)
        out["loss/" + tag] = loss_blk(mlm, nsp, mx.nd.array(labels)).asnumpy()
        out["mlmloss/" + tag] = B.MLMPretrainLoss(V)(
            mlm, mx.nd.array(labels[:, :-1])).asnumpy()
    out["mlm/" + tag] = mlm.asnumpy()
    out["nsp/" + tag] = nsp.asnumpy()

mesh = parallel.make_mesh({"data": 1}, devices=jax.devices()[:1])
tr = parallel.SPMDTrainer(net, B.BERTPretrainLoss(V), "adam",
                          {"learning_rate": lr}, mesh=mesh)
# step 1's gradients: the step's own loss function at the initial values
loss_of = tr._make_loss_of()
xs = [jax.numpy.asarray(ids), jax.numpy.asarray(types)]
(l0, _), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
    tr._tr_vals, tr._aux_vals, jax.random.PRNGKey(0), xs,
    jax.numpy.asarray(labels))
for p, g in zip(tr._trainable, grads):
    out["g1/" + strip(p.name)] = np.asarray(g)
losses = []
for s in range(1, steps + 1):
    losses.append(float(np.asarray(tr.step(ids, types, labels))))
    for k, v in tr.params.items():
        out["p%d/" % s + strip(k)] = np.asarray(v)
out["losses"] = np.asarray(losses, np.float32)
np.savez(sys.argv[1], **out)
print(__import__("json").dumps({"names": names}))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX side's numbers, computed once in a child interpreter."""
    path = tmp_path_factory.mktemp("bert_ref") / "ref.npz"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(path),
         repr((CFG, B, T, LR, STEPS))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])["names"]
    with np.load(path) as z:
        data = dict(z)
    return names, data


def _params(data, step):
    pre = f"p{step}/"
    return {k[len(pre):]: v for k, v in data.items() if k.startswith(pre)}


def port_net(data):
    net = tbert.BERTForPretrain(
        tbert.BERTModel(dropout=0.0, device="cpu", **CFG), vocab_size=V)
    return load_jax_params(net, _params(data, 0))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- Dense
@pytest.mark.parametrize("flat", [0, 1])
def test_dense_tanh_matches_jax(ref, flat):
    _, data = ref
    d = Dense(5, 7, activation="tanh", flatten=bool(flat), device="cpu")
    load_jax_params(d, {"weight": data[f"dense{flat}/weight"],
                        "bias": data[f"dense{flat}/bias"]})
    with torch.no_grad():
        got = d(_t(data[f"dense{flat}/x"]))
    np.testing.assert_allclose(got.numpy(), data[f"dense{flat}/y"],
                               **FWD_TOL)


def test_dense_refuses_an_activation_that_is_not_ported():
    # every act_type of MXNet's Activation op is ported; a name outside
    # them is refused
    with pytest.raises(MXNetError, match="not ported"):
        Dense(3, 4, activation="swish", device="cpu")


def test_softmax_ce_matches_jax(ref):
    """Per-sample loss with ``weight`` and ``sample_weight``; float labels,
    one past the last class (clipped, as MXNet's ``pick`` clips)."""
    _, data = ref
    got = SoftmaxCrossEntropyLoss(weight=0.5)(
        _t(data["ce_pred"]), _t(data["ce_label"]), _t(data["ce_sw"]))
    np.testing.assert_allclose(got.numpy(), data["ce/loss"], **FWD_TOL)
    # dense labels: the one-hot rows of the (clipped) class indices give
    # the same loss
    V = data["ce_pred"].shape[-1]
    onehot = np.eye(V, dtype=np.float32)[
        np.clip(data["ce_label"].astype(np.int64), 0, V - 1)]
    dense = SoftmaxCrossEntropyLoss(sparse_label=False, weight=0.5)(
        _t(data["ce_pred"]), _t(onehot), _t(data["ce_sw"]))
    np.testing.assert_allclose(dense.numpy(), data["ce/loss"], **FWD_TOL)


# ------------------------------------------------------------- model
def test_param_names_follow_mxnet_scopes(ref):
    names, data = ref
    net = port_net(data)
    assert mx_param_names(net) == names


@pytest.mark.parametrize("tag", ["novl", "vl"])
def test_pretrain_forward_and_loss_match_jax(ref, tag):
    """MLM and NSP scores and the pretraining loss, without and with
    ``valid_length`` (one sequence of length 1)."""
    _, data = ref
    net = port_net(data)
    args = [_t(data["ids"]), _t(data["types"])]
    if tag == "vl":
        args.append(_t(data["valid"]))
    with torch.no_grad():
        mlm, nsp = net(*args)
        loss = tbert.BERTPretrainLoss(V)(mlm, nsp, _t(data["labels"]))
    assert mlm.shape == (B, T, V) and nsp.shape == (B, 2)
    np.testing.assert_allclose(mlm.numpy(), data["mlm/" + tag], **FWD_TOL)
    np.testing.assert_allclose(nsp.numpy(), data["nsp/" + tag], **FWD_TOL)
    np.testing.assert_allclose(float(loss), float(data["loss/" + tag]),
                               rtol=1e-5)
    mlm_loss = tbert.MLMPretrainLoss(V)(mlm, _t(data["labels"][:, :-1]))
    np.testing.assert_allclose(mlm_loss.numpy(), data["mlmloss/" + tag],
                               **FWD_TOL)


def test_valid_length_masks_the_padded_keys(ref):
    """Keys at and past a sequence's valid length do not reach its
    outputs: changing them leaves the valid positions unchanged."""
    _, data = ref
    net = port_net(data)
    ids = _t(data["ids"]).long()
    valid = torch.tensor([T, 1, T // 2, 37])
    other = ids.clone()
    other[2, T // 2:] = (other[2, T // 2:] + 1) % V
    with torch.no_grad():
        a = net.bert(ids, torch.zeros_like(ids), valid)[0]
        b = net.bert(other, torch.zeros_like(ids), valid)[0]
    np.testing.assert_allclose(a[2, :T // 2].numpy(), b[2, :T // 2].numpy(),
                               atol=1e-6)


def test_initialize_honours_the_position_weights_own_init():
    """``position_weight`` keeps MXNet's ``init="normal"`` (sigma 0.01)
    over the initializer passed in; the rest follow the name rules."""
    net = tbert.BERTForPretrain(
        tbert.BERTModel(dropout=0.0, device="cpu", **CFG), vocab_size=V)
    net.initialize(tinit.Normal(0.02), seed=3)
    assert 0.008 < float(net.bert.position_weight.detach().std()) < 0.012
    assert 0.018 < float(net.bert.word_embed.weight.detach().std()) < 0.022
    assert torch.all(net.mlm_ln.gamma == 1) and torch.all(net.mlm_ln.beta == 0)


# ---------------------------------------------------------- training
def _trainer(data):
    net = port_net(data)
    return net, SPMDTrainer(net, tbert.BERTPretrainLoss(V), "adam",
                            {"learning_rate": LR},
                            mesh=make_mesh({"data": 1}, devices=["cpu"]))


def test_spmd_adam_steps_match_jax(ref):
    """Three Adam steps: the losses at each step, the gradients of step 1
    and every parameter after each step (tolerances in the module
    docstring)."""
    names, data = ref
    net, tr = _trainer(data)
    batch = (data["ids"], data["types"], data["labels"])
    loss0, grads = tr._loss_and_grads(*batch)
    assert list(tr.params) == names
    g1 = {n: g for n, g in zip(tr.params, grads)}
    for n in names:
        want = data["g1/" + n]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g1[n].numpy(), want, rtol=0,
                                   atol=1e-6 + 1e-4 * scale, err_msg=n)
    losses = []
    flipped = total = 0
    for s in range(1, STEPS + 1):
        losses.append(float(tr.step(*batch)))
        want = _params(data, s)
        for n, p in tr.params.items():
            diff = np.abs(p.detach().numpy() - want[n])
            g = np.abs(data["g1/" + n])
            floor = g <= GRAD_FLOOR * g.max()
            bad = diff > PARAM_ATOL
            assert not (bad & ~floor).any(), (n, s, float(diff.max()))
            assert diff.max() <= 2 * LR * s + PARAM_ATOL, (n, s)
            flipped += int(bad.sum())
            total += diff.size
    assert tr._step_count == STEPS
    np.testing.assert_allclose(losses, data["losses"], rtol=1e-5)
    assert float(loss0) == losses[0]
    assert flipped <= FLIP_SHARE * total, (flipped, total)


def test_step_returns_a_tensor_and_updates_the_net_in_place(ref):
    _, data = ref
    net, tr = _trainer(data)
    before = net.mlm_decoder.weight.detach().clone()
    loss = tr.step(data["ids"], data["types"], data["labels"])
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0
    assert not torch.equal(before, net.mlm_decoder.weight)
    assert not net.training          # the step restores inference mode
    tr.sync_to_block()               # a no-op: nothing to copy back
    assert tr.params["dense1_weight"] is net.mlm_decoder.weight


def test_remat_gives_the_same_gradients(ref, monkeypatch):
    """``MXNET_BACKWARD_DO_MIRROR=1`` recomputes each encoder cell in the
    backward (``torch.utils.checkpoint``): the gradients equal those of
    the stored-activation run."""
    _, data = ref
    batch = (data["ids"], data["types"], data["labels"])
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "0")
    loss0, want = _trainer(data)[1]._loss_and_grads(*batch)
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    net, tr = _trainer(data)
    calls = []
    net.bert.encoder.cells[0].register_forward_pre_hook(
        lambda *a: calls.append(1))
    loss1, got = tr._loss_and_grads(*batch)
    assert len(calls) == 2           # the forward, then the recompute
    assert float(loss1) == float(loss0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7,
                                   rtol=1e-6)


@pytest.mark.parametrize("kwargs,env", [
    (dict(pipeline_axis="pipe"), None),
    (dict(zero1=True), None),
    (dict(extra_input_shardings={}), None),
    (dict(sharding_rules=[]), None),
    (dict(shard_optimizer_state=True), None),
    ({}, "MXNET_HEALTH_PLANE"),
    ({}, "MXNET_ZERO1"),
])
def test_spmd_trainer_refuses_what_is_not_ported(kwargs, env, monkeypatch):
    net = Dense(2, 3, device="cpu")
    if env is not None:
        monkeypatch.setenv(env, "1")
    with pytest.raises(MXNetError, match="not ported"):
        SPMDTrainer(net, tbert.BERTPretrainLoss(2), "adam", {},
                    mesh=make_mesh({"data": 1}, devices=["cpu"]), **kwargs)


@pytest.mark.parametrize("opt", ["sgd", "adamw", "lamb"])
def test_other_optimizers_are_refused(opt):
    with pytest.raises(MXNetError, match="not ported"):
        SPMDTrainer(Dense(2, 3, device="cpu"), tbert.BERTPretrainLoss(2),
                    opt, {}, mesh=make_mesh({"data": 1}, devices=["cpu"]))


def test_make_mesh_is_one_device_only():
    assert make_mesh({"data": -1}, devices=["cpu"]).shape == {"data": 1}
    with pytest.raises(MXNetError, match="not ported"):
        make_mesh({"data": 2}, devices=["cpu"])
    with pytest.raises(MXNetError, match="not ported"):
        make_mesh({"data": 1}, devices=["cpu", "cpu"])


# ------------------------------------------------ on the card (cuda mark)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.cuda
def test_cuda_train_step_launches_k1_k6_k7_per_layer():
    """One step of a 2-layer BERT on the card launches K1, K6 and K7 once
    per layer and agrees with the same step on the CPU."""
    _need_cuda()
    import importlib
    tfa = importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels.flash_attention")
    cfg = dict(CFG, num_heads=2)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (B, T)).astype(np.int32)
    labels = np.concatenate([rng.integers(0, V, (B, T)),
                             rng.integers(0, 2, (B, 1))], 1).astype(
                                 np.float32)
    losses = []
    for dev in ("cpu", "cuda"):
        net = tbert.BERTForPretrain(
            tbert.BERTModel(dropout=0.0, device=dev, **cfg), vocab_size=V)
        net.initialize(tinit.Normal(0.02), seed=0)
        tr = SPMDTrainer(net, tbert.BERTPretrainLoss(V), "adam",
                         {"learning_rate": LR},
                         mesh=make_mesh({"data": 1}, devices=[dev]))
        tfa.reset_launch_counts()
        loss = tr.step(ids, np.zeros_like(ids), labels)
        losses.append(float(loss))
    torch.cuda.synchronize()
    n = cfg["num_layers"]
    assert (tfa.launch_counts["flash_fwd"], tfa.launch_counts["flash_bwd_dq"],
            tfa.launch_counts["flash_bwd_dkv"]) == (n, n, n)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
