"""The port's train step as one update and one program
(``incubator_mxnet_tpu_torch``: ``optimizer/fused.py``,
``parallel/optim.py``, ``parallel/spmd.py``) against the per-leaf loop
and the JAX package, fp32 on the CPU; and, on a card (``cuda`` marker),
kernel K8 and the step's CUDA graphs against their eager versions.

* The whole-tree plain Adam equals the per-leaf ``cores.prep_grad`` +
  ``cores.adam`` loop bit for bit, with rescale, clip and wd on and off,
  on leaves whose sizes are no multiple of any chunk.
* The update, its bias-corrected lr and an ``lr_schedule`` equal JAX
  ``parallel.optim.adam(...).update`` on the same numpy w, g, m, v at
  steps 1..3, within 1e-6 relative (of each tensor's largest value).
* ``accum_steps`` 2 and 4 at ``bert_tiny`` width equal the JAX
  ``SPMDTrainer(accum_steps=k)``: losses and parameters after 2 steps to
  ``test_parallel.py::test_accum_steps_matches_full_batch``'s tolerances
  (losses 1e-4 relative; parameters rtol 2e-5, atol 2e-6).  As in
  ``test_torch_bert.py``, an element whose full-batch step-1 gradient
  sits at the rounding floor (below 1e-4 of its tensor's largest) may
  step the other way in Adam: such elements may differ by up to 2 lr
  per step, and must stay under 0.1 % of all elements.  The microbatch
  split equals JAX's exactly.

The JAX trainers run in a child interpreter, once per module, with
every ``MXNET_*`` variable unset; the child writes its numbers to an
``.npz`` under ``tmp_path``.  In-process JAX calls are pure functions
only (the functional optimizer's ``init``/``update``)."""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import initializer as tinit
from incubator_mxnet_tpu_torch import random as trandom
from incubator_mxnet_tpu_torch import telemetry, telemetry_device
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import bert as tbert
from incubator_mxnet_tpu_torch.optimizer import cores, fused
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
from incubator_mxnet_tpu_torch.parallel import optim as topt
from incubator_mxnet_tpu_torch.parallel.spmd import microbatches

tfa = importlib.import_module(
    "incubator_mxnet_tpu_torch.kernels.flash_attention")

ROOT = Path(__file__).resolve().parents[1]
V, B, T = 1024, 8, 16
LR, STEPS, KS = 1e-3, 2, (2, 4)
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_FLOOR = 1e-4       # of the tensor's largest gradient
FLIP_SHARE = 1e-3
JAX_RTOL = 1e-6
# leaf shapes whose sizes are no multiple of a chunk (K8's 16384) nor of 4
SHAPES = [(3,), (17, 5), (1000, 3), (16385,), (7, 11, 13), (1,), (33, 129)]
# (rescale, clip, wd): every stage off, each alone, all on
STAGES = [(1.0, None, 0.0), (0.5, None, 0.0), (1.0, 0.003, 0.0),
          (1.0, None, 0.01), (0.25, 0.004, 0.02)]

_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import sys
import numpy as np
import jax.numpy as jnp
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import parallel
from incubator_mxnet_tpu.models import bert as B

V, nb, nt, lr, steps, ks = eval(sys.argv[2])
out = {}
mx.random.seed(0)
net = B.BERTForPretrain(B.bert_tiny(vocab_size=V, dropout=0.0), vocab_size=V)
net.initialize(init=mx.init.Normal(0.02))
rng = np.random.default_rng(0)
ids = rng.integers(0, V, (nb, nt)).astype(np.int32)
types = np.zeros((nb, nt), np.int32)
labels = np.concatenate([rng.integers(0, V, (nb, nt)),
                         rng.integers(0, 2, (nb, 1))], axis=1).astype(
                             np.float32)
out.update(ids=ids, types=types, labels=labels)
pre = net.prefix


def strip(name):
    return name[len(pre):] if name.startswith(pre) else name


names = [strip(n) for n in net.collect_params()]
for k, p in net.collect_params().items():
    out["p0/" + strip(k)] = p.data().asnumpy()
mesh = parallel.make_mesh({"data": 1}, devices=jax.devices()[:1])
for k in ks:
    # each trainer starts from the net's values: a step leaves the Block's
    # parameters as they are (no sync_to_block)
    tr = parallel.SPMDTrainer(net, B.BERTPretrainLoss(V), "adam",
                              {"learning_rate": lr}, mesh=mesh,
                              accum_steps=k)
    if k == ks[0]:
        # the full batch's step-1 gradients: the rounding floor's scale
        loss_of = tr._make_loss_of()
        (_, _), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
            tr._tr_vals, tr._aux_vals, jax.random.PRNGKey(0),
            [jnp.asarray(ids), jnp.asarray(types)], jnp.asarray(labels))
        for p, g in zip(tr._trainable, grads):
            out["g1/" + strip(p.name)] = np.asarray(g)
    losses = []
    for s in range(1, steps + 1):
        losses.append(float(np.asarray(tr.step(ids, types, labels))))
    for n, v in tr.params.items():
        out["k%d/p/" % k + strip(n)] = np.asarray(v)
    out["k%d/losses" % k] = np.asarray(losses, np.float32)

    # JAX's own microbatch split of an arange batch: a loss whose aux
    # carry is a shift register of the microbatches the scan hands it
    def recorder(tr_vals, aux_cur, rng_i, xs, label):
        loss = jnp.sum(tr_vals[0]) * 0.0
        return loss, (jnp.concatenate([aux_cur[0][1:], xs[0][None]]),)

    tr._make_loss_of = lambda: recorder
    grad_of = tr._make_grad_fn()
    a = np.arange(nb * nt * 3, dtype=np.int32).reshape(nb, nt, 3)
    _, aux, _ = grad_of(tr._tr_vals, (jnp.zeros((k, nb // k, nt, 3),
                                                jnp.int32),),
                        jax.random.PRNGKey(0), [jnp.asarray(a)],
                        jnp.zeros((nb, 1), jnp.float32))
    out["split%d" % k] = np.asarray(aux[0])
np.savez(sys.argv[1], **out)
print(__import__("json").dumps({"names": names}))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX trainers' numbers, computed once in a child interpreter."""
    path = tmp_path_factory.mktemp("accum_ref") / "ref.npz"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(path),
         repr((V, B, T, LR, STEPS, KS))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])["names"]
    with np.load(path) as z:
        data = dict(z)
    return names, data


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaves(seed, shapes=SHAPES, device="cpu"):
    """Random fp32 (w, g, m, v) leaf lists from ``seed`` (v > 0)."""
    rng = np.random.RandomState(seed)
    out = []
    for scale in (1.0, 0.01, 0.001, 1e-4):
        arrs = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
        out.append([_t(a).to(device) for a in arrs])
    out[3] = [v.abs() for v in out[3]]
    return out


def _clone(leaves):
    return [[t.clone() for t in ts] for ts in leaves]


# ---------------------------------------------------- the whole-tree update
@pytest.mark.parametrize("stages", STAGES)
def test_plain_whole_tree_adam_equals_per_leaf_loop(stages):
    """``fused.adam_update`` on the CPU is the per-leaf loop of
    ``cores.prep_grad`` + ``cores.adam`` at the host-float lr the port's
    step used before, bit for bit."""
    rescale, clip, wd = stages
    w, g, m, v = _leaves(1)
    lr_t = torch.tensor(3.7e-4, dtype=torch.float32)
    want = _clone((w, m, v))
    with torch.no_grad():
        for wl, gl, ml, vl in zip(want[0], g, want[1], want[2]):
            gp = cores.prep_grad(gl, rescale if rescale != 1.0 else None,
                                 clip, wd or None, wl)
            cores.adam(wl, gp, ml, vl, float(lr_t), 0.9, 0.999, 1e-8)
    g_before = _clone([g])[0]
    fused.adam_update(w, g, m, v, lr_t, 0.9, 0.999, 1e-8, rescale, clip,
                      wd)
    for got, exp in zip((w, m, v), want):
        for a, b in zip(got, exp):
            assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(g, g_before))


def test_adam_update_rejects_mismatched_leaf_lists():
    w, g, m, v = _leaves(2, SHAPES[:2])
    with pytest.raises(MXNetError, match="leaves"):
        fused.adam_update(w, g[:1], m, v, torch.tensor(1e-3))


def _jax_adam(step, stages, w, g, m, v, lr_schedule=None):
    """JAX ``parallel.optim.adam``'s update (pure) on numpy leaves."""
    import jax.numpy as jnp
    from incubator_mxnet_tpu.parallel import optim as jopt
    rescale, clip, wd = stages
    opt = jopt.adam(learning_rate=LR, wd=wd, rescale_grad=rescale,
                    clip_gradient=clip, lr_schedule=lr_schedule)
    state = {"m": [jnp.asarray(a) for a in m],
             "v": [jnp.asarray(a) for a in v]}
    new_p, new_s = opt.update([jnp.asarray(a) for a in w],
                              [jnp.asarray(a) for a in g], state,
                              jnp.asarray(step, jnp.int32))
    return tuple([np.asarray(a) for a in leaves]
                 for leaves in (new_p, new_s["m"], new_s["v"]))


def _close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=JAX_RTOL,
                                   atol=JAX_RTOL * scale,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("step", [1, 2, 3])
@pytest.mark.parametrize("stages", [STAGES[0], STAGES[-1]])
def test_adam_update_matches_jax(step, stages):
    """The functional update (a 0-d int32 step tensor, lr_t on the
    device) against JAX's on the same numpy leaves."""
    rescale, clip, wd = stages
    w, g, m, v = _leaves(3)
    arrs = [[t.numpy().copy() for t in ts] for ts in (w, g, m, v)]
    opt = topt.adam(learning_rate=LR, wd=wd, rescale_grad=rescale,
                    clip_gradient=clip)
    opt.update(w, g, {"m": m, "v": v}, torch.tensor(step, dtype=torch.int32))
    jw, jm, jv = _jax_adam(step, stages, *arrs)
    _close(w, jw, "w")
    _close(m, jm, "m")
    _close(v, jv, "v")


@pytest.mark.parametrize("step", [1, 2, 3, 1000])
def test_bias_corrected_lr_matches_jax(step):
    """lr * sqrt(1 - b2^t) / (1 - b1^t) in fp32 from the step tensor, as
    the JAX update computes it from the traced step."""
    import jax.numpy as jnp
    t = jnp.asarray(step, jnp.int32).astype(jnp.float32)
    want = LR * (jnp.sqrt(1.0 - 0.999 ** t) / (1.0 - 0.9 ** t))
    got = topt.bias_corrected_lr(LR, 0.9, 0.999,
                                 torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=JAX_RTOL)


@pytest.mark.parametrize("step", [1, 2, 3])
def test_lr_schedule_matches_jax(step):
    """A schedule of the step tensor (0.2 / step), the same callable in
    both packages' terms, gives the same update."""
    w, g, m, v = _leaves(4)
    arrs = [[t.numpy().copy() for t in ts] for ts in (w, g, m, v)]
    opt = topt.adam(learning_rate=LR,
                    lr_schedule=lambda s: 0.2 / s.to(torch.float32))
    opt.update(w, g, {"m": m, "v": v}, torch.tensor(step, dtype=torch.int32))
    jw, jm, jv = _jax_adam(step, STAGES[0], *arrs,
                           lr_schedule=lambda s: 0.2 / s.astype("float32"))
    _close(w, jw, "w")
    _close(m, jm, "m")
    _close(v, jv, "v")


# --------------------------------------------------------- accumulation
def _params(data, prefix):
    return {k[len(prefix):]: v for k, v in data.items()
            if k.startswith(prefix)}


def _tiny_net(data=None, device="cpu", dropout=0.0, seed=0):
    net = tbert.BERTForPretrain(
        tbert.bert_tiny(vocab_size=V, dropout=dropout, device=device),
        vocab_size=V)
    if data is None:
        return net.initialize(tinit.Normal(0.02), seed=seed)
    return load_jax_params(net, _params(data, "p0/"))


def _trainer(net, device="cpu", **kw):
    return SPMDTrainer(net, tbert.BERTPretrainLoss(V), "adam",
                       {"learning_rate": LR},
                       mesh=make_mesh({"data": 1}, devices=[device]), **kw)


@pytest.mark.parametrize("k", KS)
def test_accum_steps_match_jax(ref, k):
    names, data = ref
    net = _tiny_net(data)
    tr = _trainer(net, accum_steps=k)
    assert tr.accum_steps == k and list(tr.params) == names
    batch = (data["ids"], data["types"], data["labels"])
    losses = [float(tr.step(*batch)) for _ in range(STEPS)]
    want = data[f"k{k}/losses"]
    for got, exp in zip(losses, want):
        assert abs(got - exp) <= LOSS_RTOL * max(1.0, abs(exp)), (got, exp)
    flipped = total = 0
    for n, p in tr.params.items():
        exp = data[f"k{k}/p/{n}"]
        got = p.detach().numpy()
        bad = ~np.isclose(got, exp, **PARAM_TOL)
        g = np.abs(data["g1/" + n])
        floor = g <= GRAD_FLOOR * g.max()
        assert not (bad & ~floor).any(), (n, float(np.abs(got - exp).max()))
        assert np.abs(got - exp).max() <= 2 * LR * STEPS + 2e-6, n
        flipped += int(bad.sum())
        total += got.size
    assert flipped <= FLIP_SHARE * total, (flipped, total)


@pytest.mark.parametrize("k", KS)
def test_microbatch_split_matches_jax(ref, k):
    """Microbatch i holds rows i, i + k, ... of the batch: JAX's split of
    an arange batch, exactly."""
    _, data = ref
    a = np.arange(B * T * 3, dtype=np.int32).reshape(B, T, 3)
    got = microbatches(_t(a), k)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), data[f"split{k}"])


def test_accum_steps_full_batch_grads_are_the_microbatch_mean():
    """k = 2 gives the mean of the two microbatches' gradients, each
    computed alone (fp32, summed then halved as JAX does)."""
    net = _tiny_net()
    rng = np.random.default_rng(1)
    ids = rng.integers(0, V, (B, T)).astype(np.int32)
    labels = np.concatenate([rng.integers(0, V, (B, T)),
                             rng.integers(0, 2, (B, 1))], 1).astype(
                                 np.float32)
    types = np.zeros_like(ids)
    loss, grads = _trainer(net, accum_steps=2)._loss_and_grads(
        ids, types, labels)
    plain = _trainer(net)
    parts = [plain._loss_and_grads(ids[i::2], types[i::2], labels[i::2])
             for i in range(2)]
    assert torch.equal(loss, (parts[0][0] + parts[1][0]) / 2)
    for i, g in enumerate(grads):
        assert torch.equal(g, (parts[0][1][i] + parts[1][1][i]) / 2)


@pytest.mark.parametrize("bad", [0, -1])
def test_accum_steps_below_one_is_refused(bad):
    with pytest.raises(MXNetError, match="must be >= 1"):
        _trainer(_tiny_net(), accum_steps=bad)


def test_batch_that_accum_steps_does_not_divide_is_refused():
    tr = _trainer(_tiny_net(), accum_steps=4)
    ids = np.zeros((6, T), np.int32)
    labels = np.zeros((6, T + 1), np.float32)
    with pytest.raises(MXNetError, match="must divide by accum_steps 4"):
        tr.step(ids, ids, labels)
    assert tr._step_count == 0


# ------------------------------------------------------- step semantics
def _batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (b, T)).astype(np.int32)
    labels = np.concatenate([rng.integers(0, V, (b, T)),
                             rng.integers(0, 2, (b, 1))], 1).astype(
                                 np.float32)
    return ids, np.zeros_like(ids), labels


def test_a_held_loss_keeps_its_value_after_later_steps():
    tr = _trainer(_tiny_net())
    first = tr.step(*_batch())
    kept = first.clone()
    second = tr.step(*_batch())
    assert torch.equal(first, kept) and not torch.equal(first, second)


def test_reload_params_makes_the_next_step_use_the_new_weights():
    """After the net's tensors are replaced (``load_state_dict`` with
    ``assign``), ``reload_params`` points the step at them: its loss is
    the new weights' loss, and it updates the new tensors in place."""
    net = _tiny_net(seed=0)
    tr = _trainer(net)
    batch = _batch(1)
    tr.step(*batch)
    other = _tiny_net(seed=5)
    want, _ = _trainer(other)._loss_and_grads(*batch)
    net.load_state_dict(other.state_dict(), assign=True)
    tr.reload_params()
    name = "dense1_weight"
    assert tr.params[name] is net.mlm_decoder.weight
    before = net.mlm_decoder.weight.detach().clone()
    loss = tr.step(*batch)
    assert torch.equal(loss, want)
    assert not torch.equal(before, net.mlm_decoder.weight)
    assert tr._step_count == 2


def test_reload_params_refuses_a_different_tree():
    tr = _trainer(_tiny_net())
    net2 = tbert.BERTForPretrain(
        tbert.BERTModel(vocab_size=V, units=32, hidden_size=64,
                        num_layers=1, num_heads=2, dropout=0.0,
                        device="cpu"), vocab_size=V)
    tr._net = net2
    with pytest.raises(MXNetError, match="changed names or shapes"):
        tr.reload_params()


def test_step_publishes_spans_event_gauges_and_owner():
    """``spmd.step`` with its ``spmd.shard_batch`` child, the TRAINER
    event, the optimizer gauges, the ``spmd`` ledger row and the
    ``optimizer`` device-memory owner."""
    telemetry.reset()
    events = []

    def on_step(**kw):
        events.append(kw)

    telemetry.TRAINER.subscribe(on_step)
    telemetry.tracer.enable()
    try:
        tr = _trainer(_tiny_net())
        tr.step(*_batch())
        tr.step(*_batch())
        tree = telemetry.tracer.tree()
    finally:
        telemetry.tracer.disable()
        telemetry.TRAINER.unsubscribe(on_step)
    roots = [s for s in tree["finished"] if s["name"] == "spmd.step"]
    assert len(roots) == 2 and roots[0]["cat"] == "trainer"
    assert [c["name"] for c in roots[0]["children"]] == ["spmd.shard_batch"]
    assert roots[0]["children"][0]["cat"] == "transfer"
    assert [e["phase"] for e in events] == ["step", "step"]
    assert all(e["seconds"] > 0 for e in events)
    reg = telemetry.registry
    assert reg.get("mxtpu_optimizer_dispatches_per_step").value == 1
    state = tr.optimizer_state_bytes()
    assert state == 2 * 4 * sum(p.numel() for p in tr.params.values())
    assert reg.get("mxtpu_optimizer_state_bytes").value == state
    assert telemetry_device.owned_bytes()["optimizer"] == state
    assert telemetry.dispatch_ledger("spmd")["spmd"]["dispatches"] == 2
    telemetry.reset()


def test_optimizer_owner_does_not_keep_the_trainer_alive():
    import gc
    import weakref
    tr = _trainer(_tiny_net())
    ref = weakref.ref(tr)
    del tr
    gc.collect()
    assert ref() is None
    assert telemetry_device.owned_bytes()["optimizer"] == 0


# ------------------------------------------------ on the card (cuda mark)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _k8_against_plain(shapes, stages, seed):
    w, g, m, v = _leaves(seed, shapes, device="cuda")
    want = _clone((w, m, v))
    lr_t = torch.tensor(3.7e-4, dtype=torch.float32, device="cuda")
    fused._plain_adam_update(want[0], g, want[1], want[2], lr_t, 0.9, 0.999,
                             1e-8, *stages)
    tfa.reset_launch_counts()
    fused.adam_update(w, g, m, v, lr_t, 0.9, 0.999, 1e-8, *stages)
    torch.cuda.synchronize()
    assert tfa.launch_counts["multi_tensor_adam"] == 1
    for what, got, exp in zip("wmv", (w, m, v), want):
        for i, (a, b) in enumerate(zip(got, exp)):
            assert torch.equal(a, b), (what, i, tuple(a.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("stages", STAGES)
def test_cuda_k8_equals_plain_bit_for_bit(stages):
    """K8 on a mixed list of leaf shapes, one of them unaligned (a view
    at an odd offset): the plain version's values bit for bit."""
    _need_cuda()
    _k8_against_plain(SHAPES, stages, 6)
    # an unaligned leaf: the scalar path
    w, g, m, v = _leaves(7, [(4099,)], device="cuda")
    odd = [torch.cat([t.new_zeros(1), t])[1:] for t in (w[0], g[0], m[0],
                                                        v[0])]
    assert odd[0].data_ptr() % 16
    want = [t.clone() for t in odd]
    lr_t = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
    fused._plain_adam_update([want[0]], [odd[1]], [want[2]], [want[3]],
                             lr_t, 0.9, 0.999, 1e-8, *stages)
    fused.adam_update([odd[0]], [odd[1]], [odd[2]], [odd[3]], lr_t, 0.9,
                      0.999, 1e-8, *stages)
    for i in (0, 2, 3):
        assert torch.equal(odd[i], want[i])


@pytest.mark.cuda
def test_cuda_k8_on_bert_large_leaves():
    """K8 over BERT-large's (with the pretraining heads) 399 leaf shapes,
    one launch, bit for bit."""
    _need_cuda()
    net = tbert.BERTForPretrain(tbert.bert_large(dropout=0.0,
                                                 device="cuda"),
                                vocab_size=30522)
    shapes = [tuple(p.shape) for p in net.parameters()]
    assert len(shapes) == 399
    _k8_against_plain(shapes, STAGES[-1], 8)


@pytest.mark.cuda
def test_cuda_k8_refuses_what_it_cannot_take():
    _need_cuda()
    w, g, m, v = _leaves(9, SHAPES[:2], device="cuda")
    with pytest.raises(MXNetError, match="lr_t"):
        fused.adam_update(w, g, m, v, torch.tensor(1e-3))
    with pytest.raises(MXNetError, match="contiguous fp32"):
        fused.adam_update(w, [g[0].double(), g[1]], m, v,
                          torch.tensor(1e-3, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2, 30522])
def test_cuda_embedding_gradient_is_deterministic(rows):
    """BERT-large's token-type (every id 0) and word tables at B=32,
    T=128: four gradients of one lookup are equal bit for bit."""
    _need_cuda()
    from incubator_mxnet_tpu_torch.gluon.nn import Embedding
    emb = Embedding(rows, 1024, device="cuda")
    torch.nn.init.normal_(emb.weight)
    ids = torch.randint(0, rows, (32, 128), device="cuda",
                        dtype=torch.int32) if rows > 2 else \
        torch.zeros(32, 128, device="cuda", dtype=torch.int32)
    g = torch.randn(32, 128, 1024, device="cuda")
    grads = [torch.autograd.grad(emb(ids), emb.weight, g)[0]
             for _ in range(4)]
    assert all(torch.equal(grads[0], x) for x in grads[1:])


def _cuda_pair(accum, dropout=0.0, layers=2):
    """Two trainers over one 2-layer BERT's weights (seed 0): the first
    runs its step bodies eagerly, the second through the graphs."""
    nets = []
    for _ in range(2):
        net = tbert.BERTForPretrain(
            tbert.BERTModel(vocab_size=V, units=64, hidden_size=128,
                            num_layers=layers, num_heads=2, max_length=128,
                            dropout=dropout, device="cuda"), vocab_size=V)
        nets.append(net.initialize(tinit.Normal(0.02), seed=0))
    return [(n, _trainer(n, "cuda", accum_steps=accum)) for n in nets]


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [1, 2])
def test_cuda_graph_steps_equal_the_eager_body(accum):
    """Three steps: graph replays (after the eager first step of the key)
    equal the body run eagerly, bit for bit, in every loss and parameter;
    each replay tallies K1, K6, K7 layers x k times and K8 once."""
    _need_cuda()
    (ne, te), (ng, tg) = _cuda_pair(accum)
    batch = _batch(2, b=8)
    with te._eager_steps():
        le = [te.step(*batch) for _ in range(3)]
    lg = [tg.step(*batch)]
    tfa.reset_launch_counts()
    lg += [tg.step(*batch) for _ in range(2)]
    torch.cuda.synchronize()
    counts = dict(tfa.launch_counts)
    for a, b in zip(le, lg):
        assert torch.equal(a, b), (float(a), float(b))
    for (n, a), b in zip(te.params.items(), tg.params.values()):
        assert torch.equal(a, b), n
    n = 2 * accum * 2
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] \
        == counts["flash_bwd_dkv"] == n, counts
    assert counts["multi_tensor_adam"] == 2, counts
    assert tg._programs[tg._build_key(
        [torch.from_numpy(b) for b in batch])].replays == 2
    assert tg.graph_pool_bytes() > 0
    assert tg._step_count == 3 and int(tg._step_dev) == 3


@pytest.mark.cuda
def test_cuda_held_loss_keeps_its_value_across_a_replay():
    _need_cuda()
    (_, tr), _ = _cuda_pair(1)
    batch = _batch(3, b=8)
    tr.step(*batch)
    first = tr.step(*batch)          # a replay
    kept = first.clone()
    tr.step(*batch)
    torch.cuda.synchronize()
    assert torch.equal(first, kept)


@pytest.mark.cuda
def test_cuda_a_new_batch_shape_is_a_new_graph():
    _need_cuda()
    _, (_, tr) = _cuda_pair(1)      # the ledger row follows the newest
    for b in (8, 4, 8, 4):
        tr.step(*_batch(4, b=b))
    assert len(tr._programs) == 2
    assert sorted(p.replays for p in tr._programs.values()) == [1, 1]
    assert telemetry.dispatch_ledger("spmd")["spmd"]["compiled"] == 2


@pytest.mark.cuda
def test_cuda_reload_params_drops_the_graphs():
    """After the net's tensors are replaced, ``reload_params`` drops the
    captured step (which writes to the old addresses): the next step is
    captured anew over the new tensors, its loss is theirs, and the old
    tensors stay as they were."""
    _need_cuda()
    (net, tr), (other, _) = _cuda_pair(1)
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(0.5)
    batch = _batch(9, b=8)
    tr.step(*batch)
    tr.step(*batch)                   # a replay
    old = [p.detach().clone() for p in tr.params.values()]
    old_tensors = list(tr.params.values())
    want, _ = _trainer(other, "cuda")._loss_and_grads(*batch)
    net.load_state_dict(other.state_dict(), assign=True)
    tr.reload_params()
    assert not tr._programs and tr.graph_pool_bytes() == 0
    new_w = net.mlm_decoder.weight
    before = new_w.detach().clone()
    loss = tr.step(*batch)            # eager, then captured anew
    tr.step(*batch)                   # a replay of the new graph
    torch.cuda.synchronize()
    assert torch.equal(loss, want)
    assert tr.params["dense1_weight"] is new_w
    assert not torch.equal(new_w, before)
    assert all(torch.equal(a, b) for a, b in zip(old_tensors, old))


@pytest.mark.cuda
def test_cuda_dropout_draws_fresh_masks_at_each_replay():
    """At dropout 0.1, replays of one graph on one batch with the weights
    held fixed (lr 0) give different losses, without error."""
    _need_cuda()
    net = tbert.BERTForPretrain(
        tbert.BERTModel(vocab_size=V, units=64, hidden_size=128,
                        num_layers=2, num_heads=2, max_length=128,
                        dropout=0.1, device="cuda"), vocab_size=V)
    net.initialize(tinit.Normal(0.02), seed=0)
    tr = SPMDTrainer(net, tbert.BERTPretrainLoss(V), "adam",
                     {"learning_rate": 0.0},
                     mesh=make_mesh({"data": 1}, devices=["cuda"]))
    batch = _batch(5, b=8)
    losses = [float(tr.step(*batch)) for _ in range(4)]
    assert len(set(losses[1:])) == 3, losses


@pytest.mark.cuda
def test_cuda_remat_under_capture(monkeypatch):
    """``MXNET_BACKWARD_DO_MIRROR=1`` (``torch.utils.checkpoint`` per
    encoder cell) runs inside the graph: three graph steps equal the
    eager body bit for bit, and each replay launches K1 twice per layer
    (forward and recompute)."""
    _need_cuda()
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    (_, te), (_, tg) = _cuda_pair(1)
    batch = _batch(6, b=8)
    with te._eager_steps():
        le = [te.step(*batch) for _ in range(3)]
    lg = [tg.step(*batch)]
    tfa.reset_launch_counts()
    lg += [tg.step(*batch) for _ in range(2)]
    torch.cuda.synchronize()
    assert [float(x) for x in le] == [float(x) for x in lg]
    for a, b in zip(te.params.values(), tg.params.values()):
        assert torch.equal(a, b)
    assert tfa.launch_counts["flash_fwd"] == 2 * 2 * 2


@pytest.mark.cuda
def test_cuda_remat_with_dropout_recomputes_the_forward_masks(monkeypatch):
    """At dropout 0.1 the recompute inside the graph draws the masks its
    forward drew: from one RNG seed, three steps with
    ``MXNET_BACKWARD_DO_MIRROR=1`` equal three without it, bit for bit."""
    _need_cuda()
    batch = _batch(8, b=8)
    runs = []
    for mirror in ("1", "0"):
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", mirror)
        net = tbert.BERTForPretrain(
            tbert.BERTModel(vocab_size=V, units=64, hidden_size=128,
                            num_layers=2, num_heads=2, max_length=128,
                            dropout=0.1, device="cuda"), vocab_size=V)
        tr = _trainer(net.initialize(tinit.Normal(0.02), seed=0), "cuda")
        trandom.seed(11)                  # the port's generators: dropout
        losses = [float(tr.step(*batch)) for _ in range(3)]
        runs.append((losses, list(tr.params.values())))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_a_failed_capture_raises_naming_the_key():
    """A loss that reads a value back to the host cannot be captured: the
    step raises MXNetError naming the batch key, after the eager first
    step, and never falls back to eager."""
    _need_cuda()

    class SyncingLoss(tbert.BERTPretrainLoss):
        def forward(self, *args):
            out = super().forward(*args)
            float(out.sum())
            return out

    net = _cuda_pair(1)[0][0]
    tr = SPMDTrainer(net, SyncingLoss(V), "adam", {"learning_rate": LR},
                     mesh=make_mesh({"data": 1}, devices=["cuda"]))
    with pytest.raises(MXNetError, match=r"batch key \[8, 16\] int32"):
        tr.step(*_batch(7, b=8))
    assert tr._step_count == 1
    with pytest.raises(MXNetError, match="capture"):
        tr.step(*_batch(7, b=8))
    assert tr._step_count == 1
