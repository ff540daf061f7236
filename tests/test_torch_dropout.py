"""Dropout draws from the port's random state (``random.py``), as the JAX
package's draws from its key stream: ``mx.random.seed`` fixes every mask
of ``gluon.nn.Dropout`` and ``nd.dropout``, ``random.get_state`` /
``set_state`` (and so a ``checkpoint.py`` resume) carry them, a
recomputed layer (``MXNET_BACKWARD_DO_MIRROR``) draws its forward's masks
again, and on the card a captured train step draws a new mask at each
replay, the one the eager step body draws from the same state (``cuda``
mark).  JAX's threefry stream is not reproduced, so nothing here is held
to the JAX package's numbers: each test compares runs of the port."""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as ag
from incubator_mxnet_tpu_torch import initializer as tinit
from incubator_mxnet_tpu_torch import random as trandom
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.checkpoint import AsyncCheckpointer
from incubator_mxnet_tpu_torch.models import bert as tbert
from incubator_mxnet_tpu_torch.models import gpt

V, B, T = 64, 2, 8
DROPOUT = 0.1
LR = 1e-2


def _gpt(dropout=DROPOUT):
    """A 2-layer GPT with fixed weights (seed 0) and fixed names."""
    mx.random.seed(0)
    net = gpt.gpt_tiny(vocab_size=V, units=32, hidden_size=64,
                       max_length=T, dropout=dropout, prefix="dgpt_")
    net.initialize(init=mx.init.Normal(0.02))
    return net


def _trainer(net):
    return mx.gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": LR})


def _step(net, trainer, i):
    """``train_gpt.py``'s step on batch ``i``; returns the loss."""
    x = np.random.RandomState(100 + i).randint(0, V, (B, T + 1))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with ag.record():
        out = net(mx.nd.array(x[:, :-1], dtype="int32"))
        L = loss_fn(out.reshape((-1, V)), mx.nd.array(
            x[:, 1:].reshape(-1).astype(np.float32))).mean()
    L.backward()
    trainer.step(1)
    return float(L.asnumpy())


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _run(seed, steps=4, dropout=DROPOUT):
    """``steps`` Gluon steps of the GPT, the masks from ``seed``."""
    with mx.cpu():
        net = _gpt(dropout)
        tr = _trainer(net)
        mx.random.seed(seed)
        losses = [_step(net, tr, i) for i in range(steps)]
        return losses, _params(net)


def _same_params(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_gluon_gpt_dropout_follows_the_seed():
    """Two runs from one seed give the same losses and weights bit for
    bit; another seed (same weights, same batches) other losses, as does
    dropout 0."""
    la, pa = _run(7)
    lb, pb = _run(7)
    assert la == lb
    _same_params(pa, pb)
    lc, _ = _run(8)
    assert lc != la
    ld, _ = _run(7, dropout=0.0)
    assert ld != la


def test_checkpoint_resume_draws_the_uninterrupted_masks(tmp_path):
    """A ``checkpoint.py`` save after step 2 (weights, Adam state and the
    random state) and a resume into a fresh net whose generator has moved
    on: steps 3 and 4 equal the uninterrupted run's bit for bit."""
    want, want_params = _run(7)
    prefix = str(tmp_path / "m")
    with mx.cpu():
        net = _gpt()
        tr = _trainer(net)
        mx.random.seed(7)
        got = [_step(net, tr, i) for i in range(2)]
        ck = AsyncCheckpointer(prefix, keep=1)
        ck.save(2, {k: p.data() for k, p in net.collect_params().items()},
                trainer=tr)
        ck.wait_until_finished()
        net2 = _gpt()
        tr2 = _trainer(net2)
        mx.random.seed(12345)
        _step(net2, tr2, 9)                  # other weights, other draws
        assert AsyncCheckpointer(prefix, keep=1).restore_into(
            params=net2.collect_params(), trainer=tr2) == 2
        got += [_step(net2, tr2, i) for i in (2, 3)]
        got_params = _params(net2)
    assert got == want
    _same_params(got_params, want_params)


@pytest.mark.parametrize("axes", [(), (0,)])
def test_layer_and_nd_masks_follow_the_random_state(axes):
    """``gluon.nn.Dropout`` (plain and with ``axes``) and ``nd.dropout``:
    a seed fixes the mask, ``get_state``/``set_state`` replay it, and
    with ``axes`` one draw is shared along the other axes."""
    with mx.cpu():
        drop = mx.gluon.nn.Dropout(0.5, axes=axes)
        x = mx.nd.ones((8, 16))

        def draw():
            with ag.train_mode():
                a = drop(x).asnumpy()
            b = mx.nd.dropout(x, p=0.5, axes=axes or None).asnumpy()
            return a, b
        mx.random.seed(3)
        first = draw()
        state = trandom.get_state()
        second = draw()
        mx.random.seed(3)
        assert all(np.array_equal(u, v) for u, v in zip(draw(), first))
        trandom.set_state(state)
        assert all(np.array_equal(u, v) for u, v in zip(draw(), second))
        assert not np.array_equal(first[0], second[0])
        if axes:                              # a mask per row, shared
            assert (first[0] == first[0][:, :1]).all()


def test_seed_and_set_state_keep_each_generator_object():
    """A CUDA graph registers a device's generator once, at capture: the
    generator must stay the same object across ``seed`` and
    ``set_state``."""
    with mx.cpu():
        g = trandom.generator("cpu")
        state = trandom.get_state()
        mx.random.seed(4)
        assert trandom.generator("cpu") is g
        trandom.set_state(state)
        assert trandom.generator("cpu") is g


def test_remat_recomputes_the_forward_masks(monkeypatch):
    """``MXNET_BACKWARD_DO_MIRROR=1`` recomputes each encoder layer in the
    backward: its dropout masks are the forward's (the port's generator
    set back for the recompute), so the gradients equal those without
    remat bit for bit."""
    labels = np.concatenate([np.random.RandomState(1).randint(0, V, (B, T)),
                             np.zeros((B, 1))], 1).astype(np.float32)
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, V, (B, T)))
    grads = []
    for mirror in ("0", "1"):
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", mirror)
        net = tbert.BERTForPretrain(
            tbert.bert_tiny(vocab_size=V, dropout=0.3, device="cpu"),
            vocab_size=V)
        net.initialize(tinit.Normal(0.02), seed=0)
        net.train()
        trandom.seed(11)
        loss = tbert.BERTPretrainLoss(V)(*net(ids, torch.zeros_like(ids)),
                                         torch.from_numpy(labels))
        params = [p for p in net.parameters()]
        grads.append(torch.autograd.grad(loss, params, allow_unused=True))
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)


def test_a_draw_outside_a_registered_capture_is_refused_by_name():
    from incubator_mxnet_tpu_torch import cuda_graphs
    with pytest.raises(MXNetError, match="did not register"):
        cuda_graphs.check_capture_draws(trandom.generator("cpu"))


# ------------------------------------------------ on the card (cuda mark)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _bert_trainer(lr):
    from incubator_mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    net = tbert.BERTForPretrain(
        tbert.BERTModel(vocab_size=V, units=64, hidden_size=128,
                        num_layers=2, num_heads=2, max_length=128,
                        dropout=DROPOUT, device="cuda"), vocab_size=V)
    net.initialize(tinit.Normal(0.02), seed=0)
    return SPMDTrainer(net, tbert.BERTPretrainLoss(V), "adam",
                       {"learning_rate": lr},
                       mesh=make_mesh({"data": 1}, devices=["cuda"]))


def _bert_batch():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, V, (8, 16)).astype(np.int32)
    labels = np.concatenate([rng.integers(0, V, (8, 16)),
                             rng.integers(0, 2, (8, 1))], 1).astype(
                                 np.float32)
    return ids, np.zeros_like(ids), labels


@pytest.mark.cuda
@pytest.mark.parametrize("lr", [0.0, 1e-3])
def test_cuda_captured_step_draws_the_eager_masks_at_each_replay(lr):
    """A 2-layer BERT at dropout 0.1 through ``SPMDTrainer``: four steps
    (the key's eager first step, its capture, three replays) from one
    port seed equal four steps of the eager step body from the same
    seed, bit for bit in every loss and weight; at lr 0 (fixed weights)
    the four losses differ: a new mask each replay."""
    _need_cuda()
    batch = _bert_batch()
    runs = []
    for eager in (True, False):
        tr = _bert_trainer(lr)
        trandom.seed(21)
        if eager:
            with tr._eager_steps():
                losses = [tr.step(*batch) for _ in range(4)]
        else:
            losses = [tr.step(*batch) for _ in range(4)]
        torch.cuda.synchronize()
        runs.append(([float(x) for x in losses],
                     [p.detach().clone() for p in tr.params.values()]))
        if not eager:
            key = tr._build_key([torch.from_numpy(b) for b in batch])
            assert tr._programs[key].replays == 3
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    if lr == 0.0:
        assert len(set(runs[1][0])) == 4, runs[1][0]


@pytest.mark.cuda
def test_cuda_a_failed_capture_leaves_the_generator_drawing():
    """A capture that fails (its body reads a value back to the host)
    raises, and the port's generator draws again afterwards: eagerly, and
    a new mask at each replay of a graph captured later."""
    _need_cuda()
    from incubator_mxnet_tpu_torch import cuda_graphs
    from incubator_mxnet_tpu_torch.ndarray.ops import dropout_tensor
    x = torch.ones(64, 64, device="cuda")
    with cuda_graphs.CAPTURE_LOCK:
        with pytest.raises(RuntimeError):
            cuda_graphs.capture(
                lambda: float(dropout_tensor(x, DROPOUT).sum()), x.device,
                torch.cuda.graph_pool_handle())
        eager = dropout_tensor(x, DROPOUT)
        # a new pool: torch keeps the failed capture's pool recording
        graph, out, _, _ = cuda_graphs.capture(
            lambda: dropout_tensor(x, DROPOUT), x.device,
            torch.cuda.graph_pool_handle())
    masks = []
    for _ in range(2):
        graph.replay()
        masks.append(out.clone())
    torch.cuda.synchronize()
    assert bool((eager == 0).any()) and not torch.equal(masks[0], masks[1])


@pytest.mark.cuda
def test_cuda_replays_after_a_seed_resume_from_a_checkpoint(tmp_path):
    """A graph captured before ``seed``, then only replayed (no draw from
    Python): the replays move the card's generator, a ``checkpoint.py``
    save carries its state, and a resume after other replays gives the
    masks of the uninterrupted run."""
    _need_cuda()
    from incubator_mxnet_tpu_torch import cuda_graphs
    from incubator_mxnet_tpu_torch.ndarray.ops import dropout_tensor
    x = torch.ones(64, 64, device="cuda")
    with cuda_graphs.CAPTURE_LOCK:
        graph, out, _, _ = cuda_graphs.capture(
            lambda: dropout_tensor(x, DROPOUT), x.device,
            torch.cuda.graph_pool_handle())

    def masks(k):
        got = []
        for _ in range(k):
            graph.replay()
            got.append(out.clone())
        torch.cuda.synchronize()
        return got
    trandom.seed(31)
    masks(2)
    prefix = str(tmp_path / "m")
    ck = AsyncCheckpointer(prefix, keep=1)
    ck.save(1, {"w": mx.nd.array(np.ones((2,), np.float32))}, epoch=0)
    ck.wait_until_finished()
    want = masks(2)
    trandom.seed(99)
    masks(3)                                  # the generator moves on
    assert AsyncCheckpointer(prefix, keep=1).restore_into(step=1) == 1
    got = masks(2)
    assert not torch.equal(want[0], want[1])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
