"""The port's ``CompiledLoop`` (``parallel/loop.py``) and
``DevicePrefetcher`` (``io/prefetch.py``) on the CPU: the counterparts of
``tests/test_compiled_loop.py``'s contracts (chunking invariance, the
short tail and a prefetched run, the learning rate per inner step, the
in-chunk non-finite guard, mid-chunk resume and the refusal of a foreign
blob, the eight prefetcher contracts, one dispatch per chunk and MFU),
and the port's loop against the JAX ``CompiledLoop`` over 8 steps with
``loop_steps=4``, for SGD with momentum and for LAMB, from the same
weights (``convert.load_jax_params``).

The net is an MLP (8 -> 32 relu -> 4, L2 loss), fp32.  The JAX side runs
in a child interpreter once per module (this file as a script, every
``MXNET_*`` variable unset) and writes its weights, losses and parameters
to an ``.npz`` under ``tmp_path``.  Parity tolerance (fp32; the two
frameworks' matrix products sum in other orders): losses rtol
``LOSS_RTOL``, parameters within ``PARAM_ATOL`` + ``PARAM_RTOL`` of the
JAX value.  Within the port, a chunk of k steps equals k single steps bit
for bit.

Cards: the ``cuda``-marked tests decide inside the test whether a card
is present (chunk graphs against per-step graphs bit for bit, the guard
in the graph, the pinned prefetch path)."""
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_registry_hygiene import registry_hygiene  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
OPT = {"learning_rate": 0.1, "momentum": 0.9}
LAMB = {"learning_rate": 0.01, "wd": 0.01}
RULES = [("sgd", OPT), ("lamb", LAMB)]
IN, HID, OUT, B = 8, 32, 4, 8
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5


def _train_batches(n, b=B):
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((b, IN)).astype(np.float32),
             rng.standard_normal((b, OUT)).astype(np.float32))
            for _ in range(n)]


# ------------------------------------------------------------ JAX side
def _jax_child(out_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu import parallel
    from incubator_mxnet_tpu.gluon import loss as gloss, nn
    from incubator_mxnet_tpu.parallel.loop import CompiledLoop
    mesh = parallel.make_mesh({"data": 1}, devices=jax.devices()[:1])
    out = {}
    batches = _train_batches(8)
    for rule, kw in RULES:
        mx.random.seed(0)
        net = nn.HybridSequential(prefix=f"jx{rule}_")
        with net.name_scope():
            net.add(nn.Dense(HID, in_units=IN, activation="relu"))
            net.add(nn.Dense(OUT, in_units=HID))
        net.initialize(init=mx.init.Normal(0.3))
        pre = net.prefix
        for k, p in net.collect_params().items():
            out[f"{rule}/p0/{k[len(pre):]}"] = p.data().asnumpy().copy()
        loop = CompiledLoop(net, gloss.L2Loss(), rule, dict(kw),
                            loop_steps=4, mesh=mesh)
        out[f"{rule}/losses"] = np.asarray(loop.run(batches, prefetch=False))
        for k, v in loop.params.items():
            out[f"{rule}/p8/{k[len(pre):]}"] = np.asarray(v)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_loop") / "ref.npz"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, __file__, "--jax", str(path)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


# ----------------------------------------------------------- port side
@pytest.fixture(autouse=True)
def _clean_state():
    from incubator_mxnet_tpu_torch import fault, telemetry
    fault.clear_plan()
    telemetry.stop()
    telemetry.reset()
    threads = set(threading.enumerate())
    yield
    fault.clear_plan()
    telemetry.stop()
    telemetry.reset()
    # every prefetch worker a test started is joined
    left = [t.name for t in threading.enumerate()
            if t not in threads and t.is_alive()
            and t.name == "mxtpu-prefetch"]
    assert not left, left


def _mesh():
    from incubator_mxnet_tpu_torch.parallel import make_mesh
    return make_mesh({"data": 1}, devices=["cpu"])


def _net(prefix, seed=0, dropout=0.0, device="cpu"):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon import nn
    with (mx.cpu() if device == "cpu" else mx.gpu(0)):
        mx.random.seed(seed)
        net = nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(nn.Dense(HID, in_units=IN, activation="relu"))
            if dropout:
                net.add(nn.Dropout(dropout))
            net.add(nn.Dense(OUT, in_units=HID))
        net.initialize(init=mx.init.Normal(0.3))
    return net


def _loop(net, k, opt="sgd", kw=OPT, mesh=None, **extra):
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.parallel.loop import CompiledLoop
    return CompiledLoop(net, gloss.L2Loss(), opt, dict(kw) if isinstance(
        kw, dict) else kw, loop_steps=k, mesh=mesh or _mesh(), **extra)


def _params(trainer):
    return {n: p.detach().clone() for n, p in trainer.params.items()}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("rule,kw", RULES, ids=[r for r, _ in RULES])
def test_loop_matches_jax_compiled_loop(ref, rule, kw):
    """8 steps as 2 chunks of 4 from the JAX weights: the losses and the
    parameters of the JAX ``CompiledLoop`` within the stated tolerance."""
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    net = _net(f"pt{rule}_")
    load_jax_params(net, {k[len(f"{rule}/p0/"):]: v for k, v in ref.items()
                          if k.startswith(f"{rule}/p0/")})
    loop = _loop(net, 4, rule, kw)
    losses = loop.run(_train_batches(8), prefetch=False)
    np.testing.assert_allclose(losses, ref[f"{rule}/losses"],
                               rtol=LOSS_RTOL)
    for n, p in loop.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[f"{rule}/p8/{n}"], atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=n)
    assert losses[-1] < losses[0]


def test_loop_matches_per_step_bitwise():
    """k in {1, 3, 4} (k = 3: chunks of 3, 3 and a tail of 2) equal 8
    single ``SPMDTrainer`` steps bit for bit."""
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.parallel import SPMDTrainer
    batches = _train_batches(8)
    tr = SPMDTrainer(_net("ps_"), gloss.L2Loss(), "sgd", dict(OPT),
                     mesh=_mesh())
    want = [float(tr.step(x, y)) for x, y in batches]
    ref_p = _params(tr)
    for k in (1, 3, 4):
        loop = _loop(_net(f"pl{k}_"), k)
        losses = loop.run(batches, prefetch=False)
        assert losses.shape == (8,) and np.isfinite(losses).all()
        assert losses.tolist() == want, k
        _same(_params(loop), ref_p)
        assert loop._step_count == 8 and int(loop._step_dev) == 8


def test_loop_short_tail_and_prefetched_run():
    """A ``steps`` cap, a tail shorter than ``loop_steps`` and
    ``prefetch=True`` give the parameters of the unchunked run."""
    batches = _train_batches(7)
    a = _loop(_net("ta_"), 1)
    a.run(batches, prefetch=False)
    b = _loop(_net("tb_"), 4)
    losses = b.run(batches + _train_batches(3), steps=7, prefetch=True)
    assert losses.shape == (7,)
    _same(_params(a), _params(b))


def test_dropout_draws_per_inner_step_as_single_steps_do():
    """With dropout > 0 a chunk consumes the generator per inner step as
    single steps do: chunked and unchunked runs are equal bit for bit
    (within the port; across packages the RNGs differ)."""
    batches = _train_batches(8)
    out = []
    for k in (1, 4):
        torch.manual_seed(5)
        loop = _loop(_net(f"do{k}_", dropout=0.3), k)
        out.append((loop.run(batches, prefetch=False), _params(loop)))
    assert out[0][0].tolist() == out[1][0].tolist()
    _same(out[0][1], out[1][1])


def test_lr_schedule_traced_per_inner_step():
    """A schedule of the device step counter varies inside a chunk: it is
    called with each inner step's own count, and k = 4 equals k = 1 bit
    for bit."""
    from incubator_mxnet_tpu_torch.parallel import optim as fopt
    batches = _train_batches(8)
    outs, seen = {}, {}
    for k in (1, 4):
        log = []

        def sched(step, log=log):
            log.append(int(step))
            return 0.2 / step.to(torch.float32)
        loop = _loop(_net(f"lr{k}_"), k,
                     fopt.sgd(momentum=0.9, lr_schedule=sched), None)
        loop.run(batches, prefetch=False)
        outs[k], seen[k] = _params(loop), log
    _same(outs[1], outs[4])
    assert seen[1] == seen[4] == list(range(1, 9))


def test_accum_steps_and_bad_loop_steps_are_refused(monkeypatch):
    from incubator_mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError, match="accum_steps"):
        _loop(_net("ac_"), 2, accum_steps=2)
    with pytest.raises(MXNetError, match="loop_steps"):
        _loop(_net("ls_"), 0)
    monkeypatch.setenv("MXNET_LOOP_STEPS", "3")
    assert _loop(_net("ev_"), None).loop_steps == 3
    monkeypatch.delenv("MXNET_LOOP_STEPS")
    assert _loop(_net("df_"), None).loop_steps == 8


# ----------------------------------------------------- non-finite guard
def _poisoned(n, at, value=np.nan):
    batches = _train_batches(n)
    xb = batches[at][0].copy()
    xb[0, 0] = value
    batches[at] = (xb, batches[at][1])
    return batches


def test_poisoned_batch_skipped_exactly_once():
    """A NaN batch under ``skip_nonfinite=True`` is skipped once, for k = 1
    and k = 4 alike; the parameters stay finite, equal across k, and equal
    a run without that batch's update (SGD's step does not depend on the
    count); the step counter still advances on the skipped step."""
    batches = _poisoned(6, 2)
    res = {}
    for k in (1, 4):
        loop = _loop(_net(f"gd{k}_"), k, skip_nonfinite=True)
        losses = loop.run(batches, prefetch=False)
        assert losses.shape == (6,) and not np.isfinite(losses[2])
        assert loop.sync_nonfinite_guard() == 1
        assert loop.skipped_steps == 1
        vals = _params(loop)
        assert all(torch.isfinite(v).all() for v in vals.values())
        res[k] = vals
        assert loop._step_count == 6
    _same(res[1], res[4])
    clean = _loop(_net("gc_"), 4)
    clean.run(batches[:2] + batches[3:], prefetch=False)
    _same(_params(clean), res[4])


def test_guard_publishes_skipped_step_counter():
    from incubator_mxnet_tpu_torch import telemetry
    telemetry.start()
    faults = []
    sub = telemetry.FAULT.subscribe(lambda **kw: faults.append(kw))
    try:
        batches = _poisoned(4, 1, np.inf)
        loop = _loop(_net("gt_"), 4, skip_nonfinite=True)
        loop.run(batches, prefetch=False)
        assert telemetry.counters_flat().get("mxtpu_skipped_steps") == 1
        assert [f["site"] for f in faults
                if f.get("event") == "skipped_step"] == ["loop.step"]
    finally:
        telemetry.FAULT.unsubscribe(sub)


# ------------------------------------------------- checkpoint / resume
def test_checkpoint_resume_mid_chunk(tmp_path):
    """A checkpoint at step 6 of a k = 4 run (chunks of 4 and 2) restored
    into a fresh net of another seed finishes equal to the uninterrupted
    run bit for bit: parameters, momentum, step counter."""
    from incubator_mxnet_tpu_torch.checkpoint import AsyncCheckpointer
    batches = _train_batches(10)
    a = _loop(_net("ck_"), 4)
    a.run(batches, prefetch=False)
    golden = _params(a)

    netb = _net("ck_")
    b = _loop(netb, 4)
    b.run(batches[:6], prefetch=False)
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save_sync(6, {k: p.data() for k, p in netb.collect_params().items()},
                 trainer=b, epoch=0)

    netc = _net("ck_", seed=3)           # another init: must not matter
    c = _loop(netc, 4)
    assert ck.restore_into(params=netc.collect_params(), trainer=c) == 6
    c.reload_params()
    assert c._step_count == 6 and int(c._step_dev) == 6
    c.run(batches[6:], prefetch=False)
    _same(golden, _params(c))
    _same({n: t for n, t in zip(a.params, a._opt_state["mom"])},
          {n: t for n, t in zip(c.params, c._opt_state["mom"])})


def test_set_states_rejects_foreign_blob():
    from incubator_mxnet_tpu_torch.base import MXNetError
    loop = _loop(_net("fs_"), 2)
    with pytest.raises(MXNetError, match="CompiledLoop"):
        loop.set_states(pickle.dumps({"not": "a loop"}))
    blob = pickle.loads(loop.get_states())
    assert blob["loop"] == 1 and blob["step"] == 0 and blob["skipped"] == 0


# ------------------------------------------------------- telemetry, MFU
def test_loop_telemetry_one_dispatch_per_chunk_and_mfu():
    from incubator_mxnet_tpu_torch import telemetry
    telemetry.start()
    loop = _loop(_net("tm_"), 4)
    loop.run(_train_batches(8), prefetch=False)
    flat = telemetry.counters_flat()
    assert flat["mx_trainer_steps_total"] == 8
    assert flat["mxtpu_loop_chunks"] == 2
    row = telemetry.dispatch_ledger()["loop"]
    assert row["dispatches"] == 2           # one program, two chunks
    snap = telemetry.snapshot(include_memory=False)
    assert snap["gauges"]["mxtpu_loop_steps_per_chunk"] == 4
    assert snap["gauges"]["mxtpu_optimizer_dispatches_per_step"] == 0.25
    # FLOPs counted from shapes on the chunk's first run: per step the
    # forward's and backward's matrix products of the MLP
    mm = 2 * B * (IN * HID + HID * OUT)
    assert snap["gauges"]["mxtpu_step_flops"] >= 3 * mm - 2 * B * IN * HID
    assert flat["mx_program_flops_total"] > 0
    assert 0 < snap["gauges"]["mxtpu_mfu"]


# -------------------------------------------------- the prefetcher
def _tagged(n):
    return [(np.full((2, 2), i, np.float32),) for i in range(n)]


def _prefetcher(source, **kw):
    from incubator_mxnet_tpu_torch.io import DevicePrefetcher
    return DevicePrefetcher(source, device="cpu", **kw)


def _drain(pf):
    return [int(np.asarray(b[0])[0, 0]) for b in pf]


def test_prefetcher_preserves_order():
    pf = _prefetcher(iter(_tagged(20)))
    try:
        assert _drain(pf) == list(range(20))
        st = pf.stats()
        assert st["batches"] == 20 and not st["degraded"]
    finally:
        pf.close()


def test_prefetcher_latency_plan_just_slows():
    from incubator_mxnet_tpu_torch import fault
    fault.install_plan("dataloader.fetch:latency:0.01@1-3")
    pf = _prefetcher(iter(_tagged(8)))
    try:
        assert _drain(pf) == list(range(8))
        assert not pf.stats()["degraded"]
    finally:
        pf.close()


def test_prefetcher_ioerror_absorbed_by_retry(monkeypatch):
    from incubator_mxnet_tpu_torch import fault, telemetry
    monkeypatch.setenv("MXNET_RETRY_BASE_SECONDS", "0.001")
    telemetry.start()
    fault.install_plan("dataloader.fetch:ioerror@2")
    pf = _prefetcher(iter(_tagged(8)))
    try:
        assert _drain(pf) == list(range(8))     # nothing lost, in order
        assert not pf.stats()["degraded"]
    finally:
        pf.close()
    assert telemetry.counters_flat().get("mxtpu_retries", 0) >= 1


def test_prefetcher_fetch_giveup_degrades_to_blocking(monkeypatch):
    """Retries exhausted at the fetch site: the worker hands the iterator
    back and the consumer goes on blocking and in order."""
    from incubator_mxnet_tpu_torch import fault
    monkeypatch.setenv("MXNET_RETRY_BASE_SECONDS", "0.001")
    fault.install_plan("dataloader.fetch:ioerror@2-8")
    pf = _prefetcher(iter(_tagged(10)))
    try:
        assert _drain(pf) == list(range(10))
        assert pf.stats()["degraded"]
    finally:
        pf.close()


def test_prefetcher_h2d_giveup_keeps_fetched_batch(monkeypatch):
    """Retries exhausted at ``prefetch.h2d`` after the batch was fetched:
    the raw batch rides the degrade marker and the consumer places it."""
    from incubator_mxnet_tpu_torch import fault
    monkeypatch.setenv("MXNET_RETRY_BASE_SECONDS", "0.001")
    fault.install_plan("prefetch.h2d:ioerror@2-9")
    pf = _prefetcher(iter(_tagged(10)))
    try:
        assert _drain(pf) == list(range(10))
        assert pf.stats()["degraded"]
    finally:
        pf.close()


def test_prefetcher_publishes_fallback_event(monkeypatch):
    from incubator_mxnet_tpu_torch import fault, telemetry
    monkeypatch.setenv("MXNET_RETRY_BASE_SECONDS", "0.001")
    telemetry.start()
    fault.install_plan("dataloader.fetch:ioerror@1-7")
    pf = _prefetcher(iter(_tagged(6)))
    try:
        assert _drain(pf) == list(range(6))
    finally:
        pf.close()
    assert telemetry.counters_flat().get("mxtpu_dataloader_fallbacks",
                                         0) >= 1


def test_prefetcher_h2d_degrade_batch_keeps_telemetry(monkeypatch):
    """The batch that triggers the h2d degrade still goes through the
    ``prefetch.h2d`` site and the TRANSFER accounting: every batch's bytes
    are counted."""
    from incubator_mxnet_tpu_torch import fault, telemetry
    monkeypatch.setenv("MXNET_RETRY_BASE_SECONDS", "0.001")
    telemetry.start()
    fault.install_plan("prefetch.h2d:ioerror@2-9")
    pf = _prefetcher(iter(_tagged(10)))
    try:
        assert _drain(pf) == list(range(10))
        assert pf.stats()["degraded"]
    finally:
        pf.close()
    flat = telemetry.counters_flat()
    assert flat.get("mx_transfer_h2d_bytes_total", 0) == 10 * 16
    assert flat.get("mx_dataloader_batches_total", 0) >= 1


def test_prefetcher_applies_a_given_placement():
    """``placement`` replaces the default placement for every array of a
    batch (a single array too), in order."""
    seen = []

    def place(a):
        seen.append(a.shape)
        return torch.as_tensor(a) * 2
    pf = _prefetcher(iter([(np.ones((2, 2), np.float32), np.zeros(3)),
                           np.full((1,), 4.0)]), placement=place)
    try:
        (a, b), c = list(pf)
    finally:
        pf.close()
    assert a.tolist() == [[2.0, 2.0]] * 2 and b.tolist() == [0.0] * 3
    assert c.tolist() == [8.0] and seen == [(2, 2), (3,), (1,)]


def test_prefetcher_propagates_upstream_bug():
    """An error raised inside the iterator reaches the consumer (a dead
    generator must not read as the end of the epoch)."""
    def gen():
        yield (np.zeros((2, 2), np.float32),)
        raise ValueError("dataset bug")

    pf = _prefetcher(gen())
    it = iter(pf)
    next(it)
    with pytest.raises(ValueError, match="dataset bug"):
        next(it)
    pf.close()


# ------------------------------------------------ on the card (cuda mark)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs and kernels run only "
                    "on the card")


@pytest.mark.cuda
def test_cuda_chunk_graph_equals_step_graphs():
    """On the card: 8 steps as chunk graphs of 4 (with a guarded NaN batch
    at inner step 2 of chunk 2) equal 8 single-step graphs over the same
    batches with that batch left out, bit for bit, and the launches per
    replay are the captured tally (all-finite and K9 once per step)."""
    _need_cuda()
    import importlib
    from incubator_mxnet_tpu_torch.parallel import make_mesh
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels.flash_attention")
    mesh = make_mesh({"data": 1})
    batches = _poisoned(8, 5)
    loop = _loop(_net("cl_", device="cuda"), 4, mesh=mesh,
                 skip_nonfinite=True)
    loop.run(batches[:4], prefetch=False)         # eager + capture
    fa.reset_launch_counts()
    loop.run(batches[4:], prefetch=True)          # one replay
    torch.cuda.synchronize()
    assert loop.sync_nonfinite_guard() == 1
    assert fa.launch_counts["all_finite"] == 4
    assert fa.launch_counts["multi_tensor_update"] == 4
    ref = _loop(_net("cr_", device="cuda"), 1, mesh=mesh)
    for b in batches[:5] + batches[6:]:
        ref.step(*b)
    torch.cuda.synchronize()
    _same(_params(ref), _params(loop))


@pytest.mark.cuda
def test_cuda_a_failed_chunk_capture_raises(monkeypatch):
    """A capture that fails inside a chunk raises ``MXNetError`` naming
    the chunk and its batch key, and so does every later chunk of that
    key: the card has no eager path after a program's first run."""
    _need_cuda()
    from incubator_mxnet_tpu_torch import cuda_graphs
    from incubator_mxnet_tpu_torch.base import MXNetError
    from incubator_mxnet_tpu_torch.parallel import make_mesh
    loop = _loop(_net("cf_", device="cuda"), 2, mesh=make_mesh({"data": 1}))

    def boom(*args, **kwargs):
        raise RuntimeError("injected capture failure")
    monkeypatch.setattr(cuda_graphs, "capture", boom)
    batches = _train_batches(4)
    with pytest.raises(MXNetError, match="capture of a chunk of 2 steps"):
        loop.step_chunk(batches[:2])
    monkeypatch.undo()
    with pytest.raises(MXNetError, match="injected capture failure"):
        loop.step_chunk(batches[2:])


@pytest.mark.cuda
def test_cuda_prefetcher_places_in_order():
    _need_cuda()
    from incubator_mxnet_tpu_torch.io import DevicePrefetcher
    with DevicePrefetcher(iter(_tagged(12)), buffers=2) as pf:
        got = [b[0] for b in pf]
    assert all(t.is_cuda for t in got)
    assert [int(t[0, 0]) for t in got] == list(range(12))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax":
        _jax_child(sys.argv[2])
