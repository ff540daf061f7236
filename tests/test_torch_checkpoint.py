"""The port's ``checkpoint.py`` on the CPU: the counterparts of the
contracts ``tests/test_checkpoint.py`` pins for the JAX package (atomic
and asynchronous publish, the manifest written last, retention across
restarts, the orphan sweep, full-state resume bit for bit, the random
state, retried and surfaced write faults; ``scaler=`` is refused by name:
``LossScaler`` is not ported), a resumed Gluon run against the
uninterrupted one bit for bit (Adam, and SGD with momentum under a
``FactorScheduler``), and the ``.params`` files crossing between the
packages both ways.

The JAX side (its ``Dense`` layers loading the port's checkpoint, and its
own checkpoints: parameters only, and full state with a ``Trainer``) runs
in a child interpreter once per module (this file as a script, every
``MXNET_*`` variable unset), reading and writing only under
``tmp_path``.  Forwards across the packages agree within ``FWD_ATOL``
(the two frameworks' matmuls sum in other orders)."""
import json
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
from incubator_mxnet_tpu_torch.checkpoint import (AsyncCheckpointer,
                                                  all_checkpoints,
                                                  latest_checkpoint,
                                                  latest_resumable_step)
from incubator_mxnet_tpu_torch.gluon import Trainer, nn
from incubator_mxnet_tpu_torch.lr_scheduler import FactorScheduler

ROOT = Path(__file__).resolve().parents[1]
FWD_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_fault_state():
    fault.clear_plan()
    telemetry.reset()
    with mx.cpu():
        yield
    fault.clear_plan()
    telemetry.reset()


def _params(**arrs):
    return {k: mx.nd.array(v) for k, v in arrs.items()}


def _train_setup(seed=7, optimizer="adam", opt_params=None):
    # a fixed prefix: saved names must match across net instances
    mx.random.seed(seed)
    net = nn.Dense(1, in_units=3, prefix="net_")
    net.initialize()
    trainer = Trainer(net.collect_params(), optimizer,
                      dict(opt_params or {"learning_rate": 0.05}))
    return net, trainer


def _train_steps(net, trainer, steps, first=0):
    for s in range(first, first + steps):
        rng = np.random.default_rng(100 + s)
        x = mx.nd.array(rng.standard_normal((4, 3)).astype(np.float32))
        y = mx.nd.array(rng.standard_normal((4, 1)).astype(np.float32))
        with ag.record():
            loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        trainer.step(4)


def _snapshot(net):
    return {k: p.data() for k, p in net.collect_params().items()}


# ---------------------------------------------------------------- format
def test_params_only_save_writes_a_single_file(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path / "m"), keep=3)
    ck.save(1, _params(w=np.ones((2, 2), np.float32)))
    ck.wait_until_finished()
    assert sorted(os.listdir(tmp_path)) == ["m-0000001.params"]


def test_full_state_save_writes_manifest_last_commit_set(tmp_path):
    net, trainer = _train_setup()
    _train_steps(net, trainer, 2)
    ck = AsyncCheckpointer(str(tmp_path / "m"), keep=3)
    ck.save(2, _snapshot(net), trainer=trainer, epoch=1,
            extra={"note": "hi"})
    ck.wait_until_finished()
    assert sorted(os.listdir(tmp_path)) == [
        "m-0000002.meta.json", "m-0000002.params", "m-0000002.states"]
    meta = json.load(open(tmp_path / "m-0000002.meta.json"))
    assert meta["step"] == 2 and meta["epoch"] == 1
    assert meta["files"]["params"] == "m-0000002.params"
    assert meta["files"]["states"] == "m-0000002.states"
    assert meta["extra"] == {"note": "hi"}
    assert meta["writer"] == "incubator_mxnet_tpu_torch"
    assert meta["rng"]["generators"] and meta["rng"]["numpy"]
    assert latest_resumable_step(str(tmp_path / "m")) == 2


def test_scaler_is_refused_by_name(tmp_path):
    net, trainer = _train_setup()
    ck = AsyncCheckpointer(str(tmp_path / "m"), keep=3)
    with pytest.raises(MXNetError, match="item 17"):
        ck.save(1, _snapshot(net), trainer=trainer, scaler=object())
    with pytest.raises(MXNetError, match="item 17"):
        ck.restore_into(params=net.collect_params(), scaler=object())
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------------- retention
def test_retention_gc_survives_restart(tmp_path):
    prefix = str(tmp_path / "m")
    ck = AsyncCheckpointer(prefix, keep=2)
    for step in (1, 2, 3):
        ck.save(step, _params(w=np.full((2,), step, np.float32)))
    ck.wait_until_finished()
    assert all_checkpoints(prefix) == [2, 3]
    ck2 = AsyncCheckpointer(prefix, keep=2)
    ck2.save(4, _params(w=np.full((2,), 4, np.float32)))
    ck2.wait_until_finished()
    assert all_checkpoints(prefix) == [3, 4]


def test_retention_gc_removes_full_state_sidecars(tmp_path):
    prefix = str(tmp_path / "m")
    net, trainer = _train_setup()
    _train_steps(net, trainer, 1)
    ck = AsyncCheckpointer(prefix, keep=1)
    for step in (1, 2):
        ck.save(step, _snapshot(net), trainer=trainer)
    ck.wait_until_finished()
    assert sorted(os.listdir(tmp_path)) == [
        "m-0000002.meta.json", "m-0000002.params", "m-0000002.states"]


def test_orphaned_tmp_files_swept_at_startup(tmp_path):
    prefix = str(tmp_path / "m")
    orphans = ["m-0000005.params.tmp-1234", "m-0000005.states.tmp-1234",
               "m-0000005.meta.json.tmp-99"]
    keep = ["m-0000004.params", "other-0000005.params.tmp-1",
            "m-notatmp.txt"]
    for name in orphans + keep:
        (tmp_path / name).write_bytes(b"x")
    AsyncCheckpointer(prefix, keep=3)
    assert sorted(os.listdir(tmp_path)) == sorted(keep)


# ---------------------------------------------------------------- resume
@pytest.mark.parametrize("optimizer,opt_params", [
    ("adam", {"learning_rate": 0.05}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3,
             "lr_scheduler": "factor"}),
    ("lamb", {"learning_rate": 0.05, "wd": 0.01}),
])
def test_full_resume_round_trip_bit_identical(tmp_path, optimizer,
                                              opt_params):
    """Checkpoint mid-run, keep training; then rebuild from another seed,
    diverge, restore and replay the same tail: the parameters come out
    bit for bit (the optimizer's states, update counts and scheduler
    included)."""
    def params_of():
        p = dict(opt_params)
        if p.get("lr_scheduler") == "factor":
            p["lr_scheduler"] = FactorScheduler(step=2, factor=0.5)
        return p

    prefix = str(tmp_path / "m")
    net, trainer = _train_setup(optimizer=optimizer, opt_params=params_of())
    _train_steps(net, trainer, 3)
    ck = AsyncCheckpointer(prefix, keep=2)
    ck.save(3, _snapshot(net), trainer=trainer)
    ck.wait_until_finished()
    _train_steps(net, trainer, 2, first=3)
    want = {k: p.data().asnumpy() for k, p in net.collect_params().items()}

    net2, trainer2 = _train_setup(seed=99, optimizer=optimizer,
                                  opt_params=params_of())
    _train_steps(net2, trainer2, 1)
    step = AsyncCheckpointer(prefix, keep=2).restore_into(
        params=net2.collect_params(), trainer=trainer2)
    assert step == 3
    _train_steps(net2, trainer2, 2, first=3)
    got = {k: p.data().asnumpy() for k, p in net2.collect_params().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(want[k], got[k]), f"param {k} diverged"


def test_restore_into_a_net_that_saw_no_forward(tmp_path):
    """The port's shapes are known at construction (no deferred init):
    restoring into a fresh, never-run net works."""
    prefix = str(tmp_path / "m")
    net, trainer = _train_setup()
    _train_steps(net, trainer, 1)
    ck = AsyncCheckpointer(prefix, keep=1)
    ck.save(1, _snapshot(net), trainer=trainer)
    ck.wait_until_finished()
    net2 = nn.Dense(1, in_units=3, prefix="net_")
    net2.initialize()
    trainer2 = Trainer(net2.collect_params(), "adam",
                       {"learning_rate": 0.05})
    assert AsyncCheckpointer(prefix, keep=1).restore_into(
        params=net2.collect_params(), trainer=trainer2) == 1
    for (k, p), (_, q) in zip(sorted(net.collect_params().items()),
                              sorted(net2.collect_params().items())):
        assert np.array_equal(p.data().asnumpy(), q.data().asnumpy())


def test_restore_into_restores_the_random_state(tmp_path):
    prefix = str(tmp_path / "m")
    mx.random.seed(5)
    mx.nd.random.uniform(shape=(2,))       # advance the generator
    np.random.seed(3)
    np.random.rand(4)
    expect = mx.random.get_state()
    ck = AsyncCheckpointer(prefix, keep=1)
    ck.save(1, _params(w=np.ones((2,), np.float32)), epoch=0)
    ck.wait_until_finished()
    nxt = mx.nd.random.uniform(shape=(3,)).asnumpy(), np.random.rand(2)
    mx.random.seed(12345)
    np.random.seed(1)
    assert mx.random.get_state() != expect
    assert ck.restore_into(step=1) == 1
    assert mx.random.get_state() == expect
    again = mx.nd.random.uniform(shape=(3,)).asnumpy(), np.random.rand(2)
    assert np.array_equal(nxt[0], again[0])
    assert np.array_equal(nxt[1], again[1])


def test_restore_into_without_checkpoint_returns_none(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path / "m"), keep=1)
    assert ck.restore_into() is None


# ----------------------------------------------- partial-write shadowing
def test_partial_write_never_shadows_last_complete(tmp_path):
    prefix = str(tmp_path / "m")
    net, trainer = _train_setup()
    _train_steps(net, trainer, 1)
    ck = AsyncCheckpointer(prefix, keep=5)
    ck.save(5, _snapshot(net), trainer=trainer)
    ck.wait_until_finished()
    ck.save(6, _snapshot(net))
    ck.wait_until_finished()
    assert latest_checkpoint(prefix) == 6
    assert latest_resumable_step(prefix) == 5
    (tmp_path / "m-0000007.meta.json").write_text(
        json.dumps({"format": 1, "step": 7,
                    "files": {"params": "m-0000007.params"}}))
    assert latest_resumable_step(prefix) == 5
    assert ck.restore_into(params=net.collect_params(),
                           trainer=trainer) == 5


def test_atomic_publish_leaves_no_tmp_files(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path / "m"), keep=3)
    for step in range(1, 4):
        ck.save(step, _params(w=np.full((4,), step, np.float32)))
    ck.wait_until_finished()
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]


def test_save_snapshots_on_the_callers_thread(tmp_path):
    """After ``save`` returns the caller may change the arrays: the file
    holds the values at the call."""
    w = mx.nd.array(np.ones((3,), np.float32))
    ck = AsyncCheckpointer(str(tmp_path / "m"), keep=1)
    ck.save(1, {"w": w})
    w[:] = 5.0
    ck.wait_until_finished()
    np.testing.assert_array_equal(ck.restore(1)["w"].asnumpy(),
                                  np.ones(3, np.float32))


# ---------------------------------------------------------- fault/retry
def test_checkpoint_write_fault_absorbed_by_retry(tmp_path):
    events = []

    def on_fault(site="?", event="?", **kw):
        events.append((site, event))

    telemetry.FAULT.subscribe(on_fault)
    try:
        fault.install_plan("checkpoint.write:ioerror@1")
        ck = AsyncCheckpointer(str(tmp_path / "m"), keep=3)
        ck.save(1, _params(w=np.ones((2,), np.float32)))
        ck.wait_until_finished()
    finally:
        telemetry.FAULT.unsubscribe(on_fault)
    assert latest_checkpoint(str(tmp_path / "m")) == 1
    assert ("checkpoint.write", "retry") in events
    assert ("checkpoint.write", "giveup") not in events


def test_checkpoint_write_giveup_surfaces_error(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_RETRY_MAX", "1")
    monkeypatch.setenv("MXNET_RETRY_BASE_SECONDS", "0.001")
    fault.install_plan("checkpoint.write:ioerror@1-99")
    ck = AsyncCheckpointer(str(tmp_path / "m"), keep=3)
    ck.save(1, _params(w=np.ones((2,), np.float32)))
    with pytest.raises(MXNetError, match="checkpoint"):
        ck.wait_until_finished()
    assert all_checkpoints(str(tmp_path / "m")) == []


# ---------------------------------------------- across the two packages
X = np.random.RandomState(9).randn(5, 6).astype(np.float32)


def _two_layers():
    """Two Dense layers with fixed prefixes (the names both packages give
    them): (callable, {name: Parameter})."""
    d1 = nn.Dense(8, in_units=6, activation="relu", prefix="l1_")
    d2 = nn.Dense(3, in_units=8, prefix="l2_")
    for d in (d1, d2):
        d.initialize(mx.init.Normal(0.5))
    params = dict(d1.collect_params().items())
    params.update(d2.collect_params().items())
    return (lambda x: d2(d1(x))), params


_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as ag
from incubator_mxnet_tpu.checkpoint import AsyncCheckpointer
from incubator_mxnet_tpu.gluon import Trainer, nn

tmp = sys.argv[1]
x = np.load(tmp + "/x.npy")
mx.random.seed(3)
d1 = nn.Dense(8, in_units=6, activation="relu", prefix="l1_")
d2 = nn.Dense(3, in_units=8, prefix="l2_")
for d in (d1, d2):
    d.initialize(mx.init.Normal(0.5))
params = dict(d1.collect_params().items())
params.update(d2.collect_params().items())
out = {}
# the JAX package's own checkpoints, and its forward on its weights
out["jax_y"] = d2(d1(mx.nd.array(x))).asnumpy()
ck = AsyncCheckpointer(tmp + "/jax/m", keep=3)
ck.save(1, {k: p.data() for k, p in params.items()})
ck.wait_until_finished()
tr = Trainer(list(params.values()), "adam", {"learning_rate": 0.01})
with ag.record():
    loss = (d2(d1(mx.nd.array(x))) ** 2).mean()
loss.backward()
tr.step(5)
ck = AsyncCheckpointer(tmp + "/jaxfull/m", keep=3)
ck.save(2, {k: p.data() for k, p in params.items()}, trainer=tr, epoch=0)
ck.wait_until_finished()
# the port's checkpoint loaded into the JAX layers
step = AsyncCheckpointer(tmp + "/port/m").restore()
for k, p in params.items():
    p.set_data(step[k])
out["port_y_in_jax"] = d2(d1(mx.nd.array(x))).asnumpy()
np.savez(tmp + "/ref.npz", **out)
"""


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The port writes its checkpoint; the child loads it into the JAX
    layers and writes the JAX package's checkpoints."""
    tmp = tmp_path_factory.mktemp("cross")
    np.save(tmp / "x.npy", X)
    with mx.cpu():
        mx.random.seed(4)
        fwd, params = _two_layers()
        ck = AsyncCheckpointer(str(tmp / "port" / "m"))
        ck.save(1, {k: p.data() for k, p in params.items()})
        ck.wait_until_finished()
        port_y = fwd(mx.nd.array(X)).asnumpy()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp)], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return tmp, port_y, dict(np.load(tmp / "ref.npz"))


def test_port_params_load_into_the_jax_layers(cross):
    _, port_y, ref = cross
    np.testing.assert_allclose(ref["port_y_in_jax"], port_y, atol=FWD_ATOL,
                               rtol=0)


def test_jax_params_load_into_the_port(cross):
    tmp, _, ref = cross
    fwd, params = _two_layers()
    loaded = AsyncCheckpointer(str(tmp / "jax" / "m")).restore(ctx="cpu")
    assert sorted(loaded) == sorted(params)
    for k, p in params.items():
        p.set_data(loaded[k])
    np.testing.assert_allclose(fwd(mx.nd.array(X)).asnumpy(), ref["jax_y"],
                               atol=FWD_ATOL, rtol=0)


def test_jax_full_state_manifest_is_refused_by_name(cross):
    """``restore_into`` of a full-state checkpoint the JAX package wrote
    raises before it restores anything: no parameter, no trainer state,
    no random state changes."""
    tmp, _, _ = cross
    prefix = str(tmp / "jaxfull" / "m")
    assert latest_resumable_step(prefix) == 2
    fwd, params = _two_layers()
    tr = Trainer(list(params.values()), "adam", {"learning_rate": 0.01})
    before = {k: p.data().asnumpy().copy() for k, p in params.items()}
    rng_before = mx.random.get_state()
    with pytest.raises(MXNetError, match="JAX package"):
        AsyncCheckpointer(prefix).restore_into(params=params, trainer=tr)
    for k, p in params.items():
        assert np.array_equal(p.data().asnumpy(), before[k])
    assert tr._updaters.states == {}
    assert mx.random.get_state() == rng_before
    # its parameters alone still load
    assert sorted(AsyncCheckpointer(prefix).restore(ctx="cpu")) == \
        sorted(params)


def test_random_set_state_refuses_a_jax_key_stream():
    with pytest.raises(MXNetError, match="JAX"):
        mx.random.set_state({"all": [0, 42]})
