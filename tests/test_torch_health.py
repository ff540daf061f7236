"""The training half of the port's health plane (``health.py``) on the
CPU: ``train_step_health`` against the JAX package's (a pure function,
called in-process under ``jax.jit``) within ``HEALTH_RTOL`` on every
field; ``StepStats`` (the stats as extra outputs of a step) against
``train_step_health``; the detectors on scripted records (the reference's
``tests/test_health.py`` :354-405); the first non-finite leaf named by a
``trainer.grad:nonfinite`` fault, with exactly one debounced flight dump;
and the plane's acceptance bar: parameters with ``MXNET_HEALTH_PLANE=1``
equal the plane-off run's bit for bit on ``SPMDTrainer``,
``CompiledLoop`` and the fused ``gluon.Trainer``.  Held to the
reference's functions, not to its flaky
``test_spmd_step_parity_bitwise``.

The net is an MLP (8 -> 32 relu -> 4, L2 loss), fp32.  Environment
variables are set only through ``monkeypatch``; every port global a test
touches is reset around it."""
import glob
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import (autograd as ag, fault, health,
                                       telemetry, telemetry_ring)
from torch_registry_hygiene import registry_hygiene  # noqa: F401

HEALTH_RTOL = 1e-6
IN, HID, OUT, B = 8, 32, 4, 8
OPT = {"learning_rate": 0.1, "momentum": 0.9}


@pytest.fixture(autouse=True)
def _clean_state():
    def reset():
        fault.clear_plan()
        telemetry.stop()
        telemetry.reset()
        health.reset()
        telemetry_ring.recorder.reset()
    reset()
    yield
    reset()


def _leaves(seed, nan_leaf=None):
    rng = np.random.default_rng(seed)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    nws = [w - np.float32(0.1) * g for w, g in zip(ws, gs)]
    if nan_leaf is not None:
        gs[nan_leaf][0] = np.nan
    return gs, ws, nws


# ------------------------------------------------- the stats against JAX
@pytest.mark.parametrize("nan_leaf", [None, 1])
def test_train_step_health_matches_jax(nan_leaf):
    import jax
    import jax.numpy as jnp
    from incubator_mxnet_tpu import health as jhealth
    gs, ws, nws = _leaves(3, nan_leaf)
    want = jax.jit(lambda g, w, nw: jhealth.train_step_health(
        list(g), list(w), list(nw), loss=jnp.asarray(1.5, jnp.float32)))(
        tuple(gs), tuple(ws), tuple(nws))
    got = health.train_step_health(
        [torch.from_numpy(x) for x in gs], [torch.from_numpy(x) for x in ws],
        [torch.from_numpy(x) for x in nws], loss=torch.tensor(1.5))
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = got[name].numpy(), np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == np.bool_:
            assert a.tolist() == b.tolist(), name
        else:
            np.testing.assert_allclose(a, b, rtol=HEALTH_RTOL, err_msg=name)
    assert got["finite"].tolist() == [nan_leaf != i for i in range(3)]


def test_step_stats_equal_the_pure_function():
    """The in-step buffers (weights copied before an in-place update,
    subtracted after it) hold ``train_step_health``'s values bit for bit,
    row by row; the loss column only when asked for."""
    gs, ws, nws = _leaves(4)
    params = [torch.from_numpy(w.copy()) for w in ws]
    grads = [torch.from_numpy(g) for g in gs]
    st = health.StepStats(params, rows=2)
    st.before(1, params, grads)
    for p, nw in zip(params, nws):
        p.copy_(torch.from_numpy(nw))          # the update, in place
    st.after(1, params, torch.tensor(0.75))
    got = health.unpack(st.rows_of(2)["packed"].numpy(), 3)
    want = health.train_step_health(
        grads, [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(w) for w in nws], loss=torch.tensor(0.75))
    for name, v in want.items():
        assert np.array_equal(got[name][1], v.numpy()), name
    assert not got["grad_norms"][0].any()
    assert "loss" not in health.unpack(
        health.StepStats(params, loss=False).rows_of(1)["packed"].numpy(), 3)


# ------------------------------------------------------- the detectors
def _rec(step, loss=1.0, gnorm=1.0, finite=True, leaf=None):
    r = {"step": step, "src": "unit", "loss": loss, "grad_norm": gnorm,
         "max_update_ratio": 0.01, "finite": finite}
    if leaf:
        r["nonfinite_leaf"] = leaf
    return r


def test_detector_loss_spike_and_gradnorm_explosion():
    telemetry.start()
    mon = health.HealthMonitor(["a", "b"], src="unit")
    faults = []
    sub = telemetry.FAULT.subscribe(lambda **kw: faults.append(kw))
    try:
        for i in range(8):                     # fill the baselines
            mon._detect(_rec(i))
        assert health.last_anomaly() is None   # the warm-up never flags
        mon._detect(_rec(8, loss=1.2, gnorm=1.1))
        assert health.last_anomaly() is None
        mon._detect(_rec(9, loss=10.0))        # > 4x the rolling mean
        anom = health.last_anomaly()
        assert anom["kind"] == "loss_spike" and anom["step"] == 9
        mon._detect(_rec(10, gnorm=50.0))      # > 10x the rolling mean
        assert health.last_anomaly()["kind"] == "grad_norm_explosion"
        # one FAULT per kind within the debounce window
        mon._detect(_rec(11, loss=10.0))
        kinds = [f["kind"] for f in faults if f.get("event") == "anomaly"]
        assert kinds == ["loss_spike", "grad_norm_explosion"]
        c = telemetry.registry.get("mxtpu_health_anomalies")
        assert c.sample()["by"]["kind=loss_spike,src=unit"] == 2
    finally:
        telemetry.FAULT.unsubscribe(sub)


def test_detector_nonfinite_skips_baseline_poisoning():
    mon = health.HealthMonitor(["a", "b"], src="unit")
    for i in range(8):
        mon._detect(_rec(i))
    mon._detect(_rec(8, loss=float("nan"), gnorm=float("nan"),
                     finite=False, leaf="b"))
    anom = health.last_anomaly()
    assert anom["kind"] == "nonfinite" and anom["leaf"] == "b"
    health.reset()
    mon._detect(_rec(9))
    assert health.last_anomaly() is None
    assert len(mon._loss_win) == 9             # 8 warm-up + step 9


# ---------------------------------------------- attribution, one dump
def _gluon_net(prefix):
    from incubator_mxnet_tpu_torch.gluon import nn
    with mx.cpu():
        mx.random.seed(0)
        net = nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(nn.Dense(HID, in_units=IN, activation="relu"))
            net.add(nn.Dense(OUT, in_units=HID))
        net.initialize(init=mx.init.Normal(0.3))
    return net


def _batches(n):
    rng = np.random.default_rng(1)
    return [(rng.standard_normal((B, IN)).astype(np.float32),
             rng.standard_normal((B, OUT)).astype(np.float32))
            for _ in range(n)]


def _gluon_run(prefix, steps, **trainer_kw):
    net = _gluon_net(prefix)
    loss_fn = mx.gluon.loss.L2Loss()
    with mx.cpu():
        tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(OPT),
                              **trainer_kw)
        for x, y in _batches(steps):
            with ag.record():
                L = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
            L.backward()
            tr.step(B)
    return net, tr


def test_nonfinite_leaf_attribution_and_one_flight_dump(monkeypatch,
                                                        tmp_path):
    """A ``trainer.grad:nonfinite@4`` fault under the plane: the anomaly
    names step 4 and the first leaf, one ring record carries the leaf,
    the report has the reference's keys, and exactly one
    ``training_anomaly`` flight dump lands, naming the leaf and step."""
    monkeypatch.setenv("MXNET_HEALTH_PLANE", "1")
    monkeypatch.setenv("MXNET_FLIGHT_DUMP_DIR", str(tmp_path))
    fault.install_plan("trainer.grad:nonfinite@4")
    telemetry.start()
    net, tr = _gluon_run("at_", 6, skip_nonfinite=True)
    tr.sync_health()
    tr.sync_nonfinite_guard()
    leaf = tr._updatable[0][1].name
    anom = health.last_anomaly()
    assert anom["kind"] == "nonfinite" and anom["step"] == 4
    assert anom["leaf"] == leaf and anom["src"] == "fused"
    rep = health.report()
    assert sorted(rep) == sorted(["enabled", "status", "anomaly_total",
                                  "anomalies", "last_anomaly", "ring",
                                  "ring_depth"])
    assert rep["status"] == "anomalous" and rep["enabled"]
    bad = [r for r in telemetry.health_ring.entries()
           if "nonfinite_leaf" in r]
    assert len(bad) == 1 and bad[0]["nonfinite_leaf"] == leaf
    assert [r["step"] for r in telemetry.health_ring.entries()] == \
        list(range(1, 7))
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and not glob.glob(
            str(tmp_path / "flight_*_training_anomaly.json")):
        time.sleep(0.05)
    time.sleep(0.3)
    dumps = glob.glob(str(tmp_path / "flight_*_training_anomaly.json"))
    assert len(dumps) == 1
    import json
    with open(dumps[0]) as f:
        payload = json.load(f)
    last = payload["health"]["last_anomaly"]
    assert last["leaf"] == leaf and last["step"] == 4
    assert all(torch.isfinite(p.data()._data).all()
               for p in net.collect_params().values())


# ----------------------------------------- plane on == plane off, bitwise
def _spmd_run(prefix, steps, loop_steps=None, guard=False):
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    from incubator_mxnet_tpu_torch.parallel.loop import CompiledLoop
    net = _gluon_net(prefix)
    mesh = make_mesh({"data": 1}, devices=["cpu"])
    batches = _batches(steps)
    if guard:
        xb = batches[2][0].copy()
        xb[1, 1] = np.nan
        batches[2] = (xb, batches[2][1])
    if loop_steps is None:
        tr = SPMDTrainer(net, gloss.L2Loss(), "lamb", {"learning_rate":
                                                      0.01}, mesh=mesh)
        for b in batches:
            tr.step(*b)
    else:
        tr = CompiledLoop(net, gloss.L2Loss(), "lamb",
                          {"learning_rate": 0.01}, loop_steps=loop_steps,
                          skip_nonfinite=guard, mesh=mesh)
        tr.run(batches, prefetch=False)
    tr.sync_to_block()
    return net, tr


@pytest.mark.parametrize("trainer", ["spmd", "loop", "fused"])
def test_plane_on_equals_plane_off_bitwise(trainer, monkeypatch):
    """The same seeded run with and without ``MXNET_HEALTH_PLANE=1``:
    every parameter bit for bit; the plane-on run folds one ring record
    per step from its own source (the loop's with a skipped NaN step,
    whose update ratio is 0)."""
    runs = {}
    for plane in ("0", "1"):
        monkeypatch.setenv("MXNET_HEALTH_PLANE", plane)
        telemetry.health_ring.clear()
        if trainer == "spmd":
            net, _ = _spmd_run(f"s{plane}_", 5)
        elif trainer == "loop":
            net, _ = _spmd_run(f"l{plane}_", 6, loop_steps=4, guard=True)
        else:
            net, tr = _gluon_run(f"f{plane}_", 5)
            tr.sync_health()
        runs[plane] = [p.data()._data.clone()
                       for p in net.collect_params().values()]
        ring = telemetry.health_ring.entries()
        if plane == "0":
            assert ring == []
    for a, b in zip(runs["0"], runs["1"]):
        assert torch.equal(a, b)
    src = {"spmd": "spmd", "loop": "loop", "fused": "fused"}[trainer]
    assert [r["src"] for r in ring] == [src] * len(ring)
    assert [r["step"] for r in ring] == list(range(1, len(ring) + 1))
    assert len(ring) == (6 if trainer == "loop" else 5)
    if trainer == "loop":
        assert not ring[2]["finite"] and ring[2]["max_update_ratio"] == 0.0
        assert ring[2]["nonfinite_leaf"] == "dense0_weight"
        assert all(r["finite"] for i, r in enumerate(ring) if i != 2)
    if trainer != "fused":
        assert all(r["loss"] is not None for r in ring)


def test_loop_stats_per_inner_step_equal_single_steps(monkeypatch):
    """The chunk's (k, n) stat rows equal the per-step records of an
    ``SPMDTrainer`` over the same batches, record for record."""
    monkeypatch.setenv("MXNET_HEALTH_PLANE", "1")
    _spmd_run("r1_", 8)
    single = telemetry.health_ring.entries()
    telemetry.health_ring.clear()
    _spmd_run("r4_", 8, loop_steps=4)
    chunked = telemetry.health_ring.entries()
    strip = [{k: v for k, v in r.items() if k != "src"} for r in single]
    assert strip == [{k: v for k, v in r.items() if k != "src"}
                     for r in chunked]


# ------------------------------------------------ on the card (cuda mark)
@pytest.mark.cuda
def test_cuda_plane_on_equals_plane_off_in_the_chunk_graph(monkeypatch):
    """On the card: a CompiledLoop of k = 4 over 8 steps (two chunk
    replays after the eager first chunk) gives the same parameters with
    the plane on as off, bit for bit, and the plane's records equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs run only on the card")
    from incubator_mxnet_tpu_torch.gluon import loss as gloss, nn
    from incubator_mxnet_tpu_torch.parallel import make_mesh
    from incubator_mxnet_tpu_torch.parallel.loop import CompiledLoop
    out = {}
    for plane in ("0", "1"):
        monkeypatch.setenv("MXNET_HEALTH_PLANE", plane)
        with mx.gpu(0):
            mx.random.seed(0)
            net = nn.HybridSequential(prefix=f"c{plane}_")
            with net.name_scope():
                net.add(nn.Dense(HID, in_units=IN, activation="relu"))
                net.add(nn.Dense(OUT, in_units=HID))
            net.initialize(init=mx.init.Normal(0.3))
        loop = CompiledLoop(net, gloss.L2Loss(), "lamb",
                            {"learning_rate": 0.01}, loop_steps=4,
                            mesh=make_mesh({"data": 1}))
        loop.run(_batches(12), prefetch=False)
        torch.cuda.synchronize()
        out[plane] = [p.detach().clone() for p in loop.params.values()]
    for a, b in zip(out["0"], out["1"]):
        assert torch.equal(a, b)
    assert len(telemetry.health_ring.entries()) == 12
