"""Shared by ``test_torch_half_training.py`` (bf16) and
``test_torch_half_training_fp16.py`` (fp16), one file per dtype so that
the two JAX references build on two xdist workers at once (not a test
file).

The JAX side runs once per file in a child interpreter (every
``MXNET_*`` variable unset, one XLA thread): a ``BERTForPretrain`` of 2
layers, 32 units, vocab 64 (``Normal(0.02)``, ``mx.random.seed(0)``) cast
to the dtype, then, for each of the seven rules of ``parallel.optim``
(sgd with and without momentum), a one-device ``SPMDTrainer`` taking 3
steps on one batch (B = 2, T = 16) and a ``CompiledLoop`` of 2 steps; it
writes every loss, every value after each step and the dtype of every
value and state leaf after each step (the census), and what the loop did
(ran, or raised and with what).  The port takes the same steps from the
same initial values (the JAX net's, cast) on the CPU.

On a float16 net the port refuses the promoting step (adam, adamw,
lamb) with ``MXNetError`` (``optimizer/fused.py`` ``FP16_PROMOTION``): its
second moment (1 - beta2) g^2 underflows fp16 and the JAX step divides
by epsilon there too, which leaves most weights non-finite (adam) or
thousands of times their size (adamw, lamb) in the reference itself,
values that follow XLA's fp16 arithmetic on the CPU (fused multiply-adds)
rather than the step's formula.  For those rules the census and the
values tests check that the port raises at the step where the JAX
step's values turn fp32.

Tolerances, by the arithmetic:
- the census: equal, leaf by leaf and step by step;
- a loss in 16 bits: ``HALF_ULPS`` ulps of its dtype (the forward sums in
  other orders: torch's and XLA's CPU matmuls and reductions; XLA keeps
  some fused intermediates at fp32);
- a value in 16 bits (the rules that keep a cast net's dtype): both
  sides round every update op to the 16-bit type, but the gradients
  differ by 16-bit ulps (the same orders), so a value may differ by
  ``HALF_ULPS`` ulps of its dtype at its leaf's largest magnitude;
- a promoted (fp32) value: the update's arithmetic follows XLA's
  (``optimizer/cores.py``) and is held to the jitted JAX rule within a
  few fp32 ulps on the same inputs
  (``test_torch_half_kernels.py::test_update_matches_jitted_jax``); here
  the inputs differ: the two sides' bf16 gradients (each op rounded to
  bf16, summed in other orders) differ by bf16 ulps, and Adam's step
  lr m / (sqrt(v) + eps) turns that into up to lr 2^-7 where |g| >> eps
  (its m and v each rounded once more) and into more where |g| nears
  eps / sqrt(1 - beta2) ~ 3e-7: the attention projections' gradients at
  initialisation.  Measured at step 1 of adam: 0.78 % of the elements
  beyond lr / 16, 1.7 % beyond lr / 32, 3.8 % beyond lr / 64 (adamw and
  lamb fewer).  The values are held to ``PROMOTED_ATOL`` = lr / 16 per
  step taken, the elements beyond it counted as below;
- the loss of a promoted (fp32) net: ``PROMOTED_LOSS_RTOL`` relative (the
  fp32 forward of the two sides' values; measured 6.8e-6 after 2
  promoted steps);
- in both: an element whose gradient is within the 16-bit noise of zero
  may change sign between the two implementations, and Adam's (and
  RMSProp's, AdaGrad's) normalised step turns that into a whole step the
  other way: such elements (beyond the tolerance) are counted and kept
  under ``FLIP_SHARE`` of all, and every element stays within 2 lr
  (1 + 2^-6) per step of JAX's;
- fp16: an fp16 run whose values turn non-finite (RMSProp's epsilon of
  1e-8 is 0 in fp16, so a zero second moment divides by zero, in both)
  is compared where both sides are finite, the elements finite on one
  side only counted with the flips."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
V, NB, NT, STEPS, LR = 64, 2, 16, 3, 1e-3
RULES = [("sgd", "sgd", {}), ("sgd_mom", "sgd", {"momentum": 0.9}),
         ("nag", "nag", {}), ("adam", "adam", {}),
         ("adamw", "adamw", {"wd": 0.01}), ("rmsprop", "rmsprop", {}),
         ("adagrad", "adagrad", {}), ("lamb", "lamb", {})]
HALF_ULPS = 4
FLOOR = 2.0 ** -8
PROMOTED_ATOL = LR / 16
PROMOTED_LOSS_RTOL = 1e-4
FLIP_SHARE = 2e-2
STEP_BOUND = 2 * LR * (1 + 2.0 ** -6)     # two Adam steps of opposite sign
_PORT_RUNS = {}

CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json, re, sys
import numpy as np
import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import parallel
from incubator_mxnet_tpu.models import bert as B

out_path, dt, (V, NB, NT, STEPS, LR, RULES) = sys.argv[1], sys.argv[2], \
    eval(sys.argv[3])
out, meta = {}, {}
rng = np.random.default_rng(0)
ids = rng.integers(0, V, (NB, NT)).astype(np.int32)
types = np.zeros((NB, NT), np.int32)
labels = np.concatenate([rng.integers(0, V, (NB, NT)),
                         rng.integers(0, 2, (NB, 1))], axis=1).astype(
                             np.float32)
out.update(ids=ids, types=types, labels=labels)


def f32(a):
    return np.asarray(a).astype(np.float32)


def build():
    mx.random.seed(0)
    net = B.BERTForPretrain(B.BERTModel(vocab_size=V, units=32,
                                        hidden_size=64, num_layers=2,
                                        num_heads=2, max_length=32,
                                        dropout=0.0), vocab_size=V)
    net.initialize(init=mx.init.Normal(0.02))
    net.cast(dt)
    return net


def name_of(net, name):
    # the structural name: the heads' prefix stripped, the encoder's
    # counter reset (each build counts up)
    name = name[len(net.prefix):] if name.startswith(net.prefix) else name
    return re.sub(r"^bertmodel\d+_", "bertmodel0_", name)


mesh = parallel.make_mesh({"data": 1}, devices=jax.devices()[:1])
net = build()
for k, p in net.collect_params().items():
    out["p0/" + name_of(net, k)] = f32(p.data().asnumpy())
for tag, rule, kw in RULES:
    net = build()
    tr = parallel.SPMDTrainer(net, B.BERTPretrainLoss(V), rule,
                              dict(learning_rate=LR, **kw), mesh=mesh)
    names = [name_of(net, p.name) for p in tr._trainable]
    census = []
    for s in range(1, STEPS + 1):
        loss = tr.step(ids, types, labels)
        census.append({"loss": str(loss.dtype),
                       "values": [str(v.dtype) for v in tr._tr_vals],
                       "state": sorted(str(x.dtype) for x in
                                       jax.tree.leaves(tr._opt_state))})
        out[f"{tag}/loss{s}"] = f32(loss)
        for n, v in zip(names, tr._tr_vals):
            out[f"{tag}/p{s}/{n}"] = f32(v)
    meta[tag] = {"names": names, "census": census}
    net = build()
    try:
        lp = parallel.CompiledLoop(net, B.BERTPretrainLoss(V), rule,
                                   dict(learning_rate=LR, **kw),
                                   loop_steps=2, mesh=mesh)
        losses = lp.run([(ids, types, labels)] * 2)
        meta[tag + "/loop"] = {
            "ok": True, "loss": str(np.asarray(losses).dtype),
            "values": sorted({str(v.dtype) for v in lp._tr_vals})}
        out[tag + "/loop_losses"] = f32(losses)
    except Exception as e:
        meta[tag + "/loop"] = {"ok": False, "error": type(e).__name__,
                               "message": str(e)[:400]}
np.savez(out_path, **out)
print(json.dumps(meta))
"""


def reference(tmp_path_factory, dtype):
    """The JAX side's numbers for ``dtype``, computed once in a child
    interpreter: (meta, arrays)."""
    path = tmp_path_factory.mktemp(f"half_{dtype}") / "ref.npz"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_", "MXTPU_"))}
    env.update(JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")]
                                  if x]))
    cfg = repr((V, NB, NT, STEPS, LR, RULES))
    proc = subprocess.run([sys.executable, "-c", CHILD, str(path), dtype,
                           cfg], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    meta = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(path) as z:
        data = dict(z)
    return meta, data


def _net(data, dtype):
    """The port's net at the JAX initial values, cast to ``dtype``."""
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch.convert import load_jax_params
    from incubator_mxnet_tpu_torch.models import bert as tbert
    with tmx.cpu():
        net = tbert.BERTForPretrain(tbert.BERTModel(
            vocab_size=V, units=32, hidden_size=64, num_layers=2,
            num_heads=2, max_length=32, dropout=0.0, device="cpu"),
            vocab_size=V)
    load_jax_params(net, {k[3:]: v for k, v in data.items()
                          if k.startswith("p0/")})
    net.cast(dtype)
    return net


def _dt(t):
    return str(t.dtype).replace("torch.", "")


def port_run(data, dtype, rule, kw):
    """The port's 3 steps of ``rule``: (census, losses, values after each
    step by name), or the ``MXNetError`` a step raised; run once per
    (dtype, rule, options) and kept."""
    key = (dtype, rule, repr(sorted(kw.items())))
    if key not in _PORT_RUNS:
        _PORT_RUNS[key] = _port_run(data, dtype, rule, kw)
    return _PORT_RUNS[key]


def _port_run(data, dtype, rule, kw):
    from incubator_mxnet_tpu_torch import parallel as tpar
    from incubator_mxnet_tpu_torch.base import MXNetError
    from incubator_mxnet_tpu_torch.models import bert as tbert
    net = _net(data, dtype)
    tr = tpar.SPMDTrainer(net, tbert.BERTPretrainLoss(V), rule,
                          dict(learning_rate=LR, **kw),
                          mesh=tpar.make_mesh({"data": 1}, devices=["cpu"]))
    census, losses, values = [], [], []
    for _ in range(STEPS):
        try:
            loss = tr.step(data["ids"], data["types"], data["labels"])
        except MXNetError as e:
            return e
        census.append({"loss": _dt(loss),
                       "values": [_dt(p) for p in tr.params.values()],
                       "state": sorted(_dt(t) for leaves in
                                       tr._opt_state.values()
                                       for t in leaves)})
        losses.append(float(loss))
        values.append({n: p.detach().float().numpy().copy()
                       for n, p in tr.params.items()})
    return census, losses, values


def port_loop(data, dtype, rule, kw):
    """What the port's ``CompiledLoop`` does with 2 steps: ("ok", losses,
    value dtypes) or ("raised", the error's type name, message)."""
    from incubator_mxnet_tpu_torch import parallel as tpar
    from incubator_mxnet_tpu_torch.models import bert as tbert
    net = _net(data, dtype)
    lp = tpar.CompiledLoop(net, tbert.BERTPretrainLoss(V), rule,
                           dict(learning_rate=LR, **kw), loop_steps=2,
                           mesh=tpar.make_mesh({"data": 1}, devices=["cpu"]))
    try:
        losses = lp.run([(data["ids"], data["types"], data["labels"])] * 2)
    except Exception as e:      # the refusal the test expects, by type
        return ("raised", type(e).__name__, str(e))
    return ("ok", losses, sorted({_dt(p) for p in lp.params.values()}))


def ulp_at(x, dtype):
    """The ulp of ``dtype`` (bfloat16, float16) at magnitude ``x``."""
    x = max(float(x), 2.0 ** -24)
    return 2.0 ** (np.floor(np.log2(x)) - (7 if dtype == "bfloat16"
                                            else 10))


def ulps(got, want, dtype):
    """The largest distance of ``got`` from ``want`` (fp32 numpy arrays of
    ``dtype`` values) in ulps of ``dtype`` at max(|want|, FLOOR x the
    largest), over the elements where both are finite."""
    ok = np.isfinite(got) & np.isfinite(want)
    if not ok.any():
        return 0.0
    g, w = got[ok].astype(np.float64), want[ok].astype(np.float64)
    mag = np.maximum(np.abs(w), max(FLOOR * float(np.abs(w).max()),
                                    2.0 ** -24))
    mant = 7 if dtype == "bfloat16" else 10
    ulp = np.exp2(np.floor(np.log2(mag)) - mant)
    return float((np.abs(g - w) / ulp).max())


def refused(meta, dtype, tag, rule, kw, data):
    """Whether the port refuses ``rule`` on a ``dtype`` net: the promoting
    step of a float16 net, refused at the first step, where the JAX
    step's values turn fp32 (the module docstring)."""
    got = port_run(data, dtype, rule, kw)
    first = meta[tag]["census"][0]["values"]
    if dtype == "float16" and first and set(first) == {"float32"}:
        assert isinstance(got, Exception), (tag, "not refused")
        assert "float16" in str(got) and "SPMDTrainer" in str(got), got
        return True
    assert not isinstance(got, Exception), (tag, got)
    return False


def check_census(meta, dtype, tag, rule, kw, data):
    if refused(meta, dtype, tag, rule, kw, data):
        return
    census, _, _ = port_run(data, dtype, rule, kw)
    want = meta[tag]["census"]
    assert census == want, (tag, census, want)


def check_values(meta, dtype, tag, rule, kw, data):
    """Losses and values after each of the 3 steps against JAX's (the
    tolerances of the module docstring)."""
    if refused(meta, dtype, tag, rule, kw, data):
        return
    census, losses, values = port_run(data, dtype, rule, kw)
    names = meta[tag]["names"]
    for s in range(STEPS):
        jl = float(data[f"{tag}/loss{s + 1}"])
        ldt = census[s]["loss"]
        if np.isfinite(jl) or np.isfinite(losses[s]):
            if ldt == "float32":
                assert abs(losses[s] - jl) <= PROMOTED_LOSS_RTOL * max(
                    1.0, abs(jl)), (tag, s, losses[s], jl)
            else:
                assert ulps(np.float32([losses[s]]), np.float32([jl]),
                            ldt) <= HALF_ULPS, (tag, s, losses[s], jl)
        flips = total = 0
        for i, n in enumerate(names):
            got, want = values[s][n], data[f"{tag}/p{s + 1}/{n}"]
            vdt = census[s]["values"][i]
            total += want.size
            flips += int((np.isfinite(got) != np.isfinite(want)).sum())
            ok = np.isfinite(got) & np.isfinite(want)
            if not ok.any():
                continue
            diff = np.abs(got[ok] - want[ok]).astype(np.float64)
            if vdt == "float32":
                tol = PROMOTED_ATOL * (s + 1)
            else:
                tol = HALF_ULPS * ulp_at(float(np.abs(want[ok]).max()), vdt)
            flips += int((diff > tol).sum())
            assert float(diff.max()) <= STEP_BOUND * (s + 1) + tol, (
                tag, s, n, float(diff.max()))
        assert flips <= FLIP_SHARE * max(total, 1), (tag, s, flips, total)


def check_loop(meta, dtype, tag, rule, kw, data):
    """The port's ``CompiledLoop`` runs where the JAX one runs (same loss
    and value dtypes; losses as a 16-bit step's) and raises
    ``MXNetError`` where the JAX scan raises its carry-type error, naming
    the dtype change."""
    jax_side = meta[tag + "/loop"]
    got = port_loop(data, dtype, rule, kw)
    if jax_side["ok"]:
        assert got[0] == "ok", (tag, got)
        raw = np.asarray(got[1])
        # numpy has no bfloat16: the port's bf16 losses come back as fp32
        # numbers, the JAX ones as bfloat16
        assert jax_side["loss"] == str(raw.dtype) or (
            jax_side["loss"] == "bfloat16" and raw.dtype == np.float32)
        losses = raw.astype(np.float32)
        want = data[tag + "/loop_losses"]
        assert got[2] == jax_side["values"]
        assert ulps(losses, want, jax_side["values"][0]) <= HALF_ULPS
    else:
        assert jax_side["error"] == "TypeError" and \
            "carry" in jax_side["message"]
        assert got[0] == "raised" and got[1] == "MXNetError", (tag, got)
        assert "float32" in got[2] and dtype in got[2], got[2]
