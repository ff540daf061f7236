"""The 16-bit instances of the port's kernels (``incubator_mxnet_tpu_torch/
kernels``): the plain versions of K1 (with lse, and with the key bias), K6
flash_bwd_dq and K7 flash_bwd_dkv at bf16 and fp16 inputs, held to the JAX
package's Pallas B1/B2/B3 in interpret mode on the same 16-bit inputs
(made with numpy from a seed); the 16-bit K1's, K6's and K7's
arithmetic (two-part P and dS), modelled in torch, against the plain
versions; and, on a card, each 16-bit CUDA instance against its plain
version (``cuda`` marker, skipped without a GPU): K1, K6, K7 and
all-finite per element type, and K8's and K9's body in its 16-bit,
promoting and multi_precision instances, bit for bit.

Tolerances.  o, dq, dk and dv are 16-bit and must be equal or 1 ulp of
their dtype apart, the ulp taken at max(|x|, 2^-8 of the tensor's
largest): both sides compute in fp32 and round once, and their fp32
values differ by ~1e-6 of the largest value (blockwise online softmax
against a whole-row one), which is below a 16-bit ulp there; an output
near zero is held at that floor's ulp.  The fp32 outputs (lse, the
key-bias rows) are held to 1e-6 relative plus 1e-6 of the tensor's
largest value.  The backward of both sides reads the same out and lse
(the Pallas forward's), so the comparison is of the backward alone.

The JAX functions called here are pure: no JAX-package global is read or
written."""
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError

tfa = importlib.import_module(
    "incubator_mxnet_tpu_torch.kernels.flash_attention")

ROOT = Path(__file__).resolve().parents[1]
H, D = 2, 16
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
ULP_FLOOR = 2.0 ** -8
FP32_TOL = 1e-6
# at most this share of a 16-bit output may differ from the plain version
# at all (chip_smoke.py's DIFF_SHARE): an fp32 result inside rounds
# differently only where it sits on a rounding boundary
DIFF_SHARE = {torch.bfloat16: 1e-2, torch.float16: 5e-2}


def _jax():
    """The JAX kernel module, ``jax`` and ``jax.numpy``, imported where a
    test needs them, so that the card tests collect without JAX."""
    import jax
    import jax.numpy as jnp
    return (importlib.import_module(
        "incubator_mxnet_tpu.kernels.flash_attention"), jax, jnp)


def ulps(got, want):
    """The largest distance of ``got`` from ``want`` (torch tensors of one
    16-bit dtype) in ulps of that dtype at max(|want|, ULP_FLOOR x its
    largest)."""
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    g, w = got.float(), want.float()
    mag = w.abs().clamp(min=max(ULP_FLOOR * float(w.abs().max()),
                                2.0 ** -24))
    mant = 7 if want.dtype == torch.bfloat16 else 10
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
    if want.dtype == torch.float16:
        ulp = ulp.clamp(min=2.0 ** -24)
    return float(((g - w).abs() / ulp).max())


def _fp32_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    big = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=FP32_TOL,
                               atol=FP32_TOL * max(big, 1.0))


def _inputs(seed, B, T, dtype, masked=False, d=D):
    """q, k, v, dO (B*H, T, d) as 16-bit numpy-made values, a (B, 1, T)
    fp32 key bias or None, and the scale."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(B * H, T, d).astype(
        np.float32)).to(DTYPES[dtype]) for _ in range(4))
    bias = None
    if masked:
        m = (rng.rand(B, T) > 0.3).astype(np.float32)
        m[:, 0] = 1.0
        bias = torch.from_numpy(np.where(m > 0, 0.0, -1e30).astype(
            np.float32).reshape(B, 1, T))
    return q, k, v, g, bias, 1.0 / np.sqrt(d)


def _to_jax(t):
    """A 16-bit (or fp32) torch tensor as a jax array of the same dtype,
    through its exact fp32 values."""
    _, _, jnp = _jax()
    if t is None:
        return None
    dt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
          torch.float32: jnp.float32}[t.dtype]
    return jnp.asarray(t.float().numpy()).astype(dt)


def _from_jax(a, dtype):
    """A jax array as a torch tensor of ``dtype`` (exact: through fp32)."""
    return torch.from_numpy(np.array(a.astype("float32"))).to(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,causal,masked", [
    (128, False, False), (128, True, True), (100, False, True),
])
def test_plain_16bit_attention_matches_pallas_interpret(dtype, T, causal,
                                                        masked):
    """K1 with lse, then K6/K7 on the same out and lse: the plain versions
    at 16 bits against Pallas B1 (with lse), B2 and B3 in interpret mode;
    o, dq, dk, dv in the input's dtype within 1 ulp, lse, dd and the
    key-bias cotangent (fp32) within 1e-6."""
    jfa, jax, jnp = _jax()
    dt = DTYPES[dtype]
    q, k, v, g, bias, scale = _inputs(T + 3 * causal + masked, 2, T, dtype,
                                      masked)

    def run(a, b, c, dout, bb):
        out, lse = jfa._flash_fwd_impl(a, b, c, bb, scale, causal, True, H,
                                       with_lse=True)
        return out, lse, jfa._flash_bwd_impl(a, b, c, bb, out, lse, dout,
                                             scale, causal, True, H)
    pout, plse, (pdq, pdk, pdv, pdb) = jax.jit(run)(
        *(_to_jax(x) for x in (q, k, v, g, bias)))
    assert pout.dtype == _to_jax(q).dtype and pdq.dtype == pout.dtype
    out, lse = tfa._plain_attention_lse(q, k, v, scale, causal,
                                        tfa._per_head(bias, H))
    assert out.dtype == dt and lse.dtype == torch.float32
    assert ulps(out, _from_jax(pout, dt)) <= 1.0
    _fp32_close(lse.numpy(), plse)
    # the backward of both on the Pallas forward's out and lse
    jout, jlse = _from_jax(pout, dt), torch.from_numpy(np.array(plse))
    dd = tfa._bwd_dd(jout, g)
    _fp32_close(dd.numpy(), jnp.sum(pout.astype(jnp.float32)
                                    * _to_jax(g).astype(jnp.float32), -1))
    dq, dk, dv, dbs = tfa._plain_flash_bwd_dd(q, k, v, bias, g, jlse, dd,
                                              scale, causal, H)
    for got, want in ((dq, pdq), (dk, pdk), (dv, pdv)):
        assert got.dtype == dt
        assert ulps(got, _from_jax(want, dt)) <= 1.0
    if bias is not None:
        _fp32_close(tfa._dbias(dbs, H).numpy(), pdb)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_16bit_autograd_route_keeps_the_dtype(dtype):
    """``flash_attention`` with a gradient to record on 16-bit tensors:
    the output and every gradient in the input's dtype, lse fp32, as the
    JAX ``custom_vjp`` gives them; ``MXNET_FLASH_BWD=xla``-free."""
    dt = DTYPES[dtype]
    q, k, v, g, _, _ = _inputs(5, 2, 24, dtype)
    q4, k4, v4 = (x.reshape(2, H, 24, D).requires_grad_(True)
                  for x in (q, k, v))
    out, lse = tfa.flash_attention_lse(q4, k4, v4, causal=True)
    assert out.dtype == dt and lse.dtype == torch.float32
    out.backward(g.reshape(2, H, 24, D))
    assert all(x.grad.dtype == dt for x in (q4, k4, v4))


def test_decode_kernels_refuse_a_16bit_query_by_name():
    """K2-K5 take a query of fp32, bf16 or fp16: a 16-bit one passes a
    wrapper's dtype checks (it fails only at the device check, since the
    tensor lies on the CPU), while an fp64 or int32 query is refused by
    name, naming the dtypes the kernels take, before any launch."""
    pos = torch.zeros(1, dtype=torch.int32)
    for fn in (tfa._decode_checks, tfa._verify_checks):
        shape = (1, 2, 16) if fn is tfa._decode_checks else (1, 2, 1, 16)
        for dt in (torch.bfloat16, torch.float16):
            with pytest.raises(MXNetError, match="needs CUDA tensors"):
                fn("decode", torch.zeros(shape, dtype=dt), pos, 1, 2, 16)
        for dt in (torch.float64, torch.int32):
            with pytest.raises(MXNetError,
                               match=f"q is {dt}; the kernel takes"):
                fn("decode", torch.zeros(shape, dtype=dt), pos, 1, 2, 16)


def test_16bit_instances_count_under_their_own_names():
    """A 16-bit instance counts its launches under "<kernel>.<instance>"
    beside its kernel's fp32 count, from its first launch; a reset
    removes those names again, so the counts of a run without 16-bit
    launches keep the kernels' own names only."""
    tfa.reset_launch_counts()
    base = dict(tfa.launch_counts)
    assert all("." not in k for k in base)
    tfa._count("flash_fwd.bf16", 24)
    tfa.add_launches({"multi_tensor_adam.promote_bf16": 1})
    assert tfa.launch_counts["flash_fwd.bf16"] == 24
    assert tfa.launch_counts["multi_tensor_adam.promote_bf16"] == 1
    assert {k for k in tfa.launch_counts if "." in k} == {
        "flash_fwd.bf16", "multi_tensor_adam.promote_bf16"}
    tfa.reset_launch_counts()
    assert tfa.launch_counts == base


def _emulated_k1(q, k, v, bias, scale, causal, parts=2):
    """The arithmetic of K1's 16-bit instance (``csrc/flash_fwd.cu``
    ``flash_fwd16_kernel``) in torch on the CPU, over (BH, T, D) 16-bit
    q, k, v and a (BH, 1, T) fp32 key bias or None.  Per 64-key tile: S =
    Q K^T of the unscaled 16-bit values (exact products, fp32 sums), then
    scale * log2(e) and the key bias in base 2 (one rounding, as the FFMA),
    -inf past the diagonal, the online softmax in base 2, and O += hi V +
    lo V with P's two parts hi = E(P), lo = E(P - hi) in the input's dtype
    and the products in fp32.  ``parts=1`` rounds P once instead (the
    control).  Returns (o in q's dtype, lse (BH, T) fp32)."""
    dt = q.dtype
    BH, T, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    c = float(np.float32(scale) * np.float32(np.log2(np.e)))
    log2e = float(np.float32(np.log2(np.e)))
    m = torch.full((BH, T), float("-inf"))
    safe = torch.zeros(BH, T)
    l = torch.zeros(BH, T)
    acc = torch.zeros(BH, T, D)
    rows = torch.arange(T)[:, None]
    for k0 in range(0, T, 64):
        kt, vt = kf[:, k0:k0 + 64], vf[:, k0:k0 + 64]
        s = (qf @ kt.transpose(1, 2)).double() * c
        if bias is not None:
            s = s + (bias[:, :, k0:k0 + 64] * log2e).double()
        s = s.float()
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[1])[None, :]
            s = s.masked_fill(keys > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp2(m - safe)
        p = torch.exp2(s - safe[..., None])
        m = m_new
        l = l * alpha + p.sum(-1)
        hi = p.to(dt)
        acc = acc * alpha[..., None] + hi.float() @ vt
        if parts == 2:
            acc = acc + (p - hi.float()).to(dt).float() @ vt
    inv = 1.0 / l.clamp(min=1e-30)
    lse = safe * float(np.log(2.0)) + torch.log(l.clamp(min=1e-30))
    return (acc * inv[..., None]).to(dt), lse


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,causal,masked", [
    (128, False, False), (128, False, True), (256, True, False),
])
def test_two_part_p_holds_the_16bit_k1_contract(dtype, T, causal, masked):
    """The 16-bit K1's arithmetic (:func:`_emulated_k1`: unscaled 16-bit
    products, P in two 16-bit parts) against ``_plain_attention_lse`` at
    small copies of chip_smoke.py's three 16-bit attention shapes (B*H =
    4, D = 64; T = 128 dense, T = 128 with a key bias that masks one
    batch's every key, T = 256 causal): o within 1 ulp with at most
    ``DIFF_SHARE`` of it different, lse within 1e-6.  The control, P
    rounded once to the inputs' dtype before P V, differs in more than
    ``DIFF_SHARE`` of the elements: why P keeps two parts."""
    dt = DTYPES[dtype]
    Dh = 64
    rng = np.random.RandomState(T + causal + 2 * masked)
    q, k, v = (torch.from_numpy(rng.randn(4, T, Dh).astype(np.float32))
               .to(dt) for _ in range(3))
    bias = None
    if masked:
        mask = (rng.rand(2, T) > 0.3).astype(np.float32)
        mask[0, 0] = 1.0
        mask[1] = 0.0                      # one batch row masked everywhere
        bias = tfa._key_bias(torch.from_numpy(mask), 2, T, "cpu")
    scale = 1.0 / np.sqrt(Dh)
    ph = tfa._per_head(bias, H)
    want, wlse = tfa._plain_attention_lse(q, k, v, scale, causal, ph)
    got, lse = _emulated_k1(q, k, v, ph, scale, causal)
    share = float((got != want).float().mean())
    assert ulps(got, want) <= 1.0
    assert share <= DIFF_SHARE[dt], share
    _fp32_close(lse.numpy(), wlse.numpy())
    one, _ = _emulated_k1(q, k, v, ph, scale, causal, parts=1)
    assert float((one != want).float().mean()) > DIFF_SHARE[dt]


def _parts(x, dt, parts, scaled):
    """``x`` (BH, M, 64) fp32 as the list of its 16-bit parts in fp32: hi =
    E(x), lo = E(x - hi) (``parts=1``: hi alone), each row first multiplied
    by ``scaled`` (BH, M, 1), a power of two, or not at all (None)."""
    if scaled is not None:
        x = x * scaled
    hi = x.to(dt).float()
    return [hi, (x - hi).to(dt).float()] if parts == 2 else [hi]


def _row_tiled(x, y, dt, parts, scaled="rows"):
    """sum over the 64-wide tiles j of the contraction axis of x[..., j]
    (BH, M, K) in 16-bit parts times y[j] (BH, K, N), summed in fp32 tile
    by tile: K6's and K7's accumulating products (``flash_bwd_common.cuh``
    ``acc_products16``).  In fp16, with ``scaled="rows"`` (dS), each row
    goes in multiplied by 2^e, e the running least of 141 minus the
    biased exponent of the tile row's largest |x| (from 126), and the
    accumulator row is rescaled when e falls (``row_scale``); with a
    number (P: 2^14) every row is multiplied by it; the result is divided
    by the scale.  ``scaled=None`` leaves the rows as they are."""
    BH, M, K = x.shape
    fp16 = dt == torch.float16 and scaled is not None
    acc = torch.zeros(BH, M, y.shape[2])
    e = torch.full((BH, M, 1), 126.0 if scaled == "rows" else
                   float(np.log2(scaled or 1.0)))
    for j in range(0, K, 64):
        xt = x[:, :, j:j + 64]
        if fp16 and scaled == "rows":
            m = xt.abs().amax(-1, keepdim=True)
            _, ex = torch.frexp(m)          # m = f 2^ex, f in [1/2, 1)
            et = torch.where(m > 0, (15 - ex).float().clamp(max=126.0), e)
            en = torch.minimum(e, et)
            acc = acc * torch.exp2(en - e)
            e = en
        for part in _parts(xt, dt, parts, torch.exp2(e) if fp16 else None):
            acc = acc + part @ y[:, j:j + 64]
    return acc * torch.exp2(-e) if fp16 else acc


def _emulated_k6k7(q, k, v, bias, g, lse, dd, scale, causal, parts=2,
                   scaled=True):
    """The arithmetic of K6's and K7's 16-bit instances (``csrc/
    flash_bwd_dq.cu`` ``flash_bwd_dq16_kernel``, ``csrc/flash_bwd_dkv.cu``
    ``flash_bwd_dkv16_kernel``) in torch on the CPU, over (BH, T, D)
    16-bit q, k, v, g, a (BH, 1, T) fp32 key bias or None, and lse, dd
    (BH, T) fp32.  S and dP are products of the unscaled 16-bit values
    (exact products, fp32 sums); P = exp2((fma(s, scale, b) - lse) *
    log2(e)) in prob()'s order (one rounding for the FMA), 0 past the
    diagonal; dS = P (dP - dd) in fp32; dQ = dS K, dK = dS^T Q and dV =
    P^T dO with P and dS in two 16-bit parts (in fp16 dS's rows scaled by
    powers of two, P by 2^14), summed in fp32 per 64-row tile
    (``_row_tiled``).
    ``parts=1`` rounds P and dS once instead (the control);
    ``scaled=False`` leaves fp16's P and dS unscaled (the control at small
    gradients).  Returns (dq, dk, dv in q's dtype, dbs (BH, T) fp32, the
    column sums of dS)."""
    dt = q.dtype
    BH, T, _ = q.shape
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    log2e = float(np.float32(np.log2(np.e)))
    s = qf @ kf.transpose(1, 2)
    b = torch.zeros(BH, 1, T) if bias is None else bias
    x = (s.double() * float(np.float32(scale)) + b.double()).float()
    p = torch.exp2((x - lse[..., None]) * log2e)
    if causal:
        p = p.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), 0.0)
    ds = p * (gf @ vf.transpose(1, 2) - dd[..., None])
    rows, fixed = ("rows", 2.0 ** 14) if scaled else (None, None)
    dq = _row_tiled(ds, kf, dt, parts, rows)
    dk = _row_tiled(ds.transpose(1, 2).contiguous(), qf, dt, parts, rows)
    dv = _row_tiled(p.transpose(1, 2).contiguous(), gf, dt, parts, fixed)
    c = float(np.float32(scale))
    return (dq * c).to(dt), (dk * c).to(dt), dv.to(dt), ds.sum(1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,causal,masked,tiny", [
    (128, False, False, False), (128, False, True, False),
    (256, True, False, False), (256, True, False, True),
])
def test_two_part_p_and_ds_hold_the_16bit_k6_k7_contract(dtype, T, causal,
                                                         masked, tiny):
    """The 16-bit K6's and K7's arithmetic (:func:`_emulated_k6k7`:
    unscaled 16-bit score products, P and dS in two 16-bit parts, fp16
    rows scaled by powers of two) against ``_plain_flash_bwd_dd`` at small
    copies of chip_smoke.py's 16-bit backward shapes (B*H = 4, D = 64; T
    = 128 dense, T = 128 with a key bias that masks one batch's every
    key, T = 256 causal, and that with dO scaled by 2^-10, where fp16's
    unscaled parts fall into its subnormals): dq, dk and dv within 1 ulp
    with at most ``DIFF_SHARE`` of them different, dbs within 1e-6.  The
    control, P and dS rounded once to the inputs' dtype, differs in more
    than ``DIFF_SHARE`` of the elements of each: why both keep two parts.
    At the small dO the fp16 control is the two parts without the row
    scaling, and dq and dk then differ in more than ``DIFF_SHARE`` (dv =
    P^T dO, whose P does not scale with dO, does not): why fp16 scales
    its rows."""
    dt = DTYPES[dtype]
    Dh = 64
    rng = np.random.RandomState(T + causal + 2 * masked + 4 * tiny)
    q, k, v, g = (torch.from_numpy(rng.randn(4, T, Dh).astype(np.float32))
                  .to(dt) for _ in range(4))
    if tiny:
        g = (g.float() * 2.0 ** -10).to(dt)
    bias = None
    if masked:
        mask = (rng.rand(2, T) > 0.3).astype(np.float32)
        mask[0, 0] = 1.0
        mask[1] = 0.0                      # one batch row masked everywhere
        bias = tfa._key_bias(torch.from_numpy(mask), 2, T, "cpu")
    scale = 1.0 / np.sqrt(Dh)
    out, lse = tfa._plain_attention_lse(q, k, v, scale, causal,
                                        tfa._per_head(bias, H))
    dd = tfa._bwd_dd(out, g)
    want = tfa._plain_flash_bwd_dd(q, k, v, bias, g, lse, dd, scale, causal,
                                   H)
    got = _emulated_k6k7(q, k, v, tfa._per_head(bias, H), g, lse, dd, scale,
                         causal)
    unscaled = tiny and dt == torch.float16
    one = _emulated_k6k7(q, k, v, tfa._per_head(bias, H), g, lse, dd, scale,
                         causal, **({"scaled": False} if unscaled
                                    else {"parts": 1}))
    for name, a, c, w in zip(("dq", "dk", "dv"), got, one, want):
        share = float((a != w).float().mean())
        assert ulps(a, w) <= 1.0, name
        assert share <= DIFF_SHARE[dt], (name, share)
        if not (unscaled and name == "dv"):
            assert float((c != w).float().mean()) > DIFF_SHARE[dt], name
    _fp32_close(got[3].numpy(), want[3].numpy())


UPDATE_RULES = [("sgd", {}), ("sgd", {"momentum": 0.9}), ("nag", {}),
                ("adam", {"wd": 0.01}), ("adamw", {"wd": 0.01}),
                ("rmsprop", {}), ("adagrad", {"wd": 0.01}),
                ("lamb", {"wd": 0.01})]
UPDATE_SHAPES = [(64, 33), (257,), (16,)]
_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
FP32_ULPS = 4


def _fp32_ulps(got, want):
    """The largest distance of ``got`` from ``want`` (fp32 numpy arrays)
    in fp32 ulps at the largest |want| (an update's rounding is of its
    terms, not of a value near zero); the non-finite elements must
    agree."""
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    if not fin.any():
        return 0.0
    d = np.abs(got[fin].astype(np.float64) - want[fin])
    return float(d.max() / np.spacing(np.abs(want[fin]).max()))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rule,kw", UPDATE_RULES,
                         ids=["sgd", "sgd_mom", "nag", "adam", "adamw",
                              "rmsprop", "adagrad", "lamb"])
def test_update_matches_jitted_jax(dtype, rule, kw):
    """Each rule of ``parallel.optim`` over 3 steps against the JAX rule's
    update under ``jax.jit``, which is what the JAX train step runs, each
    step from the same values, gradients (drawn over six decades, down to
    fp16's underflow) and state: the JAX step's.  bf16: a rule that keeps the dtype equals it
    bit for bit; the promoting step (adam, adamw, lamb: fp32 values over
    bf16 moments) and the fp32 steps after it are held within
    ``FP32_ULPS`` fp32 ulps (adam's first step bit for bit), which takes
    XLA's excess precision (``optimizer/cores.py``): without it the
    promoted values land up to 2.3 % of an update away
    (``tools/jax_half_update_rounding.py``).  What remains is XLA's own
    fp32 rewriting (fused multiply-adds, (a / b) / c as a / (b c)), as on
    the fp32 paths.  fp16: a rule that keeps the dtype is within 1 ulp of
    the value plus 2 of its update (XLA fuses multiply-adds in fp16 on
    this backend, the port rounds each op), the non-finite elements the
    same; a promoting rule raises ``MXNetError`` by name at its first
    step."""
    _, jax, jnp = _jax()
    from incubator_mxnet_tpu.parallel import optim as jopt
    from incubator_mxnet_tpu_torch.optimizer import fused
    from incubator_mxnet_tpu_torch.parallel import optim as topt
    dt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    jo = getattr(jopt, rule)(learning_rate=1e-3, **kw)
    to = getattr(topt, rule)(learning_rate=1e-3, **kw)
    tp = [torch.from_numpy((rng.standard_normal(sh) * 0.02).astype(
        np.float32)).to(dt) for sh in UPDATE_SHAPES]
    jp = [_to_jax(t) for t in tp]
    js, ts = jo.init(jp), to.init(tp)
    upd = jax.jit(jo.update)
    for step in range(1, 4):
        tg = [torch.from_numpy((rng.standard_normal(sh) * 1e-2 * np.exp(
            rng.uniform(-6, 0, sh))).astype(np.float32)).to(t.dtype)
            for sh, t in zip(UPDATE_SHAPES, tp)]
        tstep = torch.tensor(step, dtype=torch.int32)
        if dtype == "float16" and to.promotes:
            with pytest.raises(MXNetError, match="float16 net"):
                to.update(tp, tg, ts, tstep)
            assert fused.FP16_PROMOTION
            return
        # both sides start each step from the JAX step's values and state
        tp = [_from_jax(j, _TORCH[str(j.dtype)]) for j in jp]
        ts = {k: [_from_jax(j, _TORCH[str(j.dtype)]) for j in js[k]]
              for k in js}
        before = [np.asarray(j.astype("float32")) for j in
                  list(jp) + [x for k in sorted(js) for x in js[k]]]
        jp, js = upd(jp, [_to_jax(g) for g in tg], js,
                     jnp.asarray(step, jnp.int32))
        tp, ts = to.update(tp, tg, ts, tstep)
        tp = list(tp)
        pairs = list(zip(jp, tp)) + [
            (j, t) for k in sorted(ts) for j, t in zip(js[k], ts[k])]
        for (j, t), old in zip(pairs, before):
            assert str(j.dtype) == str(t.dtype).replace("torch.", "")
            want = np.asarray(j.astype("float32"))
            got = t.float().numpy()
            if t.dtype == torch.float32:
                if rule == "adam" and step == 1:
                    np.testing.assert_array_equal(got, want)
                assert _fp32_ulps(got, want) <= FP32_ULPS, (step,)
            elif dtype == "bfloat16":
                np.testing.assert_array_equal(got, want)
            else:
                # XLA fuses multiply-adds, so it rounds w + u and the
                # term u's own products fewer times than the port, which
                # rounds each op: 1 ulp of the larger value plus 2 of the
                # term
                fin = np.isfinite(want)
                assert np.array_equal(fin, np.isfinite(got))
                g16, w16 = got[fin], want[fin]
                u16 = (w16 - old[fin]).astype(np.float16)
                one = np.spacing(np.maximum(np.abs(g16), np.abs(w16)).astype(
                    np.float16)).astype(np.float32) + 2 * np.spacing(
                        np.abs(u16)).astype(np.float32)
                assert (np.abs(g16 - w16) <= one).all(), (step,)


# ------------------------------------------------ on the card (cuda mark)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,T,Dh,causal,masked", [
    (4, 128, 16, False, False), (2, 300, 16, True, True),
    (2, 1024, 16, True, False),
    # every head dim of K1's wgmma body, the ragged edges of its 64-row
    # tiles and 128-row blocks, causal with a key bias
    (4, 128, 32, False, False), (4, 128, 64, False, True),
    (4, 128, 128, False, False), (2, 1, 64, False, False),
    (2, 63, 64, False, True), (2, 65, 64, True, False),
    (2, 200, 32, True, True), (2, 200, 128, True, True),
    (2, 1024, 64, True, False),
])
def test_cuda_16bit_attention_matches_plain(dtype, B, T, Dh, causal,
                                            masked):
    """K1 (with lse), K6 and K7 at 16 bits against their plain versions on
    the same inputs (the backward on the kernel forward's out and lse):
    o, dq, dk and dv within 1 ulp with at most ``DIFF_SHARE`` of each
    different, lse and the key-bias rows within 1e-4 (fp32, summation
    order)."""
    _need_cuda()
    dt = DTYPES[dtype]
    q, k, v, g, bias, scale = (
        x.cuda() if isinstance(x, torch.Tensor) else x
        for x in _inputs(T + B, B, T, dtype, masked, Dh))
    tfa.reset_launch_counts()
    out, lse = tfa._flash_fwd_cuda(q, k, v, bias, scale, causal, H,
                                   with_lse=True)
    pout, plse = tfa._plain_attention_lse(q, k, v, scale, causal,
                                          tfa._per_head(bias, H))
    torch.cuda.synchronize()
    assert ulps(out.cpu(), pout.cpu()) <= 1.0
    assert float((out != pout).float().mean()) <= DIFF_SHARE[dt]
    assert float((lse - plse).abs().max()) <= 1e-4 * max(
        1.0, float(plse.abs().max()))
    dd = tfa._bwd_dd(out, g)
    got = tfa._flash_bwd_cuda(q, k, v, bias, g, lse, dd, scale, causal, H)
    want = tfa._plain_flash_bwd_dd(q, k, v, bias, g, lse, dd, scale, causal,
                                   H)
    torch.cuda.synchronize()
    # at T = 1, P = 1 and dS = dP - dd is 0 but for the rounding of one dot
    # product taken two ways (dd = rowsum(dO o), o = v): dq and dk are that
    # noise (~5e-7) in both versions, so only dv (= dO) is held there
    pairs = list(zip(got[:3], want[:3])) if T > 1 else [(got[2], want[2])]
    for a, b in pairs:
        assert a.dtype == dt and ulps(a.cpu(), b.cpu()) <= 1.0
        assert float((a != b).float().mean()) <= DIFF_SHARE[dt]
    assert float((got[3] - want[3]).abs().max()) <= 1e-4 * max(
        1.0, float(want[3].abs().max()))
    inst = "bf16" if dt == torch.bfloat16 else "fp16"
    assert [tfa.launch_counts[f"{n}.{inst}"] for n in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")] == [1, 1, 1]
    assert tfa.launch_counts["flash_fwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_cuda_16bit_k1_takes_any_scale(dtype, scale):
    """K1's 16-bit instances at a negative and a zero scale, dense and
    causal, with and without the key bias, against the plain version:
    the scale is folded into the exponent only where it is positive."""
    _need_cuda()
    dt = DTYPES[dtype]
    for causal, masked in ((False, False), (True, True)):
        q, k, v, _, bias, _ = (
            x.cuda() if isinstance(x, torch.Tensor) else x
            for x in _inputs(7, 2, 130, dtype, masked, 64))
        out, lse = tfa._flash_fwd_cuda(q, k, v, bias, scale, causal, H,
                                       with_lse=True)
        pout, plse = tfa._plain_attention_lse(q, k, v, scale, causal,
                                              tfa._per_head(bias, H))
        torch.cuda.synchronize()
        assert ulps(out.cpu(), pout.cpu()) <= 1.0
        assert float((out != pout).float().mean()) <= DIFF_SHARE[dt]
        assert float((lse - plse).abs().max()) <= 1e-4 * max(
            1.0, float(plse.abs().max()))


def _check_cuda_bwd(q, k, v, g, bias, scale, causal):
    """K6 and K7 at 16 bits on the kernel forward's out and lse against
    their plain versions: dq, dk, dv within 1 ulp with at most
    ``DIFF_SHARE`` of each different, the key-bias rows within 1e-4."""
    dt = q.dtype
    out, lse = tfa._flash_fwd_cuda(q, k, v, bias, scale, causal, H,
                                   with_lse=True)
    dd = tfa._bwd_dd(out, g)
    got = tfa._flash_bwd_cuda(q, k, v, bias, g, lse, dd, scale, causal, H)
    want = tfa._plain_flash_bwd_dd(q, k, v, bias, g, lse, dd, scale, causal,
                                   H)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == dt and ulps(a.cpu(), b.cpu()) <= 1.0
        assert float((a != b).float().mean()) <= DIFF_SHARE[dt]
    assert float((got[3] - want[3]).abs().max()) <= 1e-4 * max(
        1.0, float(want[3].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_cuda_16bit_k6_k7_take_any_scale(dtype, scale):
    """K6's and K7's 16-bit instances at a negative and a zero scale,
    dense and causal, with and without the key bias, against the plain
    versions: S is the unscaled product, and the scale comes after it."""
    _need_cuda()
    for causal, masked in ((False, False), (True, True)):
        q, k, v, g, bias, _ = (
            x.cuda() if isinstance(x, torch.Tensor) else x
            for x in _inputs(7, 2, 130, dtype, masked, 64))
        _check_cuda_bwd(q, k, v, g, bias, scale, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,causal", [(1024, True), (200, False)])
def test_cuda_16bit_k6_k7_hold_small_gradients(dtype, T, causal):
    """K6 and K7 at 16 bits with dO scaled by 2^-10: fp16's P and dS rows
    are scaled by powers of two before their split, so their parts stay
    out of fp16's subnormals and the contract holds as at unit gradients
    (unscaled, dq and dk differ in ~25 % of the elements in the CPU
    model)."""
    _need_cuda()
    q, k, v, g, _, scale = (
        x.cuda() if isinstance(x, torch.Tensor) else x
        for x in _inputs(11, 2, T, dtype, False, 64))
    g = (g.float() * 2.0 ** -10).to(g.dtype)
    _check_cuda_bwd(q, k, v, g, None, scale, causal)


def _leaves(seed, shapes, dt, scale, positive=False, device="cuda"):
    rng = np.random.RandomState(seed)
    out = [rng.randn(*s).astype(np.float32) * scale for s in shapes]
    return [torch.from_numpy(np.abs(x) if positive else x).to(device).to(dt)
            for x in out]


SHAPES = [(64, 33), (1000,), (7,), (3, 5, 11), (16384 + 5,)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,dtype", [
    ("plain", "bfloat16"), ("plain", "float16"), ("promote", "bfloat16"),
    ("promote", "float16"), ("follow", "bfloat16"), ("master", "float16")])
@pytest.mark.parametrize("rule", ["adam", "sgd", "sgd_mom", "nag", "adamw",
                                  "rmsprop", "adagrad"])
def test_cuda_16bit_updates_match_plain_bit_for_bit(mode, dtype, rule):
    """K8's and K9's 16-bit, promoting and multi_precision instances
    against their plain versions (the per-leaf ``cores`` loops with JAX's
    typing), bit for bit in the new weights, the state and the masters,
    with the gradient stages on; NaN where both are NaN.  "follow" is the
    step after a promoting one (fp32 values, bf16 moments read as fp32,
    the decay constants rounded to bf16: the fp32 instance); a promoting
    step over fp16 leaves raises by name on both.  The leaves are
    ``SHAPES`` and ``chip_smoke.EDGE_SHAPES`` (most lengths not multiples
    of 8: the ragged tails), every one holding special values
    (``chip_smoke.with_specials``: +-0, subnormals, +-Inf, NaN), and the
    last leaf of every array starts 8 bytes into its buffer
    (``chip_smoke.misaligned``)."""
    _need_cuda()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import EDGE_SHAPES, misaligned, with_specials
    from incubator_mxnet_tpu_torch.optimizer import fused
    from incubator_mxnet_tpu_torch.parallel import optim as fopt
    if mode in ("promote", "follow") and rule not in fused.PROMOTING:
        pytest.skip("no promoting step: the rule keeps a cast net's dtype "
                    "in the train step")
    dt = DTYPES[dtype]
    sdt = torch.float32 if mode == "master" else dt
    shapes = SHAPES + [s for s in EDGE_SHAPES if s not in SHAPES]

    def edge_leaves(seed, of, scale, positive=False):
        return with_specials(_leaves(seed, shapes, of, scale, positive),
                             seed)
    w0 = edge_leaves(1, torch.float32, 0.02)
    g = edge_leaves(2, dt, 1e-3)
    st0 = {"sgd": [], "adam": [edge_leaves(3, sdt, 1e-4),
                               edge_leaves(4, sdt, 1e-3, True)],
           "adamw": [edge_leaves(3, sdt, 1e-4),
                     edge_leaves(4, sdt, 1e-3, True)],
           "rmsprop": [edge_leaves(4, sdt, 1e-3, True)],
           "adagrad": [edge_leaves(4, sdt, 1e-3, True)]}.get(
               rule, [edge_leaves(3, sdt, 1e-4)])
    hp = torch.tensor([1e-3, 0.271, 0.00299], device="cuda")
    lr_t = fopt.bias_corrected_lr(1e-4, 0.9, 0.999, torch.tensor(
        3, dtype=torch.int32, device="cuda"))
    outs = []
    for plain in (False, True):
        w = [x.to(dt) for x in w0]
        masters = [x.clone() for x in w0] if mode == "master" else None
        st = [[x.clone() for x in s] for s in st0]
        kw = dict(promote=mode == "promote", masters=masters)
        gs = [x.clone() for x in g]
        if mode == "follow":
            w, gs = [x.float() for x in w], [x.float() for x in gs]
            st = [[x.float() for x in s] for s in st]
            kw["moments_dtype"] = dt
        for xs in [w, gs] + st + ([masters] if masters else []):
            xs[-1] = misaligned(xs[-1])
        if rule == "adam":
            f = fused._plain_adam_update if plain else fused.adam_update
            args = (w, gs, st[0], st[1], lr_t, 0.9, 0.999, 1e-8, 0.25,
                    0.004, 0.02, None)
        else:
            f = fused._plain_update if plain else fused.multi_tensor_update
            args = (rule, w, gs, st, hp, 0.9, 0.9, 0.999, 0.95, 1e-8, 0.25,
                    0.004, 0.02, None)
        if mode == "promote" and dt == torch.float16:
            with pytest.raises(MXNetError, match="float16 net"):
                f(*args, **kw)
            continue
        new = f(*args, **kw)
        outs.append((new, st, masters))
    torch.cuda.synchronize()
    if not outs:
        return

    def same(x, y):
        return x.dtype == y.dtype and bool(
            ((x == y) | (torch.isnan(x) & torch.isnan(y))).all())
    (nk, sk, mk), (np_, sp, mp) = outs
    assert all(same(x, y) for x, y in zip(nk, np_))
    assert all(same(x, y) for a, b in zip(sk, sp) for x, y in zip(a, b))
    if mode == "master":
        assert all(same(x, y) for x, y in zip(mk, mp))
    want = torch.float32 if mode in ("promote", "follow") else dt
    assert all(x.dtype == want for x in nk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_16bit_all_finite_matches_plain(dtype):
    """The all-finite kernel on 16-bit gradients: 0 on finite leaves, 1
    with a NaN, +Inf or -Inf in a large or an unaligned leaf, as the
    plain loop."""
    _need_cuda()
    from incubator_mxnet_tpu_torch.optimizer import fused
    g = _leaves(6, SHAPES, DTYPES[dtype], 1e-3)
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    assert int(fused.all_finite(g, flag).item()) == 0
    for i, val in ((4, float("nan")), (2, float("inf")), (0, -float("inf"))):
        keep = g[i].view(-1)[-1].item()
        g[i].view(-1)[-1] = val
        assert int(fused.all_finite(g, flag).item()) == 1 == int(
            fused._plain_all_finite(g, torch.zeros(
                1, dtype=torch.int32, device="cuda")).item())
        g[i].view(-1)[-1] = keep
