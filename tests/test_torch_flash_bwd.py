"""The port's attention backward (``incubator_mxnet_tpu_torch/kernels``):
the plain versions of K6 flash_bwd_dq and K7 flash_bwd_dkv, and of K1's
logsumexp output, held to the JAX package's Pallas B2/B3 (and B1 with
lse) in interpret mode and to the XLA oracle (``jax.vjp`` of
``_xla_attention``), fp32 at atol/rtol 1e-5 (the two sides sum in
different orders); the autograd route of the public entry points; and,
on a card, K1-with-lse, K6 and K7 against their plain versions at atol
1e-4, and K6/K7 bit for bit from one launch to the next (``cuda``
marker, skipped without a GPU).

The JAX functions called here are pure: no JAX-package global (telemetry,
health ring, ``mx.random``, mesh context) is read or written."""
import importlib

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError

tfa = importlib.import_module(
    "incubator_mxnet_tpu_torch.kernels.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)
# kernel vs plain on the card: both fp32, different summation order
CUDA_TOL = dict(atol=1e-4, rtol=1e-4)
H, D = 2, 16


def _jax():
    """The JAX kernel module, ``jax`` and ``jax.numpy``, imported where a
    test needs them, so that the card tests collect without JAX."""
    import jax
    import jax.numpy as jnp
    return (importlib.import_module(
        "incubator_mxnet_tpu.kernels.flash_attention"), jax, jnp)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, B, T, masked=False, all_masked_batch=None, d=D, h=H,
            qk_mag=1.0):
    """q, k, v, dO (B*H, T, D), a (B, 1, T) key bias or None, and the
    scale; q and k are scaled by ``qk_mag``.  Key 0 stays valid, so every
    row keeps a key, except the rows of the batch element
    ``all_masked_batch`` (every key masked)."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B * h, T, d).astype(np.float32)
                  for _ in range(4))
    q, k = q * np.float32(qk_mag), k * np.float32(qk_mag)
    bias = None
    if masked or all_masked_batch is not None:
        m = (rng.rand(B, T) > 0.3).astype(np.float32)
        m[:, 0] = 1.0
        if all_masked_batch is not None:
            m[all_masked_batch] = 0.0
        bias = np.where(m > 0, 0.0, -1e30).astype(np.float32).reshape(B, 1, T)
    return q, k, v, g, bias, 1.0 / np.sqrt(d)


def _port_bwd(q, k, v, g, bias, scale, causal, h=H):
    """The port's plain forward with lse, then its plain backward."""
    tb = None if bias is None else _t(bias)
    tq, tk, tv, tg = (_t(x) for x in (q, k, v, g))
    out, lse = tfa._plain_attention_lse(tq, tk, tv, scale, causal,
                                        tfa._per_head(tb, h))
    dq, dk, dv, dbs = tfa._plain_flash_bwd_dd(tq, tk, tv, tb, tg, lse,
                                              tfa._bwd_dd(out, tg), scale,
                                              causal, h)
    return out, lse, (dq, dk, dv, None if tb is None else tfa._dbias(dbs, h))


def _pallas_bwd(q, k, v, g, bias, scale, causal):
    """JAX's B1 with lse then B2/B3, all Pallas in interpret mode (under
    ``jax.jit``, which only saves the op-by-op dispatch)."""
    jfa, jax, jnp = _jax()

    def run(a, b, c, dout, bb):
        out, lse = jfa._flash_fwd_impl(a, b, c, bb, scale, causal, True, H,
                                       with_lse=True)
        return out, lse, jfa._flash_bwd_impl(a, b, c, bb, out, lse, dout,
                                             scale, causal, True, H)
    return jax.jit(run)(*(None if x is None else jnp.asarray(x)
                          for x in (q, k, v, g, bias)))


def _xla_bwd(q, k, v, g, bias, scale, causal):
    """The oracle: ``jax.vjp`` of ``_xla_attention``, the (B, 1, T) bias
    broadcast over the heads (``_flash_bwd`` under MXNET_FLASH_BWD=xla)."""
    jfa, jax, jnp = _jax()
    BH = q.shape[0]

    def ref(a, b, c, bb):
        if bb is not None:
            bb = jnp.broadcast_to(bb[:, None], (bb.shape[0], H)
                                  + bb.shape[1:]).reshape((BH,)
                                                          + bb.shape[1:])
        return jfa._xla_attention(a, b, c, scale, causal, bias=bb)

    def run(a, b, c, dout, bb):
        if bb is None:
            _, vjp = jax.vjp(lambda x, y, z: ref(x, y, z, None), a, b, c)
            return vjp(dout) + (None,)
        _, vjp = jax.vjp(ref, a, b, c, bb)
        return vjp(dout)
    return jax.jit(run)(*(None if x is None else jnp.asarray(x)
                          for x in (q, k, v, g, bias)))


def _close(got, want, **tol):
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **(tol or TOL))


# ------------------------------------------------------- plain vs JAX
@pytest.mark.parametrize("T,causal,masked", [
    (128, False, False), (128, True, True),     # the tile size
    (100, False, True), (100, True, False),     # a ragged T
])
def test_plain_bwd_matches_pallas_interpret_and_xla_oracle(T, causal,
                                                           masked):
    """dq, dk, dv and the key-bias cotangent, at the tile size and at a
    ragged T, causal and not, with and without a key mask (each value of
    each factor twice), from the port's own forward (out and lse, also
    held to the Pallas forward)."""
    q, k, v, g, bias, scale = _inputs(T + causal + 2 * masked, 2, T, masked)
    out, lse, got = _port_bwd(q, k, v, g, bias, scale, causal)
    pout, plse, pallas = _pallas_bwd(q, k, v, g, bias, scale, causal)
    _close(out, pout)
    _close(lse, plse)
    for a, b in zip(got, pallas):
        _close(a, b)
    for a, b in zip(got, _xla_bwd(q, k, v, g, bias, scale, causal)):
        _close(a, b)


def test_plain_bwd_fully_masked_batch_row():
    """A batch element whose every key is masked: the forward averages the
    values, as K1 and the Pallas forward do, and the backward is finite
    and equal to the Pallas backward.  There the fp32 lse is -1e30
    itself, so both recompute P = 1 per key where the XLA oracle's
    softmax gives 1 / T: on that element the port (like B2/B3) is T times
    the oracle, at atol/rtol 1e-4 (values reach ~100); on the other
    element it is the oracle."""
    T = 64
    q, k, v, g, bias, scale = _inputs(7, 2, T, all_masked_batch=1)
    out, lse, got = _port_bwd(q, k, v, g, bias, scale, False)
    pout, _, pallas = _pallas_bwd(q, k, v, g, bias, scale, False)
    xla = _xla_bwd(q, k, v, g, bias, scale, False)
    _close(out, pout)
    np.testing.assert_allclose(out[H:].numpy(),
                               np.broadcast_to(v[H:].mean(1, keepdims=True),
                                               (H, T, D)), **TOL)
    for a, b in zip(got, pallas):
        assert torch.isfinite(a).all()
        _close(a, b)
    for i, (a, b) in enumerate(zip(got, xla)):
        b = np.asarray(b)
        ok, masked = (0, 1) if i == 3 else (slice(0, H), slice(H, None))
        np.testing.assert_allclose(a[ok].numpy(), b[ok], **TOL)
        np.testing.assert_allclose(a[masked].numpy(), T * b[masked],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("T,causal", [(128, False), (100, True)])
def test_flash_attention_lse_and_its_gradient_match_pallas(T, causal):
    """The public ``flash_attention_lse`` against ``_flash_lse`` (B1 with
    lse forward, B2/B3 backward with the lse cotangent folded into dd),
    both in interpret mode: out, lse, and the gradients of sum(out * dO)
    + sum(lse * g_lse)."""
    jfa, jax, jnp = _jax()
    B = 2
    q, k, v, g, bias, scale = _inputs(11 + T, B, T, masked=True)
    g_lse = np.random.RandomState(12).randn(B * H, T).astype(np.float32)
    mask = (bias.reshape(B, T) == 0).astype(np.float32)
    def run(a, b, c, dout, dlse, bb):
        outs, vjp = jax.vjp(lambda x, y, z: jfa._flash_lse(
            x, y, z, bb, scale, causal, True, H), a, b, c)
        return outs, vjp((dout, dlse))
    (jout, jlse), want = jax.jit(run)(
        *(jnp.asarray(x) for x in (q, k, v, g, g_lse, bias)))
    tq, tk, tv = (_t(x.reshape(B, H, T, D)).requires_grad_()
                  for x in (q, k, v))
    tfa.reset_launch_counts()
    out, lse = tfa.flash_attention_lse(tq, tk, tv, scale=scale,
                                       causal=causal, mask=_t(mask))
    assert out.shape == (B, H, T, D) and lse.shape == (B, H, T)
    got = torch.autograd.grad((out, lse), (tq, tk, tv),
                              (_t(g.reshape(B, H, T, D)),
                               _t(g_lse.reshape(B, H, T))))
    _close(out.reshape(B * H, T, D), jout)
    _close(lse.reshape(B * H, T), jlse)
    for a, b in zip(got, want):
        _close(a.reshape(B * H, T, D), b)
    assert sum(tfa.launch_counts.values()) == 0   # plain runs never count


def test_autograd_route_and_bias_cotangent():
    """With a gradient to record, ``flash_attention`` on CPU tensors runs
    the autograd Function over the plain versions: its gradients equal
    autograd through the plain forward, and a bias that needs a gradient
    gets ``_flash_bwd_impl``'s (B, 1, T) cotangent."""
    B, T = 2, 48
    q, k, v, g, bias, scale = _inputs(13, B, T, masked=True)
    mask = _t((bias.reshape(B, T) == 0).astype(np.float32))
    xs = [_t(x.reshape(B, H, T, D)).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*xs, causal=True, mask=mask)
    # a view of the Function's output
    assert "_FlashAttentionBackward" in {
        type(f).__name__ for f, _ in out.grad_fn.next_functions if f}
    got = torch.autograd.grad(out, xs, _t(g.reshape(B, H, T, D)))
    ref = tfa._plain_flash_attention(*xs, scale, True, mask)
    want = torch.autograd.grad(ref, xs, _t(g.reshape(B, H, T, D)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)

    tb = _t(bias).requires_grad_()
    flat = [_t(x) for x in (q, k, v)]
    o, _ = tfa._FlashAttention.apply(*flat, tb, scale, False, H)
    (db,) = torch.autograd.grad(o, tb, _t(g))
    _close(db, _pallas_bwd(q, k, v, g, bias, scale, False)[2][3])
    o, _ = tfa._FlashAttention.apply(*[x.requires_grad_() for x in flat],
                                     _t(bias), scale, False, H)
    assert len(torch.autograd.grad(o.sum(), flat)) == 3


def test_no_grad_keeps_the_forward_only_route():
    """Without a gradient to record the entry is the plain forward (on the
    card: K1 without lse), so serving never pays for the lse."""
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with torch.no_grad():
        out = tfa.flash_attention(q, q, q, causal=True)
    assert out.grad_fn is None
    np.testing.assert_array_equal(
        out.numpy(), tfa._plain_flash_attention(q, q, q, 0.25, True)
        .detach().numpy())


def test_flash_bwd_xla_switch_is_refused(monkeypatch):
    """``MXNET_FLASH_BWD=xla`` is no longer refused: it selects the
    recompute oracle (autograd through the plain attention), whose
    gradients equal the JAX oracle (``jax.vjp`` of ``_xla_attention``,
    what the reference's switch runs) and the default backward within
    ``TOL``, with a key mask, causal."""
    B, T = 2, 40
    q, k, v, g, bias, scale = _inputs(21, B, T, masked=True)
    mask = _t((bias.reshape(B, T) == 0).astype(np.float32))
    dout = _t(g.reshape(B, H, T, D))

    def grads():
        xs = [_t(x.reshape(B, H, T, D)).requires_grad_() for x in (q, k, v)]
        out = tfa.flash_attention(*xs, scale=scale, causal=True, mask=mask)
        return torch.autograd.grad(out, xs, dout)

    default = grads()
    monkeypatch.setenv("MXNET_FLASH_BWD", "xla")
    got = grads()
    want = _xla_bwd(q, k, v, g, bias, scale, True)
    for a, b, c in zip(got, want, default):
        _close(a.reshape(B * H, T, D), b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), **TOL)


def test_flash_bwd_xla_switch_covers_the_lse_entry(monkeypatch):
    """The same switch for ``flash_attention_lse``: the gradients of
    sum(out * dO) + sum(lse * g_lse) through the recompute oracle equal
    the JAX ``_flash_lse`` under ``MXNET_FLASH_BWD=xla`` (its recompute
    oracle; the forward is Pallas in interpret mode) within ``TOL``, and
    a key bias that needs a gradient gets the oracle's (B, 1, T)
    cotangent."""
    jfa, jax, jnp = _jax()
    B, T = 2, 48
    q, k, v, g, bias, scale = _inputs(23, B, T, masked=True)
    g_lse = np.random.RandomState(24).randn(B * H, T).astype(np.float32)
    monkeypatch.setenv("MXNET_FLASH_BWD", "xla")

    def run(a, b, c, bb, dout, dlse):
        _, vjp = jax.vjp(lambda x, y, z, w: jfa._flash_lse(
            x, y, z, w, scale, False, True, H), a, b, c, bb)
        return vjp((dout, dlse))
    want = jax.jit(run)(*(jnp.asarray(x)
                          for x in (q, k, v, bias, g, g_lse)))
    flat = [_t(x).requires_grad_() for x in (q, k, v, bias)]
    out, lse = tfa._FlashAttention.apply(*flat, scale, False, H)
    got = torch.autograd.grad((out, lse), flat, (_t(g), _t(g_lse)))
    for a, b in zip(got, want):
        _close(a, b)


def test_bwd_wrapper_refuses_cpu_tensors():
    q, k, v, g, _, scale = _inputs(14, 1, 8)
    x = [_t(a) for a in (q, k, v, g)]
    lse = torch.zeros(2, 8)
    with pytest.raises(MXNetError, match="CUDA"):
        tfa._flash_bwd_cuda(*x[:3], None, x[3], lse, lse, scale, False, H)
    with pytest.raises(MXNetError, match="CUDA"):
        tfa._flash_fwd_cuda(*x[:3], None, scale, False, H, with_lse=True)


# ------------------------------------------------ on the card (cuda mark)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,T,d,causal,masked,all_masked,qk_mag", [
    (4, 16, 128, 64, False, False, None, 1.0),  # BERT-large's attention
    (2, 4, 512, 64, False, True, None, 1.0),    # ragged key mask, T = 512
    (2, 3, 100, 32, True, True, 1, 1.0),        # causal, ragged, masked row
    (1, 2, 70, 16, False, True, 0, 1.0),
    (1, 2, 200, 128, True, False, None, 1.0),
    (1, 2, 1, 64, False, False, None, 1.0),     # one query, one key
    (1, 2, 63, 64, False, True, None, 1.0),     # a tile less one row
    (1, 2, 65, 32, False, True, None, 1.0),     # a tile and one row
    (1, 2, 129, 64, True, True, None, 1.0),     # causal, two tiles and one
    (2, 2, 130, 128, False, True, 1, 1.0),      # D = 128, a masked row
    # scores 16x larger: P is near one-hot, and dropping the low parts of
    # the 3xTF32 split misses CUDA_TOL by a factor of 200 or more here
    (2, 4, 128, 64, False, False, None, 4.0),
])
def test_cuda_flash_bwd_matches_plain(B, h, T, d, causal, masked,
                                      all_masked, qk_mag):
    """K1 with lse, K6 and K7 against the plain versions, each launched
    once."""
    _need_cuda()
    q, k, v, g, bias, scale = _inputs(20 + T, B, T, masked, all_masked, d=d,
                                      h=h, qk_mag=qk_mag)
    cpu = [_t(a) for a in (q, k, v, g)]
    cu = [a.cuda() for a in cpu]
    tb = None if bias is None else _t(bias)
    cb = None if tb is None else tb.cuda()
    tfa.reset_launch_counts()
    out, lse = tfa._flash_fwd_cuda(*cu[:3], cb, scale, causal, h,
                                   with_lse=True)
    dd = tfa._bwd_dd(out, cu[3])
    got = tfa._flash_bwd_cuda(*cu[:3], cb, cu[3], lse, dd, scale, causal, h)
    torch.cuda.synchronize()
    assert (tfa.launch_counts["flash_fwd"], tfa.launch_counts["flash_bwd_dq"],
            tfa.launch_counts["flash_bwd_dkv"]) == (1, 1, 1)
    pout, plse = tfa._plain_attention_lse(*cpu[:3], scale, causal,
                                          tfa._per_head(tb, h))
    want = tfa._plain_flash_bwd_dd(*cpu[:3], tb, cpu[3], plse,
                                   tfa._bwd_dd(pout, cpu[3]), scale, causal,
                                   h)
    for a, b in zip((out, lse) + tuple(got), (pout, plse) + tuple(want)):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), **CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_flash_bwd_is_deterministic(causal):
    """Two launches of K6 and K7 on the same inputs give the same dq, dk,
    dv and dbs bit for bit: each output element is summed by one thread in
    a fixed order (no atomics)."""
    _need_cuda()
    q, k, v, g, bias, scale = _inputs(40, 2, 200, masked=True, d=64, h=4)
    q, k, v, g, bias = (_t(a).cuda() for a in (q, k, v, g, bias))
    out, lse = tfa._flash_fwd_cuda(q, k, v, bias, scale, causal, 4,
                                   with_lse=True)
    dd = tfa._bwd_dd(out, g)
    first, second = (tfa._flash_bwd_cuda(q, k, v, bias, g, lse, dd, scale,
                                         causal, 4) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_autograd_route_launches_k1_k6_k7():
    _need_cuda()
    B, h, T, d = 2, 4, 96, 64
    q, k, v, g, bias, scale = _inputs(30, B, T, masked=True, d=d, h=h)
    mask = (bias.reshape(B, T) == 0).astype(np.float32)
    xs = [_t(a.reshape(B, h, T, d)).cuda().requires_grad_()
          for a in (q, k, v)]
    tfa.reset_launch_counts()
    out = tfa.flash_attention(*xs, mask=_t(mask).cuda())
    got = torch.autograd.grad(out, xs, _t(g.reshape(B, h, T, d)).cuda())
    torch.cuda.synchronize()
    assert (tfa.launch_counts["flash_fwd"], tfa.launch_counts["flash_bwd_dq"],
            tfa.launch_counts["flash_bwd_dkv"]) == (1, 1, 1)
    cx = [x.detach().cpu().requires_grad_() for x in xs]
    ref = tfa.flash_attention(*cx, mask=_t(mask))
    want = torch.autograd.grad(ref, cx, _t(g.reshape(B, h, T, d)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), **CUDA_TOL)
