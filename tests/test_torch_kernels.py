"""The port's attention kernels (``incubator_mxnet_tpu_torch/kernels``):
the plain PyTorch versions of K1 flash_fwd, K2 paged_decode and K3 decode
held to the JAX package's lax oracles and to its Pallas kernels in
interpret mode, fp32 at atol/rtol 1e-5 (the two sides sum in different
orders); a host model of the split-then-merge that K2 to K5 share; the
wrappers' input checks; the build table (``_build.py``) against the
sources it builds; and, on a card, each CUDA kernel against its plain
version (``cuda`` marker, skipped without a GPU)."""
import ctypes
import importlib
import re

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.kernels import _build

# the module, not the same-named function its package exports
tfa = importlib.import_module(
    "incubator_mxnet_tpu_torch.kernels.flash_attention")


def _jax():
    """The JAX package's kernel module and ``jax.numpy``, imported where a
    test needs them, so that the card tests (``-m cuda``) collect on a
    machine without JAX."""
    import jax.numpy as jnp
    return (importlib.import_module(
        "incubator_mxnet_tpu.kernels.flash_attention"), jnp)

TOL = dict(atol=1e-5, rtol=1e-5)
# kernel vs plain on the card: both fp32, different summation order
CUDA_TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mask(rng, B, T, all_masked_row=None):
    """(B, T) 0/1 key-validity mask; key 0 stays valid so every causal
    row keeps a key, except in the row named ``all_masked_row``."""
    m = (rng.rand(B, T) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    if all_masked_row is not None:
        m[all_masked_row] = 0.0
    return m


def _bias(mask, H):
    """The JAX dispatcher's encoding: (B, 1, T) and its per-head
    broadcast (B*H, 1, T)."""
    B, T = mask.shape
    b = np.where(mask > 0, 0.0, -1e30).astype(np.float32).reshape(B, 1, T)
    return b, np.broadcast_to(b[:, None], (B, H, 1, T)).reshape(B * H, 1, T)


# ------------------------------------------------------------ K1 plain
@pytest.mark.parametrize("B,H,T,D,causal", [
    (2, 2, 8, 16, True),        # the smallest prefill bucket
    (1, 2, 100, 16, True),      # ragged T (no tile multiple)
    (2, 2, 128, 32, False),
])
def test_flash_plain_matches_xla_oracle(B, H, T, D, causal):
    jfa, jnp = _jax()
    rng = np.random.RandomState(0)
    q, k, v = (_rand(rng, B * H, T, D) for _ in range(3))
    scale = 1.0 / np.sqrt(D)
    want = jfa._xla_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), scale, causal)
    got = tfa._plain_attention(_t(q), _t(k), _t(v), scale, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("T,causal", [(8, True), (100, True), (64, False)])
def test_flash_plain_with_key_bias_matches_xla_oracle(T, causal):
    jfa, jnp = _jax()
    B, H, D = 2, 2, 16
    rng = np.random.RandomState(1)
    q, k, v = (_rand(rng, B * H, T, D) for _ in range(3))
    _, bb = _bias(_mask(rng, B, T), H)
    want = jfa._xla_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), 0.25, causal,
                              bias=jnp.asarray(bb))
    got = tfa._plain_attention(_t(q), _t(k), _t(v), 0.25, causal,
                               _t(bb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_fully_masked_row_is_finite_and_matches_oracle():
    """A batch row whose every key is masked averages the values (the
    -1e30 bias ties every score), as both JAX paths do without causal."""
    jfa, jnp = _jax()
    B, H, T, D = 2, 2, 16, 16
    rng = np.random.RandomState(2)
    q, k, v = (_rand(rng, B * H, T, D) for _ in range(3))
    _, bb = _bias(_mask(rng, B, T, all_masked_row=1), H)
    want = jfa._xla_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), 0.25, False,
                              bias=jnp.asarray(bb))
    got = tfa._plain_attention(_t(q), _t(k), _t(v), 0.25, False, _t(bb))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy()[H:],
                               np.broadcast_to(v[H:].mean(1, keepdims=True),
                                               (H, T, D)), **TOL)


@pytest.mark.parametrize("T,causal,masked_row", [
    (8, True, None), (16, True, 1), (128, False, None), (32, False, 0)])
def test_flash_plain_matches_pallas_interpret(T, causal, masked_row):
    """Against the Pallas kernel itself, run in interpret mode — including
    a causal row with every key masked, where the kernel's ``safe_m``
    keeps it finite over the keys up to the diagonal."""
    jfa, jnp = _jax()
    B, H, D = 2, 2, 16
    rng = np.random.RandomState(3)
    q, k, v = (_rand(rng, B * H, T, D) for _ in range(3))
    b, bb = _bias(_mask(rng, B, T, all_masked_row=masked_row), H)
    want = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(b), 0.25, causal,
                               True, H)
    got = tfa._plain_attention(_t(q), _t(k), _t(v), 0.25, causal, _t(bb))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_cpu_route_and_mask_encoding():
    """The public (B, H, T, D) entry on CPU tensors is the plain version,
    with the (B, T) mask encoded as the JAX dispatcher encodes it."""
    jfa, jnp = _jax()
    B, H, T, D = 2, 2, 24, 16
    rng = np.random.RandomState(4)
    q, k, v = (_rand(rng, B, H, T, D) for _ in range(3))
    mask = _mask(rng, B, T)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True,
                               mask=jnp.asarray(mask))
    tfa.reset_launch_counts()
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tfa.launch_counts["flash_fwd"] == 0    # plain runs never count


# --------------------------------------------------------- K3 / K2 plain
def _decode_inputs(seed, S=3, H=2, T=64, D=16):
    rng = np.random.RandomState(seed)
    return (_rand(rng, S, H, D), _rand(rng, S, H, T, D),
            _rand(rng, S, H, T, D))


@pytest.mark.parametrize("positions", [[0, 31, 63], [5, 0, 17]])
def test_decode_plain_matches_xla_and_pallas(positions):
    """Position 0 and the last position included."""
    jfa, jnp = _jax()
    q, k, v = _decode_inputs(5)
    pos = np.asarray(positions, np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(pos), 0.25)
    got = tfa._plain_decode_attention(_t(q), _t(k), _t(v), _t(pos), 0.25)
    for want in (jfa._xla_decode_attention(*jargs),
                 jfa._decode_pallas(*jargs, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    route = tfa.decode_attention(_t(q), _t(k), _t(v), _t(pos), scale=0.25)
    np.testing.assert_array_equal(route.numpy(), got.numpy())


def _paged_inputs(seed, S=3, H=2, bs=16, D=16, NBLK=12, MB=4,
                  positions=(0, 15, 63)):
    """A shuffled pool; each slot's table holds distinct live blocks up to
    its position and is padded with the null block 0 past it."""
    rng = np.random.RandomState(seed)
    kp, vp = _rand(rng, NBLK, H, bs, D), _rand(rng, NBLK, H, bs, D)
    q = _rand(rng, S, H, D)
    pos = np.asarray(positions, np.int32)
    tables = np.zeros((S, MB), np.int32)
    for s in range(S):
        live = int(pos[s]) // bs + 1
        tables[s, :live] = rng.choice(np.arange(1, NBLK), live,
                                      replace=False)
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("positions", [(0, 15, 63), (16, 47, 1)])
def test_paged_decode_plain_matches_xla_and_pallas(positions):
    """Null-block padding, a block boundary (15/16) and the last position
    (63 = 4 blocks of 16)."""
    jfa, jnp = _jax()
    q, kp, vp, tables, pos = _paged_inputs(6, positions=positions)
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
             jnp.asarray(tables), jnp.asarray(pos), 0.25)
    got = tfa._plain_paged_decode_attention(_t(q), _t(kp), _t(vp),
                                            _t(tables), _t(pos), 0.25)
    for want in (jfa._xla_paged_decode_attention(*jargs),
                 jfa._paged_decode_pallas(*jargs, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    route = tfa.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                       _t(pos), scale=0.25)
    np.testing.assert_array_equal(route.numpy(), got.numpy())


def test_paged_decode_equals_dense_decode_bitwise():
    """The gather reuses the dense plain version, so paged == dense on the
    same live entries, bit for bit (the engine's paged == dense
    contract)."""
    q, kp, vp, tables, pos = _paged_inputs(7)
    S, MB = tables.shape
    _, H, bs, D = kp.shape
    kd = kp[tables].transpose(0, 2, 1, 3, 4).reshape(S, H, MB * bs, D)
    vd = vp[tables].transpose(0, 2, 1, 3, 4).reshape(S, H, MB * bs, D)
    paged = tfa.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                       _t(pos))
    dense = tfa.decode_attention(_t(q), _t(kd), _t(vd), _t(pos))
    np.testing.assert_array_equal(paged.numpy(), dense.numpy())


# -------------------------------------------------------------- wrappers
def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run on CPU tensors (the public entries
    route those to the plain versions instead)."""
    q, k, v = _decode_inputs(8)
    pos = _t(np.zeros(3, np.int32))
    with pytest.raises(MXNetError, match="CUDA"):
        tfa._decode_cuda(_t(q), _t(k), _t(v), pos, 0.25)
    qp, kp, vp, tables, ppos = _paged_inputs(8)
    with pytest.raises(MXNetError, match="CUDA"):
        tfa._paged_decode_cuda(_t(qp), _t(kp), _t(vp), _t(tables),
                               _t(ppos), 0.25)
    x = _t(_rand(np.random.RandomState(8), 4, 8, 16))
    with pytest.raises(MXNetError, match="CUDA"):
        tfa._flash_fwd_cuda(x, x, x, None, 0.25, True, 2)


def test_flash_attention_rejects_mismatched_shapes():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(MXNetError):
        tfa.flash_attention(q, torch.zeros(1, 2, 9, 16), q)


# ------------------------------------------------------ build table
def test_every_header_feeds_the_build_digest():
    """A header missing from ``_build.HEADERS`` would leave a stale
    library in ``build/kernels`` after an edit of that header."""
    found = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert found == sorted(_build.HEADERS)


def test_every_include_names_a_file_in_csrc():
    for src in _build.CSRC.iterdir():
        for name in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (_build.CSRC / name).is_file(), (src.name, name)


_C_ARG = {"int": ctypes.c_int, "float": ctypes.c_float}


_SOURCE = {entry: src for name, src in _build.KERNELS.items()
           for entry in _build.ENTRIES[name]}


@pytest.mark.parametrize("name", sorted(_build.ARGTYPES))
def test_argtypes_match_the_extern_c_definition(name):
    """``ARGTYPES[name]`` lists the arguments of the ``extern "C"``
    definition of ``mx_<name>`` in its library's source, in order:
    ``int`` and ``float`` as themselves, every pointer as
    ``c_void_p``."""
    src = (_build.CSRC / _SOURCE[name]).read_text()
    m = re.search(r'extern "C" int mx_%s\(([^)]*)\)\s*\{' % name, src)
    assert m, f"no extern \"C\" definition of mx_{name}"
    want = [ctypes.c_void_p if "*" in arg
            else _C_ARG[arg.split()[0]]
            for arg in (a.strip() for a in m.group(1).split(","))]
    assert _build.ARGTYPES[name] == want


# ------------------------------------------------ on the card (cuda mark)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("T,causal,masked_row", [
    (8, True, None), (100, True, 1), (1024, True, None), (100, False, 0)])
def test_cuda_flash_fwd_matches_plain(T, causal, masked_row):
    _need_cuda()
    B, H, D = 2, 12, 64
    rng = np.random.RandomState(10)
    q, k, v = (_t(_rand(rng, B, H, T, D)).cuda() for _ in range(3))
    mask = _t(_mask(rng, B, T, all_masked_row=masked_row)).cuda()
    tfa.reset_launch_counts()
    got = tfa.flash_attention(q, k, v, causal=causal, mask=mask)
    torch.cuda.synchronize()
    assert tfa.launch_counts["flash_fwd"] == 1
    want = tfa.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal,
                               mask=mask.cpu())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               **CUDA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_cuda_decode_kernels_match_plain(D):
    _need_cuda()
    q, kp, vp, tables, pos = _paged_inputs(
        11, S=8, H=12, D=D, NBLK=160, MB=64,
        positions=(0, 15, 16, 500, 1023, 1, 77, 256))
    tfa.reset_launch_counts()
    cu = [_t(a).cuda() for a in (q, kp, vp, tables, pos)]
    got = tfa.paged_decode_attention(*cu)
    torch.cuda.synchronize()
    want = tfa.paged_decode_attention(*(_t(a) for a in (q, kp, vp, tables,
                                                        pos)))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **CUDA_TOL)
    S, MB = tables.shape
    _, H, bs, _ = kp.shape
    kd = kp[tables].transpose(0, 2, 1, 3, 4).reshape(S, H, MB * bs, D)
    vd = vp[tables].transpose(0, 2, 1, 3, 4).reshape(S, H, MB * bs, D)
    dense = tfa.decode_attention(_t(q).cuda(), _t(kd).cuda(),
                                 _t(vd).cuda(), _t(pos).cuda())
    torch.cuda.synchronize()
    # one loop over two address computations: bitwise equal on the card
    np.testing.assert_array_equal(dense.cpu().numpy(), got.cpu().numpy())
    # two launches per call: the split and the merge
    assert tfa.launch_counts == {"flash_fwd": 0, "paged_decode": 2,
                                 "decode": 2, "paged_verify": 0,
                                 "verify": 0, "flash_bwd_dq": 0,
                                 "flash_bwd_dkv": 0, "multi_tensor_adam": 0,
                                 "all_finite": 0, "multi_tensor_update": 0,
                                 "multi_tensor_lamb": 0}


# ------------------------------------- K2/K3 split geometry (host helpers)
@pytest.mark.parametrize("length,splits", [
    (1, 1), (63, 1), (64, 1), (65, 2), (1000, 16), (1024, 16), (1064, 17)])
def test_decode_splits_fixed_by_shape(length, splits):
    """K2/K3 split a cache of L keys into ceil(L / 64) chunks, from the
    shape alone (the grid a CUDA graph would capture)."""
    assert tfa._DECODE_CHUNK == 64
    assert tfa._decode_scratch_shape(8, 12, length, 64)[2] == splits


def test_decode_scratch_shape():
    """One (acc[D], m, l) partial per (slot, head, chunk), fp32."""
    assert tfa._decode_scratch_shape(8, 12, 1024, 64) == (8, 12, 16, 66)
    assert tfa._decode_scratch_shape(3, 2, 65, 16) == (3, 2, 2, 18)


def _split_merge(q, k, v, positions, scale, chunk):
    """A host model of the K2-K5 design: q (S, H, Q, D), row j's head h_j =
    min(positions[s] + j, T - 1).  Each fixed chunk of keys up to the last
    row's head is read once and gives every row whose head reaches it a
    partial (acc, m, l) over its keys <= h_j; row j merges the partials of
    chunks 0..h_j // chunk in chunk order with weights exp(m_c - max m)."""
    S, H, Q, D = q.shape
    T = k.shape[2]
    out = torch.zeros(S, H, Q, D)
    for s in range(S):
        heads = [min(int(positions[s]) + j, T - 1) for j in range(Q)]
        parts = [[] for _ in range(Q)]
        for t0 in range(0, heads[-1] + 1, chunk):
            kc, vc = k[s, :, t0:t0 + chunk], v[s, :, t0:t0 + chunk]
            for j in range(Q):
                if heads[j] < t0:
                    continue
                n = min(t0 + chunk, heads[j] + 1) - t0
                sc = torch.einsum("hd,htd->ht", q[s, :, j], kc[:, :n]) * scale
                m = sc.amax(-1)
                p = torch.exp(sc - m[:, None])
                parts[j].append((torch.einsum("ht,htd->hd", p, vc[:, :n]), m,
                                 p.sum(-1)))
        for j in range(Q):
            assert len(parts[j]) == heads[j] // chunk + 1
            big = torch.stack([m for _, m, _ in parts[j]]).amax(0)
            num = sum(a * torch.exp(m - big)[:, None] for a, m, _ in parts[j])
            den = sum(l * torch.exp(m - big) for _, m, l in parts[j])
            out[s, :, j] = num / den[:, None]
    return out


@pytest.mark.parametrize("positions", [
    (0, 63, 64, 65, 199), (199, 199, 199, 199, 199), (1, 127, 128, 129, 5)])
def test_decode_split_merge_equals_plain(positions):
    """The split-then-merge arithmetic equals the plain decode at the
    chunk edges (0, C - 1, C, C + 1) and at the cache's last position."""
    rng = np.random.RandomState(12)
    S, H, T, D = len(positions), 2, 200, 16
    q, k, v = (_t(_rand(rng, *sh)) for sh in
               ((S, H, D), (S, H, T, D), (S, H, T, D)))
    pos = _t(np.asarray(positions, np.int32))
    got = _split_merge(q[:, :, None], k, v, pos, 0.25, tfa._DECODE_CHUNK)
    want = tfa._plain_decode_attention(q, k, v, pos, 0.25)
    np.testing.assert_allclose(got[:, :, 0].numpy(), want.numpy(), **TOL)


# ------------------------------------- K4/K5 split geometry (host helpers)
@pytest.mark.parametrize("Q", [1, 2, 5, 9])
@pytest.mark.parametrize("positions", [
    (60, 61, 62, 63, 64, 65),           # heads straddling 63/64/65
    (0, 1, 127, 128, 30, 100),          # position 0 and the next edge
    (195, 197, 199, 199, 59, 120)])     # rows past T - 1 clamp at its end
def test_verify_split_merge_equals_plain(positions, Q):
    """K4/K5's split-then-merge (one read of each chunk for every row,
    row j masked at its own head) equals the plain verify: rows whose
    heads straddle a chunk edge, a slot at position 0, and rows past the
    cache's end clamped at T - 1."""
    rng = np.random.RandomState(16)
    S, H, T, D = len(positions), 2, 200, 16
    q, k, v = (_t(_rand(rng, *sh)) for sh in
               ((S, H, Q, D), (S, H, T, D), (S, H, T, D)))
    pos = _t(np.asarray(positions, np.int32))
    got = _split_merge(q, k, v, pos, 0.25, tfa._DECODE_CHUNK)
    want = tfa._plain_verify_decode_attention(q, k, v, pos, 0.25)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("Q", [1, 5, 9])
@pytest.mark.parametrize("length,splits", [
    (1, 1), (63, 1), (64, 1), (65, 2), (1000, 16), (1024, 16), (1064, 17)])
def test_verify_splits_fixed_by_shape(length, splits, Q):
    """K4/K5 split a cache of L keys into ceil(L / 64) chunks, from the
    shape alone and whatever the number of query rows."""
    assert tfa._verify_scratch_shape(8, 12, Q, length, 64)[3] == splits


def test_verify_scratch_shape():
    """One (acc[D], m, l) partial per (slot, head, row, chunk), fp32; a
    split count past the grid raises before anything is allocated."""
    assert tfa._verify_scratch_shape(8, 12, 5, 1024, 64) == (8, 12, 5, 16, 66)
    assert tfa._verify_scratch_shape(3, 2, 9, 65, 16) == (3, 2, 9, 2, 18)
    with pytest.raises(MXNetError, match="split grid"):
        tfa._split_scratch("verify", torch.zeros(1), (1, 1, 1, 65536, 18))


# ------------------------------- the redesigned kernels' edges, on the card
@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 1000])
def test_cuda_flash_fwd_edges(T, D, causal):
    """K1 (3xTF32 on the tensor cores) against its plain version at the
    tile edges, every D, causal and dense: no bias; a key bias with masked
    keys and a fully masked batch row; with and without the lse output."""
    _need_cuda()
    B, H = 2, 3
    BH = B * H
    scale = 1.0 / np.sqrt(D)
    rng = np.random.RandomState(13)
    q, k, v = (_t(_rand(rng, BH, T, D)).cuda() for _ in range(3))
    b, bb = _bias(_mask(rng, B, T, all_masked_row=1), H)
    for bias, per_head in ((None, None),
                           (_t(b).cuda(), _t(np.ascontiguousarray(bb)))):
        want, want_lse = tfa._plain_attention_lse(
            q.cpu(), k.cpu(), v.cpu(), scale, causal, per_head)
        tfa.reset_launch_counts()
        got = tfa._flash_fwd_cuda(q, k, v, bias, scale, causal, H)
        out, lse = tfa._flash_fwd_cuda(q, k, v, bias, scale, causal, H,
                                       with_lse=True)
        torch.cuda.synchronize()
        assert tfa.launch_counts["flash_fwd"] == 2
        for o in (got, out):
            assert torch.isfinite(o).all()
            np.testing.assert_allclose(o.cpu().numpy(), want.numpy(),
                                       **CUDA_TOL)
        # the plain lse of a fully masked row is -1e30 itself, as K1's
        np.testing.assert_allclose(lse.cpu().numpy(), want_lse.numpy(),
                                   **CUDA_TOL)


def _paged_pool(rng, S, H, bs, D, MB, positions, rows=1):
    """A shuffled pool of 1 + S * MB blocks (block 0 the null block) whose
    tables hold distinct blocks up to each slot's position plus ``rows -
    1`` (a verify's last row)."""
    NB = 1 + S * MB
    kp, vp = _rand(rng, NB, H, bs, D), _rand(rng, NB, H, bs, D)
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    tables = np.zeros((S, MB), np.int32)
    used = 0
    for s, p in enumerate(positions):
        live = min(MB, (p + rows - 1) // bs + 1)
        tables[s, :live] = perm[used:used + live]
        used += live
    return kp, vp, tables


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edges", "full", "short"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_cuda_decode_split_edges(bs, D, case):
    """K2 and K3 (split over 64-key chunks, then merged) against their
    plain versions with positions at 0, C - 1, C, C + 1 and max_len - 1
    (``edges``), every slot at max_len - 1 (``full``), or a short cache
    (``short``); and K2 == K3 bit for bit where the dense cache is the
    paged one viewed densely, with a dense T other than MB * bs: longer
    (stale rows past max_len) or cut after the last live key."""
    _need_cuda()
    H, max_len = 4, 1024
    MB = max_len // bs
    positions = {"edges": (0, 63, 64, 65, max_len - 1, 1, 500, 127),
                 "full": (max_len - 1,) * 8,
                 "short": (0, 63, 64, 65, 700, 3, 130, 200)}[case]
    S = len(positions)
    rng = np.random.RandomState(14)
    kp, vp, tables = _paged_pool(rng, S, H, bs, D, MB, positions)
    q = _rand(rng, S, H, D)
    pos = np.asarray(positions, np.int32)
    cu = [_t(a).cuda() for a in (q, kp, vp, tables, pos)]
    tfa.reset_launch_counts()
    got = tfa.paged_decode_attention(*cu)
    torch.cuda.synchronize()
    want = tfa.paged_decode_attention(*(_t(a) for a in (q, kp, vp, tables,
                                                        pos)))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **CUDA_TOL)
    kd = kp[tables].transpose(0, 2, 1, 3, 4).reshape(S, H, max_len, D)
    vd = vp[tables].transpose(0, 2, 1, 3, 4).reshape(S, H, max_len, D)
    if case == "short":
        T = max(positions) + 1
        kd, vd = kd[:, :, :T], vd[:, :, :T]
    else:
        stale = _rand(rng, S, H, 40, D)
        kd = np.concatenate([kd, stale], axis=2)
        vd = np.concatenate([vd, -stale], axis=2)
    dense = tfa.decode_attention(_t(q).cuda(), _t(kd).cuda(), _t(vd).cuda(),
                                 cu[4])
    torch.cuda.synchronize()
    np.testing.assert_array_equal(dense.cpu().numpy(), got.cpu().numpy())
    np.testing.assert_allclose(
        dense.cpu().numpy(),
        tfa.decode_attention(_t(q), _t(kd), _t(vd), _t(pos)).numpy(),
        **CUDA_TOL)
    assert (tfa.launch_counts["paged_decode"],
            tfa.launch_counts["decode"]) == (2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edges", "full", "short"])
@pytest.mark.parametrize("Q", [1, 2, 5, 9])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_cuda_verify_split_edges(bs, D, Q, case):
    """K4 and K5 (split over 64-key chunks with every query row per chunk,
    then merged) against their plain versions with positions at 0, C - 1,
    C, C + 1, 60 (rows straddling C) and max_len - 1 (rows clamped at the
    cache's end) (``edges``), every slot at max_len - 1 (``full``), or a
    short cache (``short``).  K4 == K5 bit for bit where the dense cache
    is the paged one viewed densely: longer (stale rows past max_len; the
    rows whose head stays inside max_len) or cut after the last live key
    (every row).  Row j equals K2 at positions[s] + j bit for bit.  Two
    launch-counter ticks per call: the split and the merge."""
    _need_cuda()
    H, max_len = 4, 1024
    MB = max_len // bs
    positions = {"edges": (0, 63, 64, 65, max_len - 1, 60, 500, 127),
                 "full": (max_len - 1,) * 8,
                 "short": (0, 63, 64, 65, 700, 60, 130, 200)}[case]
    S = len(positions)
    rng = np.random.RandomState(17)
    kp, vp, tables = _paged_pool(rng, S, H, bs, D, MB, positions, rows=Q)
    q = _rand(rng, S, H, Q, D)
    pos = np.asarray(positions, np.int32)
    cu = [_t(a).cuda() for a in (q, kp, vp, tables, pos)]
    tfa.reset_launch_counts()
    got = tfa.paged_verify_decode_attention(*cu)
    torch.cuda.synchronize()
    assert tfa.launch_counts["paged_verify"] == 2
    want = tfa.paged_verify_decode_attention(*(_t(a) for a in (q, kp, vp,
                                                               tables, pos)))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **CUDA_TOL)

    rows = pos[:, None] + np.arange(Q)[None, :]            # (S, Q) positions
    kd = kp[tables].transpose(0, 2, 1, 3, 4).reshape(S, H, max_len, D)
    vd = vp[tables].transpose(0, 2, 1, 3, 4).reshape(S, H, max_len, D)
    if case == "short":
        T = int(np.minimum(rows, max_len - 1).max()) + 1
        kd, vd = kd[:, :, :T], vd[:, :, :T]
        inside = np.ones_like(rows, dtype=bool)
    else:
        stale = _rand(rng, S, H, 40, D)
        kd = np.concatenate([kd, stale], axis=2)
        vd = np.concatenate([vd, -stale], axis=2)
        inside = rows <= max_len - 1       # past it the dense rows go on
    dense = tfa.verify_decode_attention(cu[0], _t(kd).cuda(), _t(vd).cuda(),
                                        cu[4])
    torch.cuda.synchronize()
    assert tfa.launch_counts["verify"] == 2
    np.testing.assert_array_equal(
        dense.cpu().numpy().transpose(0, 2, 1, 3)[inside],
        got.cpu().numpy().transpose(0, 2, 1, 3)[inside])
    np.testing.assert_allclose(
        dense.cpu().numpy(),
        tfa.verify_decode_attention(_t(q), _t(kd), _t(vd), _t(pos)).numpy(),
        **CUDA_TOL)
    for j in range(Q):
        dec = tfa.paged_decode_attention(cu[0][:, :, j].contiguous(),
                                         *cu[1:4], _t(pos + j).cuda())
        torch.cuda.synchronize()
        np.testing.assert_array_equal(dec.cpu().numpy(),
                                      got[:, :, j].cpu().numpy())
    assert {n: tfa.launch_counts[n] for n in ("paged_verify", "verify",
                                              "paged_decode")} \
        == {"paged_verify": 2, "verify": 2, "paged_decode": 2 * Q}
