"""Attention kernels of the PyTorch port (counterpart of
``incubator_mxnet_tpu/kernels/flash_attention.py``).

Six public entry points keep the JAX signatures and layouts:

* :func:`flash_attention` — (B, H, T, D) self-attention, dense or causal,
  with an optional (B, T) key-validity mask; CUDA kernel K1
  ``csrc/flash_fwd.cu`` (replaces the Pallas ``_fwd_kernel``).  Where a
  gradient is wanted it runs :class:`_FlashAttention`: K1 with its
  logsumexp output forward, and the FlashAttention-2 backward as CUDA
  kernels K6 ``csrc/flash_bwd_dq.cu`` (replaces ``_bwd_dq_kernel``) and
  K7 ``csrc/flash_bwd_dkv.cu`` (replaces ``_bwd_dkv_kernel``);
* :func:`flash_attention_lse` — the same, also returning the per-row
  logsumexp, with gradients through both outputs;
* :func:`decode_attention` — one query per slot over a dense (S, H, T, D)
  cache; CUDA kernel K3 ``csrc/decode.cu`` (replaces ``_decode_kernel``);
* :func:`paged_decode_attention` — one query per slot through an int32
  block table over (NB, H, bs, D) pages; CUDA kernel K2
  ``csrc/paged_decode.cu`` (replaces ``_paged_decode_kernel``);
* :func:`verify_decode_attention` — Q query rows per slot (row j causal
  at ``positions[s] + j``) over a dense cache, the speculative-decode
  verify step; CUDA kernel K5 ``csrc/verify.cu`` (replaces
  ``_verify_kernel``);
* :func:`paged_verify_decode_attention` — the same through the block
  table; CUDA kernel K4 ``csrc/paged_verify.cu`` (replaces
  ``_paged_verify_kernel``).

Each entry takes its plain PyTorch version (``_plain_*``, ports of the
JAX oracles' arithmetic) only when its tensors lie on the CPU.  For CUDA
tensors it launches the kernel or raises: there is no fallback, and none
of the TPU gates (``MXNET_USE_FUSION``, ``T % 128``, the VMEM budget,
``bs % 8``) carries over — every kernel masks its own ragged edge.  Each
launch adds one to ``launch_counts[name]``.

Masking: keys past the causal diagonal weigh exactly 0 (as in the Pallas
kernel), and a (B, T) mask becomes an additive -1e30 key bias, so a row
whose every key is masked averages the values instead of making a NaN.
For every row that keeps a valid key this equals the JAX ``_xla_attention``
oracle, which masks the diagonal with -1e30.  The backward recomputes
P = exp(S - lse) as the Pallas kernels do; for a row whose every key is
masked the fp32 lse is -1e30 itself, so that row's P is 1 per key (not
1/T) there, exactly as in ``_flash_bwd_impl``.  ``MXNET_FLASH_BWD=xla``
is not ported: the backward raises under it."""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from ..base import MXNetError, getenv
from . import _build

__all__ = ["flash_attention", "flash_attention_lse", "decode_attention",
           "paged_decode_attention", "verify_decode_attention",
           "paged_verify_decode_attention", "launch_counts",
           "reset_launch_counts", "captured_launches", "add_launches"]

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_MAX_GRID_Y = 65535
_DECODE_CHUNK = 64      # keys per split block of K2-K5 (kChunkKeys)
_FWD_TILE = 64          # query rows (K1, K6) or keys (K7) per block

# kernel name -> launches since the last reset (kernel launches only; the
# plain versions never count)
launch_counts = {name: 0 for name in _build.ARGTYPES}


# the counters are shared by every thread (a server replays several
# engines' graphs on several threads); a capture's launches go to the
# capture's own tally instead: the capturing thread's, and, for a captured
# backward, the autograd engine's device thread whose current stream is
# the capturing one (captures are serialised process-wide, so at most one
# tally is open)
_counts_lock = threading.Lock()
_capturing = threading.local()
_open_tally = None


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count(name: str) -> None:
    tally = getattr(_capturing, "tally", None)
    if tally is None and _open_tally is not None \
            and torch.cuda.is_current_stream_capturing():
        tally = _open_tally
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _counts_lock:
        launch_counts[name] += 1


@contextlib.contextmanager
def captured_launches():
    """For a block that captures kernel calls into a CUDA graph: yields a
    dict that, at the block's end, holds the launches each kernel wrapper
    made inside it (on this thread, or on another thread whose current
    stream is capturing), none of which reach ``launch_counts`` (a
    captured call runs nothing).  Pass the dict to :func:`add_launches`
    at each replay of the graph."""
    global _open_tally
    prev, prev_open = getattr(_capturing, "tally", None), _open_tally
    tally: dict = {}
    _capturing.tally = _open_tally = tally
    try:
        yield tally
    finally:
        _capturing.tally, _open_tally = prev, prev_open


def add_launches(tally) -> None:
    """Count one replay of a captured graph: ``tally`` (from
    :func:`captured_launches`) maps kernel names to the launches the
    graph holds."""
    with _counts_lock:
        for name, n in tally.items():
            launch_counts[name] += n


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------

def _plain_scores(q, k, scale, causal, bias=None):
    """(BH, T, Tk) scores q k^T * scale + ``bias`` (an optional (BH, 1, Tk)
    additive key bias, 0 valid / -1e30 masked), -inf past the causal
    diagonal."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias
    if causal:
        T, Tk = q.shape[1], k.shape[1]
        tri = torch.ones(T, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~tri, float("-inf"))
    return s


def _plain_attention(q, k, v, scale, causal, bias=None):
    """(BH, T, D) attention; ``bias`` an optional (BH, 1, Tk) additive key
    bias (0 valid / -1e30 masked)."""
    p = torch.softmax(_plain_scores(q, k, scale, causal, bias), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _plain_attention_lse(q, k, v, scale, causal, bias=None):
    """:func:`_plain_attention` that also returns the per-row logsumexp
    (BH, T) fp32 of the scaled, biased, masked scores (a port of
    ``_xla_attention_lse``, with the causal keys at -inf as in K1).  The
    output is normalised by the row sum, not by exp(lse), so a row whose
    every key is masked averages the values as K1 does (its fp32 lse is
    -1e30 itself)."""
    s = _plain_scores(q, k, scale, causal, bias)
    p = torch.softmax(s, dim=-1)
    return (torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype),
            torch.logsumexp(s, dim=-1))


def _per_head(bias, n_heads):
    """A (B, 1, T) key bias as the (B*H, 1, T) the plain versions add."""
    if bias is None:
        return None
    B, _, T = bias.shape
    return bias[:, None].expand(B, n_heads, 1, T).reshape(B * n_heads, 1, T)


def _bwd_dd(out, g, g_lse=None):
    """dd = rowsum(dO * O) - g_lse (BH, T) fp32, computed outside the
    kernels as ``_flash_bwd_impl`` computes it outside Pallas."""
    dd = (out.float() * g.float()).sum(-1)
    if g_lse is not None:
        dd = dd - g_lse.float()
    return dd


def _plain_flash_bwd_dd(q, k, v, bias, g, lse, dd, scale, causal, n_heads):
    """K6 and K7's plain version: the FlashAttention-2 backward formulas
    over whole (BH, T, T) matrices.  ``bias`` None or (B, 1, T).  Returns
    (dq, dk, dv, dbs) with dbs (BH, T) the column sums of dS."""
    s = _plain_scores(q, k, scale, causal, _per_head(bias, n_heads))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", g.float(), v.float())
    ds = p * (dp - dd[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    dv = torch.einsum("bqk,bqd->bkd", p, g.float())
    return dq, dk, dv, ds.sum(1)


def _dbias(dbs, n_heads):
    """(BH, T) key-bias rows -> the (B, 1, T) bias's cotangent: the head
    axis summed out (``_flash_bwd_impl`` :356-359)."""
    BH, T = dbs.shape
    return dbs.reshape(BH // n_heads, n_heads, T).sum(1)[:, None, :]


def _key_bias(mask, B, T, device):
    """A (B, T) key-validity mask as the (B, 1, T) additive bias the JAX
    dispatcher builds (0 valid / -1e30 masked); None stays None."""
    if mask is None:
        return None
    return torch.where(mask.reshape(B, 1, T) > 0, 0.0, NEG).to(
        device=device, dtype=torch.float32)


def _plain_flash_attention(q, k, v, scale, causal, mask=None):
    """:func:`flash_attention`'s plain version over (B, H, T, D) tensors
    on any device: the key bias broadcast over the heads, then
    :func:`_plain_attention`."""
    B, H, T, D = q.shape
    return _plain_attention(q.reshape(B * H, T, D), k.reshape(B * H, T, D),
                            v.reshape(B * H, T, D), scale, causal,
                            _per_head(_key_bias(mask, B, T, q.device), H)
                            ).reshape(B, H, T, D)


def _plain_decode_attention(q, k, v, positions, scale):
    """(S, H, D) single-position attention over (S, H, T, D) caches,
    masked to cache entries ``<= positions[s]``."""
    T = k.shape[2]
    s = torch.einsum("shd,shtd->sht", q.float(), k.float()) * scale
    live = torch.arange(T, device=q.device)[None, None, :] \
        <= positions.long()[:, None, None]
    s = s.masked_fill(~live, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("sht,shtd->shd", p, v.float()).to(q.dtype)


def _gather_pages(k_pages, v_pages, tables):
    """Each slot's blocks as a dense (S, H, MB * bs, D) view of K and of V.
    Table entries are clamped into the pool, as the JAX gather clamps
    them."""
    S, nb = tables.shape
    NB, H, bs, D = k_pages.shape
    idx = tables.long().clamp(0, NB - 1)
    k = k_pages[idx].permute(0, 2, 1, 3, 4).reshape(S, H, nb * bs, D)
    v = v_pages[idx].permute(0, 2, 1, 3, 4).reshape(S, H, nb * bs, D)
    return k, v


def _plain_paged_decode_attention(q, k_pages, v_pages, tables, positions,
                                  scale):
    """Gather each slot's blocks into a dense (S, H, T, D) view and reuse
    :func:`_plain_decode_attention`."""
    k, v = _gather_pages(k_pages, v_pages, tables)
    return _plain_decode_attention(q, k, v, positions, scale)


def _plain_verify_decode_attention(q, k, v, positions, scale):
    """(S, H, Q, D) query-block attention over (S, H, T, D) caches: row j
    of slot s attends to entries ``<= positions[s] + j`` (causal inside
    the block; stale entries past each row's head are masked, as in
    single-query decode)."""
    S, H, Q, D = q.shape
    T = k.shape[2]
    s = torch.einsum("shqd,shtd->shqt", q.float(), k.float()) * scale
    qpos = positions.long()[:, None] \
        + torch.arange(Q, device=q.device)[None, :]           # (S, Q)
    live = torch.arange(T, device=q.device)[None, None, None, :] \
        <= qpos[:, None, :, None]
    s = s.masked_fill(~live, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("shqt,shtd->shqd", p, v.float()).to(q.dtype)


def _plain_paged_verify_decode_attention(q, k_pages, v_pages, tables,
                                         positions, scale):
    """Gather each slot's blocks into a dense (S, H, T, D) view and reuse
    :func:`_plain_verify_decode_attention`."""
    k, v = _gather_pages(k_pages, v_pages, tables)
    return _plain_verify_decode_attention(q, k, v, positions, scale)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, dev, **tensors):
    """Raise unless ``dev`` is a CUDA device and every tensor is a
    contiguous, 16-byte aligned tensor of the stated dtype on it."""
    if dev.type != "cuda":
        raise MXNetError(f"{name}: the kernel needs CUDA tensors, got {dev}")
    for tname, (t, dtype) in tensors.items():
        if t.device != dev:
            raise MXNetError(f"{name}: {tname} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise MXNetError(f"{name}: {tname} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            raise MXNetError(f"{name}: {tname} is not 16-byte aligned")


def _launch(name, *args):
    """Call kernel ``name``'s C entry on the current stream of the device
    of the first tensor argument; raise on a nonzero return code."""
    lib = _build.library(name)
    fn = getattr(lib, "mx_" + name)
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        rc = fn(*conv, stream)
    if rc != 0:
        raise MXNetError(f"{name} kernel launch failed: "
                         f"{lib.mx_error_string(rc).decode()} (code {rc})")
    _count(name)


def _head_dim_ok(name, D):
    if D not in HEAD_DIMS:
        raise MXNetError(f"{name}: head dim {D} not in {HEAD_DIMS}")


def _attn_checks(name, q, k, v, bias, n_heads, **more):
    """The checks K1, K6 and K7 share: fp32 contiguous (BH, T, D) q, k, v
    (and ``more``) on one CUDA device, a supported D, and ``bias`` None or
    (BH / n_heads, 1, T)."""
    BH, T, D = q.shape
    f32 = torch.float32
    _check(name, q.device, q=(q, f32), k=(k, f32), v=(v, f32),
           **{n: (t, f32) for n, t in more.items()})
    if any(t.shape != q.shape for t in (k, v)):
        raise MXNetError(f"{name}: q, k, v must share one (BH, T, D) shape")
    _head_dim_ok(name, D)
    if BH % n_heads or BH > _MAX_GRID_Y:
        raise MXNetError(f"{name}: BH={BH} with {n_heads} heads unsupported")
    if bias is not None:
        _check(name, q.device, bias=(bias, f32))
        if tuple(bias.shape) != (BH // n_heads, 1, T):
            raise MXNetError(f"{name}: bias shape {tuple(bias.shape)} != "
                             f"{(BH // n_heads, 1, T)}")


def _flash_fwd_cuda(q, k, v, bias, scale, causal, n_heads, with_lse=False):
    """K1 on (BH, T, D) fp32 CUDA tensors; ``bias`` None or (BH/n_heads,
    1, T) fp32.  Returns o, or (o, lse (BH, T) fp32) ``with_lse``."""
    BH, T, D = q.shape
    _attn_checks("flash_fwd", q, k, v, bias, n_heads)
    if -(-T // _FWD_TILE) > _MAX_GRID_Y:
        raise MXNetError(f"flash_fwd: T={T} exceeds the grid")
    o = torch.empty_like(q)
    lse = torch.empty(BH, T, device=q.device, dtype=torch.float32) \
        if with_lse else None
    if T:
        _launch("flash_fwd", q, k, v, bias, o, lse,
                BH, n_heads, T, D, float(scale), int(bool(causal)))
    return (o, lse) if with_lse else o


def _flash_bwd_cuda(q, k, v, bias, g, lse, dd, scale, causal, n_heads):
    """K6 then K7 on (BH, T, D) fp32 CUDA tensors, ``lse`` and ``dd`` (BH,
    T) fp32.  Returns (dq, dk, dv, dbs)."""
    BH, T, D = q.shape
    _attn_checks("flash_bwd", q, k, v, bias, n_heads, g=g, lse=lse, dd=dd)
    if g.shape != q.shape or tuple(lse.shape) != (BH, T) \
            or lse.shape != dd.shape:
        raise MXNetError(f"flash_bwd: dO {tuple(g.shape)}, lse "
                         f"{tuple(lse.shape)}, dd {tuple(dd.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if -(-T // _FWD_TILE) > _MAX_GRID_Y:
        raise MXNetError(f"flash_bwd: T={T} exceeds the grid")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbs = torch.empty(BH, T, device=q.device, dtype=torch.float32)
    if T:
        args = (BH, n_heads, T, D, float(scale), int(bool(causal)))
        _launch("flash_bwd_dq", q, k, v, bias, g, lse, dd, dq, *args)
        _launch("flash_bwd_dkv", q, k, v, bias, g, lse, dd, dk, dv, dbs,
                *args)
    return dq, dk, dv, dbs


class _FlashAttention(torch.autograd.Function):
    """(BH, T, D) attention with its FlashAttention-2 backward, where the
    JAX package's ``_flash``/``_flash_lse`` ``custom_vjp`` stand.  Forward:
    K1 with lse (CUDA) or :func:`_plain_attention_lse` (CPU); saves (q, k,
    v, bias, out, lse).  Backward: dd = rowsum(dO * O) - g_lse, then K6 and
    K7 (CUDA) or :func:`_plain_flash_bwd_dd` (CPU).  ``bias`` None or (B,
    1, T); its cotangent is returned only when it needs one.  Outputs (out,
    lse); gradients flow through both."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal, n_heads):
        if _route("flash_attention", q) == "cuda":
            out, lse = _flash_fwd_cuda(q, k, v, bias, scale, causal, n_heads,
                                       with_lse=True)
        else:
            out, lse = _plain_attention_lse(q, k, v, scale, causal,
                                            _per_head(bias, n_heads))
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.causal, ctx.n_heads = scale, causal, n_heads
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        if (getenv("MXNET_FLASH_BWD") or "pallas").lower() == "xla":
            raise MXNetError("MXNET_FLASH_BWD=xla is not ported: the "
                             "backward is kernels K6 and K7 on the card and "
                             "their plain version on the CPU")
        q, k, v, bias, out, lse = ctx.saved_tensors
        g = torch.zeros_like(out) if g_out is None else g_out.contiguous()
        dd = _bwd_dd(out, g, g_lse)
        args = (ctx.scale, ctx.causal, ctx.n_heads)
        if q.device.type == "cuda":
            dq, dk, dv, dbs = _flash_bwd_cuda(q, k, v, bias, g, lse, dd, *args)
        else:
            dq, dk, dv, dbs = _plain_flash_bwd_dd(q, k, v, bias, g, lse, dd,
                                                  *args)
        dbias = _dbias(dbs, ctx.n_heads) \
            if bias is not None and ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None, None, None


def _decode_scratch_shape(S, H, length, D):
    """The (S, H, n_split, D + 2) fp32 scratch of K2/K3's split over a
    cache of ``length`` keys: one (acc[D], m, l) partial per (slot, head,
    key chunk), n_split = ceil(length / 64), fixed by the shape alone
    (the split kernel's grid depth)."""
    return (S, H, -(-int(length) // _DECODE_CHUNK), D + 2)


def _verify_scratch_shape(S, H, Q, length, D):
    """The (S, H, Q, n_split, D + 2) fp32 scratch of K4/K5's split: K2/K3's
    with one partial per query row, n_split = ceil(length / 64)."""
    return (S, H, Q, -(-int(length) // _DECODE_CHUNK), D + 2)


def _split_scratch(name, q, shape):
    """Allocate a split's scratch of ``shape`` (its split count second to
    last) on ``q``'s device; raise where the split count exceeds the
    grid."""
    if shape[-2] > _MAX_GRID_Y:
        raise MXNetError(f"{name}: {shape[-2]} key chunks exceed the split "
                         f"grid")
    return torch.empty(shape, device=q.device, dtype=torch.float32)


def _decode_checks(name, q, positions, S, H, D):
    _check(name, q.device, q=(q, torch.float32),
           positions=(positions, torch.int32))
    if tuple(q.shape) != (S, H, D) or tuple(positions.shape) != (S,):
        raise MXNetError(f"{name}: q {tuple(q.shape)} / positions "
                         f"{tuple(positions.shape)} do not match ({S}, {H}, "
                         f"{D}) / ({S},)")
    _head_dim_ok(name, D)
    if S > _MAX_GRID_Y:
        raise MXNetError(f"{name}: {S} slots exceed {_MAX_GRID_Y}")


def _decode_cuda(q, k, v, positions, scale):
    """K3 on CUDA tensors: q (S, H, D), k/v (S, H, T, D) fp32, positions
    (S,) int32 read by the kernel on the device.  Two launches, the split
    over 64-key chunks and the merge, counted as one."""
    S, H, T, D = k.shape
    _decode_checks("decode", q, positions, S, H, D)
    _check("decode", q.device, k=(k, torch.float32), v=(v, torch.float32))
    if v.shape != k.shape:
        raise MXNetError("decode: k and v shapes differ")
    o = torch.empty_like(q)
    if S == 0 or T == 0:
        return o.zero_()
    part = _split_scratch("decode", q, _decode_scratch_shape(S, H, T, D))
    _launch("decode", q, k, v, positions, part, o, S, H, T, D, float(scale))
    return o


def _paged_decode_cuda(q, k_pages, v_pages, tables, positions, scale):
    """K2 on CUDA tensors: q (S, H, D), pages (NB, H, bs, D) fp32, tables
    (S, MB) and positions (S,) int32, both read by the kernel on the
    device.  Two launches, the split over 64-key chunks and the merge,
    counted as one."""
    NB, H, bs, D = k_pages.shape
    S, MB = tables.shape
    _decode_checks("paged_decode", q, positions, S, H, D)
    _check("paged_decode", q.device, k_pages=(k_pages, torch.float32),
           v_pages=(v_pages, torch.float32), tables=(tables, torch.int32))
    if v_pages.shape != k_pages.shape:
        raise MXNetError("paged_decode: k_pages and v_pages shapes differ")
    o = torch.empty_like(q)
    if S == 0 or MB == 0:
        return o.zero_()
    part = _split_scratch("paged_decode", q,
                          _decode_scratch_shape(S, H, MB * bs, D))
    _launch("paged_decode", q, k_pages, v_pages, tables, positions, part, o,
            S, H, NB, bs, MB, D, float(scale))
    return o


def _verify_checks(name, q, positions, S, H, D):
    _check(name, q.device, q=(q, torch.float32),
           positions=(positions, torch.int32))
    if q.dim() != 4 or tuple(q.shape[:2]) != (S, H) or q.shape[3] != D \
            or tuple(positions.shape) != (S,):
        raise MXNetError(f"{name}: q {tuple(q.shape)} / positions "
                         f"{tuple(positions.shape)} do not match ({S}, {H}, "
                         f"Q, {D}) / ({S},)")
    _head_dim_ok(name, D)
    if S > _MAX_GRID_Y or q.shape[2] > _MAX_GRID_Y:
        raise MXNetError(f"{name}: {S} slots or {q.shape[2]} query rows "
                         f"exceed the grid")


def _verify_cuda(q, k, v, positions, scale):
    """K5 on CUDA tensors: q (S, H, Q, D), k/v (S, H, T, D) fp32, positions
    (S,) int32 read by the kernel on the device.  Two launches, the split
    over 64-key chunks and the merge, counted as one."""
    S, H, T, D = k.shape
    _verify_checks("verify", q, positions, S, H, D)
    _check("verify", q.device, k=(k, torch.float32), v=(v, torch.float32))
    if v.shape != k.shape:
        raise MXNetError("verify: k and v shapes differ")
    o = torch.empty_like(q)
    if q.numel() == 0 or T == 0:
        return o.zero_()
    Q = q.shape[2]
    part = _split_scratch("verify", q, _verify_scratch_shape(S, H, Q, T, D))
    _launch("verify", q, k, v, positions, part, o, S, H, T, Q, D,
            float(scale))
    return o


def _paged_verify_cuda(q, k_pages, v_pages, tables, positions, scale):
    """K4 on CUDA tensors: q (S, H, Q, D), pages (NB, H, bs, D) fp32,
    tables (S, MB) and positions (S,) int32, both read by the kernel on
    the device.  Two launches, the split over 64-key chunks and the merge,
    counted as one."""
    NB, H, bs, D = k_pages.shape
    S, MB = tables.shape
    _verify_checks("paged_verify", q, positions, S, H, D)
    _check("paged_verify", q.device, k_pages=(k_pages, torch.float32),
           v_pages=(v_pages, torch.float32), tables=(tables, torch.int32))
    if v_pages.shape != k_pages.shape:
        raise MXNetError("paged_verify: k_pages and v_pages shapes differ")
    o = torch.empty_like(q)
    if q.numel() == 0 or MB == 0:
        return o.zero_()
    Q = q.shape[2]
    part = _split_scratch("paged_verify", q,
                          _verify_scratch_shape(S, H, Q, MB * bs, D))
    _launch("paged_verify", q, k_pages, v_pages, tables, positions, part, o,
            S, H, NB, bs, MB, Q, D, float(scale))
    return o


def _route(name, t):
    """'cpu' or 'cuda' for the device of ``t``; anything else raises."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise MXNetError(f"{name}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _with_lse(q, k, v, scale, causal, mask):
    """(out (B, H, T, D), lse (B, H, T)) through :class:`_FlashAttention`."""
    B, H, T, D = q.shape
    out, lse = _FlashAttention.apply(
        *(x.reshape(B * H, T, D) for x in (q, k, v)),
        _key_bias(mask, B, T, q.device), scale, causal, H)
    return out.reshape(B, H, T, D), lse.reshape(B, H, T)


def _attn_args(name, q, k, v, scale):
    """Check the (B, H, T, D) shapes and device; return the scale."""
    if k.shape != q.shape or v.shape != q.shape:
        raise MXNetError(f"{name}: q, k, v must share one (B, H, T, D) "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _route(name, q)
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def flash_attention(q, k, v, scale=None, causal=False, mask=None):
    """Online-softmax self-attention over (B, H, T, D) tensors.

    ``mask``: optional (B, T) key-validity tensor (nonzero = attend),
    applied as an additive -1e30 bias shared by the heads.  Without a
    gradient to record, CUDA tensors run kernel K1 at any T and CPU
    tensors :func:`_plain_attention`; with one, :class:`_FlashAttention`
    (K1 with lse, then K6 and K7 in the backward)."""
    scale = _attn_args("flash_attention", q, k, v, scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _with_lse(q, k, v, scale, causal, mask)[0]
    if q.device.type == "cpu":
        return _plain_flash_attention(q, k, v, scale, causal, mask)
    B, H, T, D = q.shape
    qf, kf, vf = (x.reshape(B * H, T, D) for x in (q, k, v))
    return _flash_fwd_cuda(qf, kf, vf, _key_bias(mask, B, T, q.device),
                           scale, causal, H).reshape(B, H, T, D)


def flash_attention_lse(q, k, v, scale=None, causal=False, mask=None):
    """Like :func:`flash_attention` but also returns the per-row
    logsumexp: (out (B, H, T, D), lse (B, H, T) fp32).  Gradients flow
    through both outputs (the lse cotangent folds into dd).  CUDA tensors
    run K1 with its lse output (K6 and K7 in the backward); CPU tensors
    :func:`_plain_attention_lse`."""
    scale = _attn_args("flash_attention_lse", q, k, v, scale)
    return _with_lse(q, k, v, scale, causal, mask)


def decode_attention(q, k, v, positions, scale=None):
    """Per-slot single-position attention over a dense KV cache.

    ``q`` (S, H, D): this step's query; ``k``/``v`` (S, H, T, D): the
    cache, already holding this position's K/V at ``positions[s]``;
    ``positions`` (S,) int32 (>= 0): each slot's write head.  Attends over
    entries ``<= positions[s]``; the kernel reads ``positions`` on the
    device, so a frozen slot in a burst keeps attending over exactly its
    old prefix.  Returns (S, H, D)."""
    D = k.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if _route("decode_attention", q) == "cpu":
        return _plain_decode_attention(q, k, v, positions, scale)
    return _decode_cuda(q, k, v, positions, scale)


def paged_decode_attention(q, k_pages, v_pages, tables, positions,
                           scale=None):
    """Per-slot single-position attention over a PAGED KV cache.

    ``q`` (S, H, D); ``k_pages``/``v_pages`` (num_blocks, H, block_size,
    D): the block pool, already holding this position's K/V; ``tables``
    (S, max_blocks) int32: each slot's block table, padded with the null
    block 0; ``positions`` (S,) int32 (>= 0): each slot's write head in
    logical token coordinates.  Attends over logical positions
    ``<= positions[s]``; tables and positions are read on the device.
    Returns (S, H, D)."""
    D = k_pages.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if _route("paged_decode_attention", q) == "cpu":
        return _plain_paged_decode_attention(q, k_pages, v_pages, tables,
                                             positions, scale)
    return _paged_decode_cuda(q, k_pages, v_pages, tables, positions, scale)


def verify_decode_attention(q, k, v, positions, scale=None):
    """Per-slot query-block attention over a dense KV cache (the
    speculative-decode verify step).

    ``q`` (S, H, Q, D): row j is the query of the token at logical
    position ``positions[s] + j``; ``k``/``v`` (S, H, T, D): the cache,
    already holding all Q positions' K/V; ``positions`` (S,) int32: the
    base position of row 0.  Row j attends to entries ``<= positions[s] +
    j``; with Q == 1 this is :func:`decode_attention`.  Any Q >= 1; the
    kernel reads ``positions`` on the device.  Returns (S, H, Q, D)."""
    D = k.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if _route("verify_decode_attention", q) == "cpu":
        return _plain_verify_decode_attention(q, k, v, positions, scale)
    return _verify_cuda(q, k, v, positions, scale)


def paged_verify_decode_attention(q, k_pages, v_pages, tables, positions,
                                  scale=None):
    """Per-slot query-block attention over a PAGED KV cache.

    ``q`` (S, H, Q, D): row j at logical position ``positions[s] + j``;
    ``k_pages``/``v_pages`` (num_blocks, H, block_size, D); ``tables``
    (S, max_blocks) int32 padded with the null block 0; ``positions`` (S,)
    int32 base positions.  Tables and positions are read on the device.
    Returns (S, H, Q, D)."""
    D = k_pages.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if _route("paged_verify_decode_attention", q) == "cpu":
        return _plain_paged_verify_decode_attention(q, k_pages, v_pages,
                                                    tables, positions, scale)
    return _paged_verify_cuda(q, k_pages, v_pages, tables, positions, scale)
