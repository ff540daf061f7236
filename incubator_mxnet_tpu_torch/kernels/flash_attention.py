"""Attention kernels of the PyTorch port (counterpart of
``incubator_mxnet_tpu/kernels/flash_attention.py``).

Five public entry points keep the JAX signatures and layouts:

* :func:`flash_attention` — (B, H, T, D) self-attention, dense or causal,
  with an optional (B, T) key-validity mask; CUDA kernel K1
  ``csrc/flash_fwd.cu`` (replaces the Pallas ``_fwd_kernel``);
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
oracle, which masks the diagonal with -1e30."""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "decode_attention", "paged_decode_attention",
           "verify_decode_attention", "paged_verify_decode_attention",
           "launch_counts", "reset_launch_counts"]

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_MAX_GRID_Y = 65535
_VERIFY_CHUNK = 8       # query rows per block of K4/K5 (kChunk)

# kernel name -> launches since the last reset (kernel launches only; the
# plain versions never count)
launch_counts = {name: 0 for name in _build.KERNELS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------

def _plain_attention(q, k, v, scale, causal, bias=None):
    """(BH, T, D) attention; ``bias`` an optional (BH, 1, Tk) additive key
    bias (0 valid / -1e30 masked)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias
    if causal:
        T, Tk = q.shape[1], k.shape[1]
        tri = torch.ones(T, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~tri, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


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
    bias = _key_bias(mask, B, T, q.device)
    if bias is not None:
        bias = bias[:, None].expand(B, H, 1, T).reshape(B * H, 1, T)
    return _plain_attention(q.reshape(B * H, T, D), k.reshape(B * H, T, D),
                            v.reshape(B * H, T, D), scale, causal,
                            bias).reshape(B, H, T, D)


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
    launch_counts[name] += 1


def _head_dim_ok(name, D):
    if D not in HEAD_DIMS:
        raise MXNetError(f"{name}: head dim {D} not in {HEAD_DIMS}")


def _flash_fwd_cuda(q, k, v, bias, scale, causal, n_heads):
    """K1 on (BH, T, D) fp32 CUDA tensors; ``bias`` None or (BH/n_heads,
    1, T) fp32."""
    BH, T, D = q.shape
    f32 = torch.float32
    _check("flash_fwd", q.device, q=(q, f32), k=(k, f32), v=(v, f32))
    if k.shape != q.shape or v.shape != q.shape:
        raise MXNetError("flash_fwd: q, k, v must share one (BH, T, D) shape")
    _head_dim_ok("flash_fwd", D)
    if BH % n_heads or BH > _MAX_GRID_Y:
        raise MXNetError(f"flash_fwd: BH={BH} with {n_heads} heads "
                         f"unsupported")
    if bias is not None:
        _check("flash_fwd", q.device, bias=(bias, f32))
        if tuple(bias.shape) != (BH // n_heads, 1, T):
            raise MXNetError(f"flash_fwd: bias shape {tuple(bias.shape)} != "
                             f"{(BH // n_heads, 1, T)}")
    o = torch.empty_like(q)
    if T == 0:
        return o
    _launch("flash_fwd", q, k, v, bias, o,
            BH, n_heads, T, D, float(scale), int(bool(causal)))
    return o


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
    (S,) int32 read by the kernel on the device."""
    S, H, T, D = k.shape
    _decode_checks("decode", q, positions, S, H, D)
    _check("decode", q.device, k=(k, torch.float32), v=(v, torch.float32))
    if v.shape != k.shape:
        raise MXNetError("decode: k and v shapes differ")
    o = torch.empty_like(q)
    if S == 0 or T == 0:
        return o.zero_()
    _launch("decode", q, k, v, positions, o, S, H, T, D, float(scale))
    return o


def _paged_decode_cuda(q, k_pages, v_pages, tables, positions, scale):
    """K2 on CUDA tensors: q (S, H, D), pages (NB, H, bs, D) fp32, tables
    (S, MB) and positions (S,) int32, both read by the kernel on the
    device."""
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
    _launch("paged_decode", q, k_pages, v_pages, tables, positions, o,
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
    chunks = -(-q.shape[2] // _VERIFY_CHUNK)
    if S > _MAX_GRID_Y or chunks > _MAX_GRID_Y:
        raise MXNetError(f"{name}: {S} slots or {q.shape[2]} query rows "
                         f"exceed the grid")


def _verify_cuda(q, k, v, positions, scale):
    """K5 on CUDA tensors: q (S, H, Q, D), k/v (S, H, T, D) fp32, positions
    (S,) int32 read by the kernel on the device."""
    S, H, T, D = k.shape
    _verify_checks("verify", q, positions, S, H, D)
    _check("verify", q.device, k=(k, torch.float32), v=(v, torch.float32))
    if v.shape != k.shape:
        raise MXNetError("verify: k and v shapes differ")
    o = torch.empty_like(q)
    if q.numel() == 0 or T == 0:
        return o.zero_()
    _launch("verify", q, k, v, positions, o, S, H, T, q.shape[2], D,
            float(scale))
    return o


def _paged_verify_cuda(q, k_pages, v_pages, tables, positions, scale):
    """K4 on CUDA tensors: q (S, H, Q, D), pages (NB, H, bs, D) fp32,
    tables (S, MB) and positions (S,) int32, both read by the kernel on
    the device."""
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
    _launch("paged_verify", q, k_pages, v_pages, tables, positions, o,
            S, H, NB, bs, MB, q.shape[2], D, float(scale))
    return o


def _route(name, t):
    """'cpu' or 'cuda' for the device of ``t``; anything else raises."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise MXNetError(f"{name}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, scale=None, causal=False, mask=None):
    """Online-softmax self-attention over (B, H, T, D) tensors.

    ``mask``: optional (B, T) key-validity tensor (nonzero = attend),
    applied as an additive -1e30 bias shared by the heads.  CUDA tensors
    run kernel K1 at any T; CPU tensors run :func:`_plain_attention`."""
    B, H, T, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise MXNetError("flash_attention: q, k, v must share one "
                         f"(B, H, T, D) shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if _route("flash_attention", q) == "cpu":
        return _plain_flash_attention(q, k, v, scale, causal, mask)
    qf, kf, vf = (x.reshape(B * H, T, D) for x in (q, k, v))
    return _flash_fwd_cuda(qf, kf, vf, _key_bias(mask, B, T, q.device),
                           scale, causal, H).reshape(B, H, T, D)


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
