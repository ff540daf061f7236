"""``nd.save`` / ``nd.load`` in the reference's byte format (counterpart
of ``incubator_mxnet_tpu/ndarray/utils.py``).

The format (the reference's ``MXNDArraySave``): a list header (magic
0x112, a reserved u64, the array count), each array as a V2 chunk (magic
0xF993FAC9, int32 storage type, the shape as int32 ndim + int64 dims, the
context as two int32, the int32 mshadow type flag, the raw little-endian
buffer), then the name count and each name as u64 length + UTF-8.  The
loader also reads V1 chunks (no storage type) and the legacy V0 chunks
(the "magic" is the ndim, dims are uint32).  Bytes are built and parsed
with ``struct`` and numpy; only the last step makes tensors.  Sparse
chunks are refused (sparse arrays: ROADMAP Queue A item 15)."""
from __future__ import annotations

import struct
from typing import Dict, List, Union

import numpy as _np
import torch

from ..base import MXNetError
from .ndarray import NDArray, _device

__all__ = ["save", "load", "load_frombuffer"]

_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9
_V3_MAGIC = 0xF993FACA
_STYPE_DENSE = 0

# mshadow type flags
_TYPE_TO_FLAG = {
    _np.dtype(_np.float32): 0, _np.dtype(_np.float64): 1,
    _np.dtype(_np.float16): 2, _np.dtype(_np.uint8): 3,
    _np.dtype(_np.int32): 4, _np.dtype(_np.int8): 5,
    _np.dtype(_np.int64): 6, _np.dtype(_np.bool_): 7,
}
_FLAG_TO_TYPE = {v: k for k, v in _TYPE_TO_FLAG.items()}
_BF16_FLAG = 12     # mshadow kBfloat16, stored as its 16 raw bits


def _host(arr):
    """(flag, numpy array of the bytes to write) for an NDArray, tensor
    or numpy array."""
    if isinstance(arr, NDArray):
        arr = arr._data
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16_FLAG, t.view(torch.int16).numpy().view(_np.uint16)
        arr = t.numpy()
    a = _np.ascontiguousarray(arr)
    try:
        return _TYPE_TO_FLAG[a.dtype], a
    except KeyError:
        raise MXNetError(f"cannot serialize dtype {a.dtype}")


def _shape_pack(shape):
    return struct.pack("<i", len(shape)) \
        + struct.pack(f"<{len(shape)}q", *shape)


def save(fname: str, data):
    """Save an NDArray, a list of them, or a ``{name: NDArray}`` dict
    (numpy arrays and tensors are taken too)."""
    if isinstance(data, (NDArray, torch.Tensor, _np.ndarray)):
        data, names = [data], []
    elif isinstance(data, (list, tuple)):
        if not all(isinstance(a, (NDArray, torch.Tensor, _np.ndarray))
                   for a in data):
            raise MXNetError("save expects NDArray elements")
        data, names = list(data), []
    elif isinstance(data, dict):
        names, data = list(data.keys()), list(data.values())
    else:
        raise MXNetError(f"cannot save {type(data)}")
    buf = bytearray()
    buf += struct.pack("<QQ", _LIST_MAGIC, 0)
    buf += struct.pack("<Q", len(data))
    for arr in data:
        flag, a = _host(arr)
        buf += struct.pack("<I", _V2_MAGIC)
        buf += struct.pack("<i", _STYPE_DENSE)
        buf += _shape_pack(a.shape)
        buf += struct.pack("<ii", 1, 0)              # context: cpu(0)
        buf += struct.pack("<i", flag)
        buf += a.tobytes()
    buf += struct.pack("<Q", len(names))
    for name in names:
        b = name.encode("utf-8")
        buf += struct.pack("<Q", len(b)) + b
    with open(fname, "wb") as f:
        f.write(bytes(buf))


def _load_chunk(mv: memoryview, off: int):
    """One chunk -> (numpy array, flag, offset after it)."""
    (magic,) = struct.unpack_from("<I", mv, off)
    off += 4
    if magic in (_V2_MAGIC, _V3_MAGIC):
        (stype,) = struct.unpack_from("<i", mv, off)
        off += 4
        if stype != _STYPE_DENSE:
            raise MXNetError(f"storage type {stype} in file: sparse arrays "
                             "are not ported (ROADMAP Queue A item 15)")
    if magic in (_V1_MAGIC, _V2_MAGIC, _V3_MAGIC):
        (ndim,) = struct.unpack_from("<i", mv, off)
        off += 4
        shape = struct.unpack_from(f"<{ndim}q", mv, off)
        off += 8 * ndim
    else:               # legacy V0: the "magic" is the ndim, dims uint32
        ndim = magic
        shape = struct.unpack_from(f"<{ndim}I", mv, off)
        off += 4 * ndim
    off += 8            # the saved context: arrays load on the caller's
    (flag,) = struct.unpack_from("<i", mv, off)
    off += 4
    if flag == _BF16_FLAG:
        dt = _np.dtype(_np.uint16)
    elif flag in _FLAG_TO_TYPE:
        dt = _FLAG_TO_TYPE[flag]
    else:
        raise MXNetError(f"unknown mshadow type flag {flag}")
    n = int(_np.prod(shape)) if ndim else 1
    a = _np.frombuffer(mv, dtype=dt, count=n, offset=off).reshape(shape)
    return _np.array(a), flag, off + n * dt.itemsize


def _tensor(a, flag, dev):
    t = torch.from_numpy(a)
    if flag == _BF16_FLAG:
        t = t.view(torch.int16).view(torch.bfloat16)
    return NDArray(t.to(dev))


def load_frombuffer(raw: bytes, ctx=None
                    ) -> Union[List[NDArray], Dict[str, NDArray]]:
    """Arrays from the bytes of a saved file, on ``ctx`` (default: the
    current context): a list, or a dict when the file names them."""
    mv = memoryview(raw)
    header, _reserved = struct.unpack_from("<QQ", mv, 0)
    if header != _LIST_MAGIC:
        raise MXNetError("invalid NDArray file format (bad magic)")
    off = 16
    (n,) = struct.unpack_from("<Q", mv, off)
    off += 8
    chunks = []
    for _ in range(n):
        a, flag, off = _load_chunk(mv, off)
        chunks.append((a, flag))
    (n_names,) = struct.unpack_from("<Q", mv, off)
    off += 8
    names = []
    for _ in range(n_names):
        (ln,) = struct.unpack_from("<Q", mv, off)
        off += 8
        names.append(bytes(mv[off:off + ln]).decode("utf-8"))
        off += ln
    if n_names and n_names != n:
        raise MXNetError("corrupt NDArray file: names/arrays mismatch")
    dev = _device(ctx)
    arrays = [_tensor(a, flag, dev) for a, flag in chunks]
    return dict(zip(names, arrays)) if n_names else arrays


def load(fname: str, ctx=None):
    """Load a file written by :func:`save` (or by the reference)."""
    with open(fname, "rb") as f:
        return load_frombuffer(f.read(), ctx=ctx)
