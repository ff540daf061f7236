"""Gluon utilities (counterpart of ``incubator_mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``,
``download`` and ``shape_is_known``.

The port runs on one device, so ``split_and_load`` over one context
places the whole batch there (the card, or the CPU); over several it
splits the batch as the reference does, one slice per context.
``download`` takes ``file://`` URLs and local paths as well as HTTP(S),
writes to a temporary file and renames it, so an interrupted transfer
never leaves a partial file at the path."""
from __future__ import annotations

import math

from ..base import MXNetError
from ..ndarray import ndarray as _ndmod
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download", "shape_is_known"]


def split_data(data: NDArray, num_slice: int, batch_axis=0,
               even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last
    takes the remainder unless ``even_split`` demands none."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}")
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` (an NDArray or array-like) split over ``ctx_list`` and
    placed on each context; one context takes it whole."""
    if not isinstance(data, NDArray):
        data = _ndmod.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (a float: the host
    reads it, as the reference does)."""
    if not arrays:
        raise MXNetError("no arrays to clip")
    total = 0.0
    for a in arrays:
        total += float(a.norm().asscalar()) ** 2
    total = math.sqrt(total)
    if check_isfinite and not math.isfinite(total):
        import warnings
        warnings.warn("nan or inf found in clip_global_norm")
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return total


def check_sha1(filename, sha1_hash):
    """True if the file's SHA-1 is ``sha1_hash``."""
    import hashlib
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Fetch ``url`` (HTTP(S), ``file://`` or a local path) to ``path`` (a
    file, or a directory that takes the URL's file name; default: that
    name here); an existing file with the right hash (or any, without
    one) is kept unless ``overwrite``.  A client error (4xx) fails at
    once; other failures are retried ``retries`` times with backoff.
    Returns the path."""
    import os
    import shutil
    import time
    import urllib.error
    import urllib.request
    fname = url.split("/")[-1].split("?")[0]
    if path is None:
        path = fname
    elif os.path.isdir(path):
        path = os.path.join(path, fname)
    if os.path.exists(path) and not overwrite and (
            sha1_hash is None or check_sha1(path, sha1_hash)):
        return path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".part"
    try:
        if url.startswith("file://"):
            shutil.copyfile(url[len("file://"):], tmp)
        elif os.path.exists(url):
            shutil.copyfile(url, tmp)
        else:
            last = None
            for attempt in range(max(1, retries)):
                try:
                    import ssl
                    ctx = None if verify_ssl \
                        else ssl._create_unverified_context()
                    with urllib.request.urlopen(url, context=ctx) as r, \
                            open(tmp, "wb") as f:
                        shutil.copyfileobj(r, f)
                    last = None
                    break
                except urllib.error.HTTPError as e:
                    if 400 <= e.code < 500:
                        raise MXNetError(
                            f"download failed for {url!r}: {e}") from e
                    last = e
                except (urllib.error.URLError, OSError) as e:
                    last = e
                if attempt + 1 < max(1, retries):
                    time.sleep(min(2 ** attempt, 8))
            if last is not None:
                raise MXNetError(f"download failed for {url!r}: {last}")
        if sha1_hash is not None and not check_sha1(tmp, sha1_hash):
            raise MXNetError(f"downloaded file {path} sha1 mismatch")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def shape_is_known(shape):
    """True if ``shape`` is fully known: no dimension 0 (the reference's
    unknown-dimension mark outside its numpy mode, which the port does not
    have), None or negative; a 0-dim shape is not known there."""
    if shape is None or len(shape) == 0:
        return False
    return all(d is not None and d > 0 for d in shape)
