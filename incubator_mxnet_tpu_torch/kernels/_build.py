"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  All sources compile in
parallel, one ``nvcc`` each, at first use; the libraries land in
``build/kernels/`` at the repository root, named by a digest of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  Nothing here runs at import time."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

from ..base import MXNetError

__all__ = ["KERNELS", "ARGTYPES", "HEADERS", "build_all", "library",
           "build_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# every header a source includes: they feed each library's digest
HEADERS = ("common.cuh", "decode_common.cuh", "flash_bwd_common.cuh",
           "tf32_mma.cuh")
# kernel name -> source file
KERNELS = {"flash_fwd": "flash_fwd.cu",
           "paged_decode": "paged_decode.cu",
           "decode": "decode.cu",
           "paged_verify": "paged_verify.cu",
           "verify": "verify.cu",
           "flash_bwd_dq": "flash_bwd_dq.cu",
           "flash_bwd_dkv": "flash_bwd_dkv.cu",
           "multi_tensor_adam": "multi_tensor_adam.cu"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each kernel's C entry point ``mx_<name>``: its arguments in order, the
# last being the stream
ARGTYPES = {
    "flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "paged_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                     _P],
    "decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "paged_verify": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _F, _P],
    "verify": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                     _P],
    "flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _F, _I, _P],
    "multi_tensor_adam": [_P, _I, _P, _F, _F, _F, _F, _F, _F, _F, _F, _I,
                          _P, _P],
    "all_finite": [_P, _I, _P, _P],
}
# the C entry points of each kernel's library: its own, and beside K8 the
# skip_nonfinite guard's all-finite check over the same leaf table
ENTRIES = {name: (name,) for name in KERNELS}
ENTRIES["multi_tensor_adam"] += ("all_finite",)
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time or 0.0 when reused, "ptxas": [lines]}
build_report: Dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                         "cannot be built on this machine")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in (KERNELS[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every kernel whose library is missing, all at once; raise
    :class:`MXNetError` with the compiler's output if one fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for name in KERNELS:
            if name in build_report:
                continue
            out = _target(name)
            if out.exists():
                build_report[name] = {"seconds": 0.0, "ptxas": []}
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, out, tmp, proc, time.monotonic()))
        failed = []
        for name, out, tmp, proc, t0 in jobs:
            text, _ = proc.communicate()
            secs = time.monotonic() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
                continue
            os.replace(tmp, out)
            lines: List[str] = [ln.strip() for ln in text.splitlines()
                                if "registers" in ln or "spill" in ln
                                or "entry function" in ln]
            build_report[name] = {"seconds": secs, "ptxas": lines}
        if failed:
            raise MXNetError("CUDA kernel build failed:\n" + "\n".join(failed))
        return dict(build_report)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first
    if needed.  Declares ``argtypes``/``restype`` of its C entry points."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            _declare(name, lib)
            _libs[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    lib.mx_error_string.argtypes = [ctypes.c_int]
    lib.mx_error_string.restype = ctypes.c_char_p
    for entry in ENTRIES[name]:
        fn = getattr(lib, "mx_" + entry)
        fn.argtypes = ARGTYPES[entry]
        fn.restype = ctypes.c_int
