"""Launch counting of the attention kernels (``kernels/flash_attention.py``
``_launch``/``launched``) on the CPU, through a stand-in for a kernel's
``ctypes`` library: K2-K5 count what their entry point reports through
its ``launches`` out-argument (the split and the merge: two per call), K1,
K6 and K7 one per call, a failed launch nothing; the plain versions
count nothing.  The FLOPs the attention kernels report for the MFU
collector (``counted_flops``) follow the same calls."""
import contextlib
import ctypes
import importlib

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.kernels import _build

tfa = importlib.import_module(
    "incubator_mxnet_tpu_torch.kernels.flash_attention")

#: launches per call each split kernel's entry point makes (the split
#: over 64-key chunks and the merge, ``decode_common.cuh`` ``launch_d``)
SPLIT_LAUNCHES = 2


class _FakeLib:
    """Each ``mx_<name>`` entry adds ``SPLIT_LAUNCHES`` to its launches
    out-argument (when it takes one) and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __getattr__(self, entry):
        name = entry[len("mx_"):]

        def fn(*args):
            assert len(args) == len(_build.ARGTYPES[name]), name
            self.calls.append(name)
            if name in tfa.SPLIT_KERNELS and self.rc == 0:
                ctypes.c_int.from_address(args[-2]).value += SPLIT_LAUNCHES
            return self.rc
        return fn

    @staticmethod
    def mx_error_string(rc):
        return b"injected"


class _Stream:
    cuda_stream = 0


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    tfa.reset_launch_counts()
    yield lib
    tfa.reset_launch_counts()


def _args(name):
    """CPU stand-ins for ``name``'s arguments before the stream (the
    tensors' addresses are never dereferenced)."""
    t = torch.zeros(4)
    n = len(_build.ARGTYPES[name]) - 1 - (name in tfa.SPLIT_KERNELS)
    return [t if ty is ctypes.c_void_p else (1.0 if ty is ctypes.c_float
                                              else 1)
            for ty in _build.ARGTYPES[name][:n]]


@pytest.mark.parametrize("name", ["paged_decode", "decode", "paged_verify",
                                  "verify"])
def test_split_kernels_count_both_launches(fake, name):
    tfa._launch(name, *_args(name))
    tfa._launch(name, *_args(name))
    assert tfa.launch_counts[name] == 2 * SPLIT_LAUNCHES
    assert sum(tfa.launch_counts.values()) == 2 * SPLIT_LAUNCHES


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"])
def test_one_launch_kernels_count_one_per_call(fake, name):
    tfa._launch(name, *_args(name))
    assert tfa.launch_counts[name] == 1


def test_a_failed_launch_raises_and_counts_nothing(fake):
    fake.rc = 7
    with pytest.raises(MXNetError, match="decode kernel launch failed"):
        tfa._launch("decode", *_args("decode"))
    assert sum(tfa.launch_counts.values()) == 0


def test_a_captured_call_goes_to_the_capture_tally(fake):
    with tfa.captured_launches() as tally:
        tfa._launch("paged_verify", *_args("paged_verify"))
    assert tally == {"paged_verify": SPLIT_LAUNCHES}
    assert sum(tfa.launch_counts.values()) == 0
    tfa.add_launches(tally)
    assert tfa.launch_counts["paged_verify"] == SPLIT_LAUNCHES


def test_plain_versions_count_no_launch_and_no_kernel_flops():
    """On CPU tensors the entry points run their plain versions: no launch
    is counted and no kernel FLOPs are reported (``FlopCounterMode`` sees
    the plain versions' own products)."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 2, 16, 16).astype(np.float32))
    tfa.reset_launch_counts()
    with tfa.counted_flops() as flops:
        tfa.flash_attention(q, q, q, causal=True)
        S, H, T, D = 2, 2, 32, 16
        k = torch.from_numpy(rng.randn(S, H, T, D).astype(np.float32))
        tfa.decode_attention(k[:, :, 0], k, k,
                             torch.tensor([3, 31], dtype=torch.int32))
    assert sum(tfa.launch_counts.values()) == 0 and flops[0] == 0.0


def test_attention_kernels_report_their_flops(fake, monkeypatch):
    """K1 reports 4·BH·T²·D (halved when causal); K6 + K7 2.5 times
    that, counted once per backward call."""
    BH, T, D = 4, 8, 16
    q = torch.zeros(BH, T, D)
    lse = torch.zeros(BH, T)
    # CPU stand-ins pass the wrappers' device checks
    monkeypatch.setattr(tfa, "_attn_checks", lambda *a, **k: None)
    with tfa.counted_flops() as flops:
        tfa._flash_fwd_cuda(q, q, q, None, 0.25, False, 2)
    assert flops[0] == 4.0 * BH * T * T * D
    with tfa.counted_flops() as flops:
        tfa._flash_fwd_cuda(q, q, q, None, 0.25, True, 2)
        tfa._flash_bwd_cuda(q, q, q, None, q, lse, lse, 0.25, True, 2)
    assert flops[0] == 3.5 * 0.5 * 4.0 * BH * T * T * D
    assert fake.calls == ["flash_fwd", "flash_fwd", "flash_bwd_dq",
                          "flash_bwd_dkv"]
