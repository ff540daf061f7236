"""The packed two-element arithmetic of K8's and K9's 16-bit instances
(``kernels/csrc/multi_tensor_common.cuh`` ``V2``).

There +, - and * are one packed bf16x2/f16x2 instruction each, rounding
the exact result once to the 16-bit type E, where the scalar path (and
the plain version, ``optimizer/cores.py``) computes the fp32 result and
rounds that to E.  The two agree because fp32's 24 bits are at least
2q + 2 for E's q = 8 (bf16) or 11 (fp16) bits (double rounding is then
innocuous, Figueroa 1995).  On the CPU this file checks that claim on
numbers (the exact result here is the fp64 one: a product of two 16-bit
values is exact in fp64, a sum is exact or rounded once more at 53 bits,
again innocuous) over every special value and many random pairs; on the
card (``cuda`` mark) ``fused.half_pair_check`` holds each packed
instruction, and the packed rounding of two floats, to the scalar path
over every one of the 2^32 cases."""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
# significand bits and least normal exponent of each 16-bit type
FORMAT = {"bfloat16": (8, -126), "float16": (11, -14)}
MAX = {"bfloat16": float(torch.finfo(torch.bfloat16).max),
       "float16": float(torch.finfo(torch.float16).max)}
OPS = {"add": np.add, "sub": np.subtract, "mul": np.multiply}


def _round_once(x, dtype):
    """fp64 ``x`` rounded to nearest even at ``dtype``'s precision and
    range, once, as fp64: the exact result's one rounding."""
    q, emin = FORMAT[dtype]
    with np.errstate(all="ignore"):
        _, e = np.frexp(x)                    # x = m 2^e, 0.5 <= |m| < 1
        e = np.maximum(e - 1, emin)           # the binade (subnormals: emin)
        ulp = np.ldexp(1.0, e - (q - 1))
        r = np.rint(x / ulp) * ulp            # rint: ties to even
        big = np.abs(r) > MAX[dtype]
        r = np.where(big, np.copysign(np.inf, x), r)
        return np.where(np.isfinite(x), r, x)


def _all_values(dtype):
    """Every value of the 16-bit type, as fp64 (NaNs dropped)."""
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    v = bits.view(DTYPES[dtype]).double().numpy()
    return v[~np.isnan(v)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", sorted(OPS))
def test_one_rounding_equals_fp32_then_16bit(op, dtype):
    """For 16-bit a, b: E(fp32(a op b)) == E(a op b), bit for bit, over
    every special pair (zeros, subnormal and normal extremes, infinities)
    and 2^21 random pairs of all the type's values."""
    vals = _all_values(dtype)
    fin = vals[np.isfinite(vals)]
    tiny = np.abs(fin[fin != 0]).min()
    edges = np.array([0.0, -0.0, np.inf, -np.inf, tiny, -tiny, 2 * tiny,
                      MAX[dtype], -MAX[dtype], 1.0, -1.0,
                      float(torch.finfo(DTYPES[dtype]).tiny)])
    rng = np.random.RandomState(7)
    a = np.concatenate([np.repeat(edges, len(edges)),
                        rng.choice(vals, 1 << 21)])
    b = np.concatenate([np.tile(edges, len(edges)),
                        rng.choice(vals, 1 << 21)])
    with np.errstate(all="ignore"):
        exact = OPS[op](a, b)                 # fp64
    want = torch.from_numpy(_round_once(exact, dtype)).to(DTYPES[dtype])
    ta = torch.from_numpy(a).float()
    tb = torch.from_numpy(b).float()
    got = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}[op](
        ta, tb).to(DTYPES[dtype])             # fp32, then E
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    zero = want == 0
    same &= ~zero | (torch.signbit(got) == torch.signbit(want))
    bad = (~same).nonzero().flatten()[:5].tolist()
    assert not bad, [(a[i], b[i], float(got[i]), float(want[i]))
                     for i in bad]


def test_the_model_rounds_as_torch_does():
    """``_round_once`` is the rounding torch's fp32 -> 16-bit conversion
    does, on every fp32 value of a random sample and the edges."""
    rng = np.random.RandomState(3)
    x = np.concatenate([rng.randn(1 << 18) * 10.0 ** rng.randint(
        -45, 39, 1 << 18), [0.0, -0.0, np.inf, -np.inf, 1e-45, 3e38]])
    with np.errstate(over="ignore"):          # beyond fp32: its Inf
        x = x.astype(np.float32).astype(np.float64)
    for dtype, dt in DTYPES.items():
        got = torch.from_numpy(x).float().to(dt).double().numpy()
        want = _round_once(x, dtype)
        assert np.array_equal(got, want, equal_nan=True), dtype


def test_pair_check_refuses_other_devices_and_types_by_name():
    from incubator_mxnet_tpu_torch.optimizer import fused
    with pytest.raises(MXNetError, match="no plain version"):
        fused.half_pair_check("add", torch.bfloat16, device="cpu")
    with pytest.raises(MXNetError, match="not a 16-bit type"):
        fused.half_pair_check("add", torch.float32, device="cpu")
    with pytest.raises(MXNetError, match="unknown op"):
        fused.half_pair_check("sqrt", torch.float16, device="cpu")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", ["add", "sub", "mul", "pack", "div"])
def test_cuda_packed_op_equals_the_scalar_path_everywhere(op, dtype):
    """Every one of the 2^32 cases of the packed instruction (both lanes)
    gives the scalar path's bits, or NaN where it gives NaN."""
    _need_cuda()
    from incubator_mxnet_tpu_torch.optimizer import fused
    n, first = fused.half_pair_check(op, DTYPES[dtype])
    assert n == 0, f"{n} cases differ, the first k = {first:#010x}"
