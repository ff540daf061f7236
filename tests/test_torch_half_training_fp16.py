"""The port's 16-bit training in ``SPMDTrainer`` and ``CompiledLoop``
(``incubator_mxnet_tpu_torch/parallel``, ``optimizer/``), fp16, against
the JAX package on the CPU: for each of the seven rules, the dtype of
every value and state leaf after each of 3 steps (the census), the
losses and values, and whether the compiled loop runs or raises; the
rules whose step promotes a fp16 net (adam, adamw, lamb) are refused.  The
reference, the port's runs and the tolerances (with their reasons) are
in ``torch_half_training.py``; ``test_torch_half_training.py`` does the
same in bf16."""
import pytest

import torch_half_training as H

DTYPE = "float16"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return H.reference(tmp_path_factory, DTYPE)


@pytest.mark.parametrize("tag,rule,kw", H.RULES, ids=[r[0] for r in H.RULES])
def test_spmd_census_matches_jax(ref, tag, rule, kw):
    """sgd, nag, rmsprop and adagrad keep the cast net's dtype, as in the
    JAX step; adam, adamw and lamb, whose JAX step writes fp32 values at
    step 1, are refused there (``torch_half_training.py``)."""
    meta, data = ref
    H.check_census(meta, DTYPE, tag, rule, kw, data)


@pytest.mark.parametrize("tag,rule,kw", H.RULES, ids=[r[0] for r in H.RULES])
def test_spmd_values_match_jax(ref, tag, rule, kw):
    meta, data = ref
    H.check_values(meta, DTYPE, tag, rule, kw, data)


@pytest.mark.parametrize("tag,rule,kw", H.RULES, ids=[r[0] for r in H.RULES])
def test_compiled_loop_runs_or_raises_where_jax_does(ref, tag, rule, kw):
    meta, data = ref
    H.check_loop(meta, DTYPE, tag, rule, kw, data)
