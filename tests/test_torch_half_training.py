"""The port's 16-bit training in ``SPMDTrainer`` and ``CompiledLoop``
(``incubator_mxnet_tpu_torch/parallel``, ``optimizer/``), bf16, against
the JAX package on the CPU: for each of the seven rules, the dtype of
every value and state leaf after each of 3 steps (the census), the
losses and values, and whether the compiled loop runs or raises.  The
reference, the port's runs and the tolerances (with their reasons) are
in ``torch_half_training.py``; ``test_torch_half_training_fp16.py`` does
the same in fp16."""
import pytest

import torch_half_training as H

DTYPE = "bfloat16"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return H.reference(tmp_path_factory, DTYPE)


@pytest.mark.parametrize("tag,rule,kw", H.RULES, ids=[r[0] for r in H.RULES])
def test_spmd_census_matches_jax(ref, tag, rule, kw):
    """sgd, nag, rmsprop and adagrad keep the cast net's dtype; adam,
    adamw and lamb write fp32 values and keep bf16 moments at step 1,
    and everything is fp32 from step 2, as in the JAX step."""
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
