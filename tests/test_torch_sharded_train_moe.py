"""The sharded train step of the MoE archs, each in both dispatch forms
(groups 0: global, 2: local), and each form once more at grad_accum 2, on
a 4-rank gloo group (data 2, model 2), held to the JAX package's
single-device step (``torch_sharded_train``)."""

import pytest

from torch_sharded_train import check, key_of, run_cases

CASES = [("mixtral-8x22b", 0), ("mixtral-8x22b", 2), ("deepseek-moe-16b", 0), ("deepseek-moe-16b", 2),
         ("mixtral-8x22b", 0, 2), ("deepseek-moe-16b", 2, 2)]  # the last two with grad_accum 2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: key_of(*c))
def test_sharded_train_step_matches_jax(case, results):
    check(*results[key_of(*case)])
