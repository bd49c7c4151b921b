"""The sharded train step of the five dense attention archs on a 4-rank
gloo group (data 2, model 2), held to the JAX package's single-device
step (``torch_sharded_train``)."""

import pytest

from torch_sharded_train import check, key_of, run_cases

CASES = [("phi-3-vision-4.2b", 0), ("phi3-mini-3.8b", 0), ("granite-20b", 0), ("stablelm-1.6b", 0), ("gemma2-2b", 0),
         ("stablelm-1.6b", 0, 2)]  # the last with grad_accum 2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: key_of(*c))
def test_sharded_train_step_matches_jax(case, results):
    check(*results[key_of(*case)])
