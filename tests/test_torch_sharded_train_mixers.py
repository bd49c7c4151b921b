"""The sharded train step of the recurrent and encoder-decoder archs (Mamba-2 with the shared block, mLSTM and sLSTM, seamless) on a 4-rank
gloo group (data 2, model 2), held to the JAX package's single-device
step (``torch_sharded_train``)."""

import pytest

from torch_sharded_train import check, key_of, run_cases

CASES = [("zamba2-1.2b", 0), ("xlstm-1.3b", 0), ("seamless-m4t-large-v2", 0)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: key_of(*c))
def test_sharded_train_step_matches_jax(case, results):
    check(*results[key_of(*case)])
