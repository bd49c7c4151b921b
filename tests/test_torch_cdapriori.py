"""Count-distribution Apriori end to end: the port against the JAX
package, on the CPU.

Both packages mine the same bits, and runs are compared by each
package's registered ``cd_apriori`` digest (frequent itemsets with exact
counts, the CommLog with its ledgered device passes, the candidates per
level, the stream length).  Exact equality throughout: the tolerance is
zero.
"""

import numpy as np
import pytest

from repro.core import apriori as japr
from repro.core.cdapriori import cd_mine as jax_cd_mine
from repro.data import synthetic as jsyn
from repro.runtime import GridRuntime as JaxGridRuntime
from repro.workflow.registry import get_workload as jax_workload
from repro_torch.convert import transaction_dbs_from_reference
from repro_torch.core.apriori import bruteforce_frequent
from repro_torch.core.cdapriori import cd_mine
from repro_torch.core.fdm import fdm_mine
from repro_torch.kernels import ops
from repro_torch.runtime import GridRuntime
from repro_torch.workflow.registry import get_workload

N_ITEMS = 40
K, MINSUP = 3, 0.08


def _sites(n_sites=4, n_tx=1200, seed=1):
    dense = jsyn.ibm_transactions(seed=seed, n_tx=n_tx, n_items=N_ITEMS, avg_tx_len=6, n_patterns=8)
    jdbs = [japr.TransactionDB.from_dense(p) for p in jsyn.split_transactions(dense, n_sites, seed=0)]
    tdbs = transaction_dbs_from_reference([np.asarray(db.packed) for db in jdbs], N_ITEMS, "cpu")
    return dense, jdbs, tdbs


def _digest(result) -> dict:
    return get_workload("cd_apriori").digest(result)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_cd_mine_digest_matches(backend):
    _, jdbs, tdbs = _sites()
    want = jax_cd_mine(jdbs, K, MINSUP)
    ops.reset_launches()
    got = cd_mine(tdbs, K, MINSUP, backend=backend)
    assert _digest(got) == jax_workload("cd_apriori").digest(want)
    assert got.comm.count_calls == want.comm.count_calls
    assert all(v == 0 for v in ops.LAUNCHES.values())  # CPU tensors launch nothing


@pytest.mark.parametrize("count_backend", ["torch", "kernel"])
@pytest.mark.parametrize("schedule", ["staged", "async"])
@pytest.mark.parametrize("backend", ["inline", "batched"])
def test_runtime_cd_apriori_matches_jax(backend, schedule, count_backend):
    _, jdbs, tdbs = _sites()
    params = {"k": K, "minsup": MINSUP}
    jrun = JaxGridRuntime(count_backend="jnp", backend=backend, schedule=schedule).run("cd_apriori", jdbs, params)
    trun = GridRuntime(count_backend=count_backend, backend=backend, schedule=schedule, device="cpu").run(
        "cd_apriori", tdbs, params
    )
    assert _digest(trun.result) == jax_workload("cd_apriori").digest(jrun.result)
    assert trun.result.comm.count_calls == jrun.result.comm.count_calls
    assert (trun.backend, trun.schedule, trun.sync_mode) == (backend, schedule, "host")


def test_cd_apriori_matches_jax_kernel_backend():
    """Pallas in interpret mode against the port's wrappers on the CPU."""
    _, jdbs, tdbs = _sites(n_sites=2, n_tx=160)
    params = {"k": 2, "minsup": 0.2}
    jrun = JaxGridRuntime(count_backend="kernel").run("cd_apriori", jdbs, params)
    ops.reset_launches()
    trun = GridRuntime(device="cpu").run("cd_apriori", tdbs, params)
    assert _digest(trun.result) == jax_workload("cd_apriori").digest(jrun.result)
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_cd_frequent_equals_fdm_and_bruteforce():
    dense, _, tdbs = _sites()
    res = cd_mine(tdbs, K, MINSUP)
    assert res.frequent == fdm_mine(tdbs, K, MINSUP).frequent
    assert res.frequent == bruteforce_frequent(dense, K, int(np.ceil(MINSUP * dense.shape[0])))
    assert res.n_total_tx == dense.shape[0]


def test_count_calls_ledger_the_reference_passes():
    """The singleton seed pass once a site, then one pass a site at every
    level whose candidates the site had never counted, and one round a
    level moving the whole count vector."""
    _, jdbs, tdbs = _sites()
    res = cd_mine(tdbs, K, MINSUP)
    jres = jax_cd_mine(jdbs, K, MINSUP)
    s = len(tdbs)
    levels = sum(1 for c in res.per_level_candidates if c)
    assert res.comm.count_calls == s + s * (levels - 1) == jres.comm.count_calls
    assert res.comm.rounds == levels == jres.comm.rounds
    assert res.per_level_candidates == jres.per_level_candidates
