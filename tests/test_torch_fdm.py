"""FDM (the paper's comparison point) end to end: the port against the JAX
package, on the CPU.

Both packages mine the same bits (the JAX DBs' words handed over through
``repro_torch.convert``), and runs are compared by each package's
registered ``fdm`` digest (frequent itemsets with exact counts, the
CommLog, the candidates per level).  Exact equality throughout: the
tolerance is zero.
"""

import numpy as np
import pytest

from repro.core import apriori as japr
from repro.core.fdm import fdm_mine as jax_fdm_mine
from repro.data import synthetic as jsyn
from repro.runtime import GridRuntime as JaxGridRuntime
from repro.workflow.registry import get_workload as jax_workload
from repro_torch.convert import transaction_dbs_from_reference
from repro_torch.core.apriori import bruteforce_frequent
from repro_torch.core.fdm import fdm_mine
from repro_torch.core.gfm import gfm_mine
from repro_torch.kernels import ops
from repro_torch.runtime import GridRuntime
from repro_torch.workflow.registry import get_workload

N_ITEMS = 40  # W=2: item 31 sets the sign bit of word 0
K, MINSUP = 3, 0.08


def _sites(n_sites=4, n_tx=1200, seed=1):
    dense = jsyn.ibm_transactions(seed=seed, n_tx=n_tx, n_items=N_ITEMS, avg_tx_len=6, n_patterns=8)
    jdbs = [japr.TransactionDB.from_dense(p) for p in jsyn.split_transactions(dense, n_sites, seed=0)]
    tdbs = transaction_dbs_from_reference([np.asarray(db.packed) for db in jdbs], N_ITEMS, "cpu")
    return dense, jdbs, tdbs


def _digest(result) -> dict:
    return get_workload("fdm").digest(result)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_fdm_mine_digest_matches(backend):
    _, jdbs, tdbs = _sites()
    want = jax_workload("fdm").digest(jax_fdm_mine(jdbs, K, MINSUP))
    ops.reset_launches()
    got = fdm_mine(tdbs, K, MINSUP, backend=backend)
    assert _digest(got) == want
    assert got.comm.rounds == K
    assert all(v == 0 for v in ops.LAUNCHES.values())  # CPU tensors launch nothing


@pytest.mark.parametrize("count_backend", ["torch", "kernel"])
@pytest.mark.parametrize("schedule", ["staged", "async"])
@pytest.mark.parametrize("backend", ["inline", "batched"])
def test_runtime_fdm_matches_jax(backend, schedule, count_backend):
    _, jdbs, tdbs = _sites()
    params = {"k": K, "minsup": MINSUP}
    jrun = JaxGridRuntime(count_backend="jnp", backend=backend, schedule=schedule).run("fdm", jdbs, params)
    trun = GridRuntime(count_backend=count_backend, backend=backend, schedule=schedule, device="cpu").run(
        "fdm", tdbs, params
    )
    assert _digest(trun.result) == jax_workload("fdm").digest(jrun.result)
    assert (trun.backend, trun.schedule, trun.sync_mode) == (backend, schedule, "host")
    assert set(trun.measured) == set(trun.report.job_times)
    assert trun.result.total_count_time >= trun.result.remote_count_time > 0.0


def test_run_fdm_matches_jax_kernel_backend():
    """The count_backend="kernel" route on both sides: Pallas in interpret
    mode against the port's wrappers, which run the plain versions on the
    CPU and launch nothing."""
    _, jdbs, tdbs = _sites(n_sites=2, n_tx=160)
    jrun = JaxGridRuntime(count_backend="kernel").run_fdm(jdbs, 2, 0.2)
    ops.reset_launches()
    trun = GridRuntime(device="cpu").run_fdm(tdbs, 2, 0.2)
    assert _digest(trun.result) == jax_workload("fdm").digest(jrun.result)
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_fdm_frequent_equals_bruteforce_and_gfm():
    dense, _, tdbs = _sites()
    res = fdm_mine(tdbs, K, MINSUP)
    want = bruteforce_frequent(dense, K, int(np.ceil(MINSUP * dense.shape[0])))
    assert res.frequent == want
    assert res.frequent == gfm_mine(tdbs, K, MINSUP).frequent
    assert max(len(its) for its in want) == K  # the search reaches level k


def test_remote_support_rounds_are_ledgered_as_in_the_reference():
    """FDM's remote-support computation runs (sites count candidates that
    their own pruning dropped), and its passes and payload land in the
    CommLog exactly as the reference ledgers them: one round a level, the
    count passes and the remote passes each counted once a site."""
    from repro_torch.core import fdm as tfdm

    _, jdbs, tdbs = _sites()
    calls = []
    real = tfdm.count_supports

    def spy(db, itemsets, backend="torch"):
        calls.append(len(itemsets))
        return real(db, itemsets, backend=backend)

    tfdm.count_supports = spy
    try:
        res = fdm_mine(tdbs, K, MINSUP)
    finally:
        tfdm.count_supports = real
    jres = jax_fdm_mine(jdbs, K, MINSUP)
    s = len(tdbs)
    levels = sum(1 for c in res.per_level_candidates if c)
    # level 1 counts singletons without count_supports; every later level
    # counts each site's own candidates, then the remote requests
    n_remote = len(calls) - s * (levels - 1)
    assert n_remote > 0 and res.remote_count_time > 0.0
    assert res.comm.count_calls == s * levels + n_remote == jres.comm.count_calls
    assert res.comm.rounds == jres.comm.rounds == levels
    assert res.comm.per_round_bytes == jres.comm.per_round_bytes
