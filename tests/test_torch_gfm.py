"""GFM end to end: the port against the JAX package, on the CPU.

Both packages mine the same bits (the JAX DBs' words handed over through
``repro_torch.convert``), and the runs are compared by each package's
registered ``gfm`` digest (frequent itemsets with exact counts, the
CommLog, pool sizes) and by the JAX conformance harness's scheduling
fingerprint under fixed placement.  Exact equality throughout.
"""

import numpy as np
import pytest

from repro.core import apriori as japr
from repro.core.gfm import gfm_mine as jax_gfm_mine
from repro.data import synthetic as jsyn
from repro.runtime import GridRuntime as JaxGridRuntime
from repro.runtime.conformance import schedule_fingerprint
from repro.workflow.registry import get_workload as jax_workload
from repro_torch.convert import transaction_dbs_from_reference
from repro_torch.core.gfm import gfm_mine
from repro_torch.kernels import ops
from repro_torch.runtime import GridRuntime
from repro_torch.workflow.registry import get_workload

N_ITEMS = 40  # W=2: item 31 sets the sign bit of word 0


def _sites(n_sites=4, n_tx=800, seed=2):
    dense = jsyn.ibm_transactions(seed=seed, n_tx=n_tx, n_items=N_ITEMS, avg_tx_len=6, n_patterns=8)
    jdbs = [japr.TransactionDB.from_dense(p) for p in jsyn.split_transactions(dense, n_sites, seed=0)]
    tdbs = transaction_dbs_from_reference([np.asarray(db.packed) for db in jdbs], N_ITEMS, "cpu")
    return jdbs, tdbs


def _digest(run_result) -> dict:
    return get_workload("gfm").digest(run_result)


@pytest.mark.parametrize("local_minsup", [None, 0.30])
def test_gfm_mine_digest_matches(local_minsup):
    jdbs, tdbs = _sites()
    want = jax_gfm_mine(jdbs, 3, 0.08, local_minsup=local_minsup)
    got = gfm_mine(tdbs, 3, 0.08, backend="torch", local_minsup=local_minsup)
    assert _digest(got) == jax_workload("gfm").digest(want)
    assert got.comm.rounds == 2


@pytest.mark.parametrize("local_minsup", [None, 0.30])
@pytest.mark.parametrize("schedule", ["staged", "async"])
@pytest.mark.parametrize("backend", ["inline", "batched"])
def test_runtime_gfm_matches_jax(backend, schedule, local_minsup):
    jdbs, tdbs = _sites()
    params = {"k": 3, "minsup": 0.08, "local_minsup": local_minsup}
    jrun = JaxGridRuntime(count_backend="jnp", backend=backend, schedule=schedule).run(
        "gfm", jdbs, params
    )
    trun = GridRuntime(count_backend="torch", backend=backend, schedule=schedule, device="cpu").run(
        "gfm", tdbs, params
    )
    assert _digest(trun.result) == jax_workload("gfm").digest(jrun.result)
    assert schedule_fingerprint(trun.report) == schedule_fingerprint(jrun.report)
    assert (trun.backend, trun.schedule, trun.placement) == (backend, schedule, "fixed")
    assert set(trun.measured) == set(trun.report.job_times)


@pytest.mark.parametrize("backend", ["inline", "batched"])
def test_kernel_backend_matches_jax_kernel(backend):
    """The count_backend="kernel" route on both sides: Pallas in interpret
    mode against the port's wrappers, which run the plain versions on the
    CPU and launch nothing."""
    jdbs, tdbs = _sites(n_sites=2, n_tx=120)
    params = {"k": 2, "minsup": 0.2}
    jrun = JaxGridRuntime(count_backend="kernel", backend=backend).run("gfm", jdbs, params)
    ops.reset_launches()
    trun = GridRuntime(backend=backend, device="cpu").run("gfm", tdbs, params)
    assert _digest(trun.result) == jax_workload("gfm").digest(jrun.result)
    assert schedule_fingerprint(trun.report) == schedule_fingerprint(jrun.report)
    assert all(v == 0 for v in ops.LAUNCHES.values())


def _descent_state(local_cls, n_sites):
    """A hand-built state from which the top-down descent must count: two
    failed triples whose pairs are undecided, and per-site caches that
    already hold a few of those pairs' counts (so some sites count more
    than others).  Every pair fails g_min below, so the descent goes on to
    the singletons: two counting rounds."""
    decided = {(0, 1, 2): (0, False), (2, 31, 32): (0, False), (5, 6): (3, True)}
    known = [{(0, 1): 7}, {}, {(0, 1): 2, (31, 32): 0}, {(2, 31): 1}][:n_sites]
    local = [
        local_cls(counts=dict(c), frequent={}, count_calls=0, candidates_counted=0) for c in known
    ]
    return decided, local


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_topdown_search_counting_branch_matches_jax(backend):
    """The descent's counting rounds, which GFM's own runs never reach (its
    pool is downward-closed): decided counts, CommLog and pool sizes equal
    the JAX package's from the same state."""
    from repro.core import gfm as jgfm
    from repro_torch.core import apriori as tapr
    from repro_torch.core import gfm as tgfm
    from repro_torch.workflow.registry import comm_digest

    jdbs, tdbs = _sites(n_sites=4, n_tx=400)
    g_min = 10_000  # nothing passes
    jdecided, jlocal = _descent_state(japr.LocalMineResult, 4)
    tdecided, tlocal = _descent_state(tapr.LocalMineResult, 4)
    jcomm, tcomm = jgfm.CommLog(), tgfm.CommLog()
    jsizes, tsizes = [9], [9]
    jgfm.topdown_search(jdbs, jlocal, jdecided, g_min, jcomm, 3, "jnp", jsizes)
    ops.reset_launches()
    tgfm.topdown_search(tdbs, tlocal, tdecided, g_min, tcomm, 3, backend, tsizes)
    assert tdecided == jdecided
    assert comm_digest(tcomm) == comm_digest(jcomm)
    assert tsizes == jsizes
    assert [lm.counts for lm in tlocal] == [lm.counts for lm in jlocal]
    assert tcomm.rounds == 2 and tsizes[1:] == [6, 5]  # 6 pairs, then 5 singletons
    assert all(v == 0 for v in ops.LAUNCHES.values())  # CPU tensors launch nothing


def test_run_gfm_wrapper():
    _, tdbs = _sites()
    rt = GridRuntime(count_backend="torch", device="cpu")
    a = rt.run_gfm(tdbs, 3, 0.08)
    b = rt.run("gfm", tdbs, {"k": 3, "minsup": 0.08})
    assert _digest(a.result) == _digest(b.result)
    assert a.sync_mode == "host" and a.backend == "batched"
    assert a.estimated_s > 0 and a.estimated_staged_s > 0


@pytest.mark.parametrize("schedule", ["staged", "async"])
def test_multihost_backend_runs_gfm_as_inline(schedule):
    """With no process group the multihost backend runs every job here:
    the same digest and fingerprint as inline, no partition."""
    _, tdbs = _sites()
    params = {"k": 3, "minsup": 0.08}
    got = GridRuntime(count_backend="torch", backend="multihost", schedule=schedule, device="cpu").run(
        "gfm", tdbs, params
    )
    want = GridRuntime(count_backend="torch", backend="inline", schedule=schedule, device="cpu").run(
        "gfm", tdbs, params
    )
    assert _digest(got.result) == _digest(want.result)
    assert schedule_fingerprint(got.report) == schedule_fingerprint(want.report)
    assert got.backend == "multihost" and got.n_processes == 1 and got.owned_sites is None
    assert set(got.measured) == set(got.report.job_times)


def test_registry_is_fully_specified():
    from repro_torch.workflow.registry import app_names, validate_registry

    assert validate_registry() == []
    assert app_names() == ("apriori", "gfm", "fdm", "cd_apriori", "topk", "kmeans", "vclustering")


@pytest.mark.parametrize("key", ["n_sites", "split_seed", "block"])
def test_gfm_rejects_params_it_does_not_read(key):
    _, tdbs = _sites(n_sites=2, n_tx=120)
    with pytest.raises(ValueError, match="known params"):
        GridRuntime(device="cpu").run("gfm", tdbs, {"k": 2, "minsup": 0.2, key: 3})
