"""The support count past 32 words (1,024 items): the port against the JAX
package on the CPU, through the wrappers and through GFM end to end.

The JAX package counts any W (``tests/test_kernels.py``'s
``test_wide_item_universe``: seed 3, 200 x 1,100 items, so W = 35); the
port's wrappers take the plain version on the CPU and the wide CUDA path
on the card (``tests/test_torch_guards.py`` holds that one to the plain
version).  Exact equality throughout.
"""

import numpy as np
import pytest

from repro.core import apriori as japr
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.runtime import GridRuntime as JaxGridRuntime
from repro.workflow.registry import get_workload as jax_workload
from repro_torch.convert import transaction_dbs_from_reference
from repro_torch.core.apriori import TransactionDB
from repro_torch.kernels import ops
from repro_torch.runtime import GridRuntime
from repro_torch.workflow.registry import get_workload

N_ITEMS = 1100  # W = 35


def _wide_inputs():
    """``test_wide_item_universe``'s draws: 200 rows of 1,100 items at
    density 0.1 and 40 random pairs."""
    rng = np.random.default_rng(3)
    dense = rng.random((200, N_ITEMS)) < 0.1
    sets = [tuple(sorted(rng.choice(N_ITEMS, size=2, replace=False).tolist())) for _ in range(40)]
    return dense, sets


@pytest.mark.parametrize("wrapper", ["support_count", "support_count_prune", "support_count_sites",
                                     "support_count_prune_sites"])
def test_wide_item_universe_wrappers(wrapper):
    """Every support-count wrapper at W = 35 equals the JAX package's
    ``ops.support_count`` and a direct count of the dense rows."""
    import jax.numpy as jnp

    dense, sets = _wide_inputs()
    jtx = japr.pack_bool_matrix(dense)
    jmasks = japr.pack_itemsets(sets, N_ITEMS)
    want = np.asarray(jops.support_count(jnp.asarray(jtx), jnp.asarray(jmasks)))
    direct = np.array([dense[:, list(s)].all(axis=1).sum() for s in sets])
    np.testing.assert_array_equal(want, direct)
    tx = transaction_dbs_from_reference([np.asarray(jtx)], N_ITEMS, "cpu")[0].packed
    masks = transaction_dbs_from_reference([np.asarray(jmasks)], N_ITEMS, "cpu")[0].packed
    assert tuple(tx.shape) == (200, 35)
    min_count = 3
    if wrapper == "support_count":
        got = ops.support_count(tx, masks)
    elif wrapper == "support_count_prune":
        got, flags = ops.support_count_prune(tx, masks, min_count)
        np.testing.assert_array_equal(flags.numpy(), want >= min_count)
    elif wrapper == "support_count_sites":
        got = ops.support_count_sites(tx[None], masks[None])[0]
    else:
        got, flags = ops.support_count_prune_sites(tx[None], masks[None], [min_count])
        got = got[0]
        np.testing.assert_array_equal(flags[0].numpy(), want >= min_count)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", ["inline", "batched"])
def test_wide_item_universe_gfm_digest(backend):
    """GFM over 1,100 items (W = 35) on 3 sites through
    ``GridRuntime(device="cpu").run("gfm")`` with the kernel count backend,
    against the JAX package's run on the same bits: the registered
    digests are equal."""
    dense = jsyn.ibm_transactions(seed=4, n_tx=600, n_items=N_ITEMS, avg_tx_len=8, n_patterns=6)
    jdbs = [japr.TransactionDB.from_dense(p) for p in jsyn.split_transactions(dense, 3, seed=0)]
    tdbs = transaction_dbs_from_reference([np.asarray(db.packed) for db in jdbs], N_ITEMS, "cpu")
    assert all(isinstance(db, TransactionDB) and db.packed.shape[1] == 35 for db in tdbs)
    params = {"k": 3, "minsup": 0.05}
    jrun = JaxGridRuntime(count_backend="jnp", backend=backend).run("gfm", jdbs, params)
    ops.reset_launches()
    trun = GridRuntime(backend=backend, device="cpu").run("gfm", tdbs, params)
    want = jax_workload("gfm").digest(jrun.result)
    assert get_workload("gfm").digest(trun.result) == want
    assert len(trun.result.frequent) > 30 and any(len(its) >= 2 for its in trun.result.frequent)
    assert max(i for its in trun.result.frequent for i in its) >= 1024  # items past the first 32 words
    assert all(v == 0 for v in ops.LAUNCHES.values())
