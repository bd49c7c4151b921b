"""The port's data generator and Apriori substrate against the JAX package.

The same seeded inputs go through ``repro.core.apriori`` (``backend="jnp"``)
and ``repro_torch.core.apriori`` on the CPU, with both of the port's count
backends (``"kernel"``, whose wrappers run the plain versions on the CPU,
and ``"torch"``).  Every result is an integer count, a flag or an
itemset list, so the tolerance is exact equality.
"""

import numpy as np
import pytest

from repro.core import apriori as japr
from repro.data import synthetic as jsyn
from repro_torch.convert import transaction_dbs_from_reference
from repro_torch.core import apriori as tapr
from repro_torch.data import synthetic as tsyn

BACKENDS = ("torch", "kernel")


def _dense(seed=2, n_tx=600, n_items=40):
    return jsyn.ibm_transactions(seed=seed, n_tx=n_tx, n_items=n_items, avg_tx_len=6, n_patterns=8)


def _pair_sites(n_sites=4, seed=2, n_items=40, n_tx=600):
    """The same shards as JAX DBs and as the port's CPU DBs."""
    parts = jsyn.split_transactions(_dense(seed, n_tx, n_items), n_sites, seed=0)
    jdbs = [japr.TransactionDB.from_dense(p) for p in parts]
    tdbs = transaction_dbs_from_reference([np.asarray(db.packed) for db in jdbs], n_items, "cpu")
    return jdbs, tdbs


def _same_local(a, b):
    assert a.counts == b.counts
    assert a.frequent == b.frequent
    assert a.count_calls == b.count_calls
    assert a.candidates_counted == b.candidates_counted


@pytest.mark.parametrize("seed,n_tx,n_items", [(0, 300, 1000), (3, 500, 40), (7, 64, 33)])
def test_synthetic_arrays_are_byte_identical(seed, n_tx, n_items):
    a = jsyn.ibm_transactions(seed=seed, n_tx=n_tx, n_items=n_items)
    b = tsyn.ibm_transactions(seed=seed, n_tx=n_tx, n_items=n_items)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for pa, pb in zip(jsyn.split_transactions(a, 4, seed=seed), tsyn.split_transactions(b, 4, seed=seed)):
        assert pa.tobytes() == pb.tobytes()


def test_packing_is_byte_identical():
    dense = _dense(n_items=70)
    assert tapr.pack_bool_matrix(dense).tobytes() == japr.pack_bool_matrix(dense).tobytes()
    its = [(0,), (31,), (32, 63), (5, 31, 69)]
    assert tapr.pack_itemsets(its, 70).tobytes() == japr.pack_itemsets(its, 70).tobytes()


def test_from_dense_matches_the_reference_words():
    dense = _dense(n_items=40)
    db = tapr.TransactionDB.from_dense(dense, device="cpu")
    want = np.asarray(japr.TransactionDB.from_dense(dense).packed)
    assert db.packed.numpy().view(np.uint32).tobytes() == want.tobytes()
    assert (db.n_items, db.n_tx) == (40, 600)


def test_item_supports_with_sign_bit():
    """Item 31 is bit 31, which makes the int32 words negative."""
    jdbs, tdbs = _pair_sites(n_items=40)
    for jdb, tdb in zip(jdbs, tdbs):
        np.testing.assert_array_equal(tapr.item_supports(tdb), japr.item_supports(jdb))


@pytest.mark.parametrize("backend", BACKENDS)
def test_count_supports_matches(backend):
    jdbs, tdbs = _pair_sites()
    its = [(0,), (1, 2), (31, 32), (3, 5, 7), (), (39,)]
    for jdb, tdb in zip(jdbs, tdbs):
        want = japr.count_supports(jdb, its)
        got = tapr.count_supports(tdb, its, backend=backend)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        gc, gf = tapr.count_supports_prune(tdb, its, 20, backend=backend)
        wc, wf = japr.count_supports_prune(jdb, its, 20)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gf, wf)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("min_count", [8, 30])
def test_local_apriori_matches(backend, min_count):
    jdbs, tdbs = _pair_sites()
    for jdb, tdb in zip(jdbs, tdbs):
        _same_local(
            tapr.local_apriori(tdb, 3, min_count, backend=backend),
            japr.local_apriori(jdb, 3, min_count),
        )


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_local_apriori_matches(backend):
    jdbs, tdbs = _pair_sites()
    mins = [8, 12, 30, 150]  # unequal per site; the last site exhausts early
    got = tapr.batched_local_apriori(tdbs, 3, mins, backend=backend)
    want = japr.batched_local_apriori(jdbs, 3, mins)
    for a, b in zip(got, want):
        _same_local(a, b)
    for a, tdb, m in zip(got, tdbs, mins):
        _same_local(a, tapr.local_apriori(tdb, 3, m, backend=backend))


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_sites_match(backend):
    jdbs, tdbs = _pair_sites()
    lists = [[(0, 1), (2,), (31, 32)], [], [(5,), (1, 2, 3)], [(39,), (0,), (4, 6), (7, 8)]]
    got = tapr.fused_count_sites(tdbs, lists, backend=backend)
    want = japr.fused_count_sites(jdbs, lists)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    mins = [40, 1, 60, 10]
    got = tapr.fused_prune_sites(tdbs, lists, mins, backend=backend)
    want = japr.fused_prune_sites(jdbs, lists, mins)
    for (ac, af), (bc, bf) in zip(got, want):
        np.testing.assert_array_equal(ac, bc)
        np.testing.assert_array_equal(af, bf)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_sites_with_mixed_universes_fall_back(backend):
    """Sites over different item universes (W=1 and W=2) cannot share a
    mask layout; the per-site loop gives the same counts."""
    j1, t1 = _pair_sites(n_sites=2, n_items=20)
    j2, t2 = _pair_sites(n_sites=2, n_items=40)
    lists = [[(0, 1)], [(2, 3)], [(31, 35)], [(4,)]]
    got = tapr.fused_count_sites(t1 + t2, lists, backend=backend)
    want = japr.fused_count_sites(j1 + j2, lists)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_join_and_subsets_match():
    prev = [(0, 1), (0, 2), (1, 2), (1, 3), (2, 3), (0, 3)]
    assert tapr.apriori_join(prev) == japr.apriori_join(prev)
    assert tapr.subsets_of((1, 4, 9)) == japr.subsets_of((1, 4, 9))


def test_unknown_backend_is_rejected():
    _, tdbs = _pair_sites(n_sites=1)
    with pytest.raises(ValueError, match="jnp"):
        tapr.count_supports(tdbs[0], [(0,)], backend="jnp")


def test_convert_rejects_wrong_width():
    with pytest.raises(ValueError):
        transaction_dbs_from_reference([np.zeros((3, 2), np.uint32)], 20, "cpu")
