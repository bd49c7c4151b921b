"""The delta (incremental) Apriori and streaming top-k in the port, on the
CPU: incremental maintenance over an append-only stream is BIT-IDENTICAL
to from-scratch Apriori over the concatenated data at every version, and
the results and the ``count_calls`` ledger equal the JAX package's
``DeltaApriori`` fed the same batches.  Exact equality throughout: the
tolerance is zero.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import apriori as japr
from repro_torch.core.apriori import (
    DeltaApriori,
    TransactionDB,
    bruteforce_frequent,
    concat_dbs,
    local_apriori,
    topk_itemsets,
)
from repro_torch.kernels import ops


def _random_batches(rng: np.random.Generator, n_batches: int, n_items: int):
    """Random dense bool transaction batches (each with >=1 transaction)."""
    return [rng.random((int(rng.integers(3, 25)), n_items)) < rng.uniform(0.2, 0.7) for _ in range(n_batches)]


def _assert_bitidentical(delta_res, scratch_res):
    assert delta_res.counts == scratch_res.counts
    assert delta_res.frequent == scratch_res.frequent
    assert delta_res.candidates_counted == scratch_res.candidates_counted


def _same_as_jax(res, jres):
    assert res.counts == jres.counts
    assert res.frequent == jres.frequent
    assert (res.count_calls, res.candidates_counted) == (jres.count_calls, jres.candidates_counted)


@settings(max_examples=12, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=10_000),
    n_batches=st.integers(min_value=1, max_value=4),
    n_items=st.integers(min_value=4, max_value=40),
    k_max=st.integers(min_value=1, max_value=4),
    backend=st.sampled_from(["torch", "kernel"]),
)
def test_query_bitidentical_to_scratch_and_jax_at_every_version(seed, n_batches, n_items, k_max, backend):
    """After every append: query(k, t) == local_apriori(concat(batches), k,
    t), and the result and count_calls equal the JAX package's state fed
    the same batches, query for query."""
    rng = np.random.default_rng(seed)
    state = DeltaApriori(n_items, backend=backend, device="cpu")
    jstate = japr.DeltaApriori(n_items)
    for b in _random_batches(rng, n_batches, n_items):
        assert state.append(b) == jstate.append(b)
        min_count = int(rng.integers(1, max(state.n_tx // 2, 1) + 1))
        scratch = local_apriori(concat_dbs(state._batches), k_max, min_count)
        res = state.query(k_max, min_count)
        _assert_bitidentical(res, scratch)
        _same_as_jax(res, jstate.query(k_max, min_count))
        assert state.count_calls == jstate.count_calls
    assert state.n_tx == jstate.n_tx


def test_repeat_query_costs_zero_device_passes():
    rng = np.random.default_rng(0)
    state = DeltaApriori(8, device="cpu")
    for b in _random_batches(rng, 2, 8):
        state.append(b)
    first = state.query(3, max(1, state.n_tx // 5))
    again = state.query(3, max(1, state.n_tx // 5))
    assert first.count_calls > 0
    assert again.count_calls == 0  # every candidate already cached
    _assert_bitidentical(again, first)


def test_append_counts_only_the_new_batch():
    """An append's count pass sees the batch's rows, not the stream's."""
    rng = np.random.default_rng(3)
    state = DeltaApriori(10, backend="kernel", device="cpu")
    state.append(_random_batches(rng, 1, 10)[0])
    state.query(3, 2)
    seen = []
    real = ops.support_count

    def spy(tx, masks):
        seen.append(tx.shape[0])
        return real(tx, masks)

    ops.support_count = spy
    try:
        batch = rng.random((17, 10)) < 0.5
        state.append(batch)
    finally:
        ops.support_count = real
    assert seen == [17]


def test_from_db_state_serves_counts_like_the_reference():
    rng = np.random.default_rng(5)
    dense = rng.random((60, 12)) < 0.4
    state = DeltaApriori.from_db(TransactionDB.from_dense(dense, device="cpu"))
    jstate = japr.DeltaApriori.from_db(japr.TransactionDB.from_dense(dense))
    cands = [(0, 1), (2, 5), (0, 1, 2), (3,)]
    assert state.uncached(cands) == jstate.uncached(cands) == [(0, 1), (2, 5), (0, 1, 2)]
    assert state.counts_for(cands) == jstate.counts_for(cands)
    state.fold_exact([(4, 7)], [3])
    jstate.fold_exact([(4, 7)], [3])
    assert state.counts_for([(4, 7)]) == {(4, 7): 3}
    assert (state.count_calls, state.version, state.stream().n_tx) == (jstate.count_calls, jstate.version, 60)


def test_append_rejects_wrong_universe():
    state = DeltaApriori(5, device="cpu")
    with pytest.raises(ValueError, match="items"):
        state.append(np.ones((3, 7), dtype=bool))


def test_query_before_any_append_raises():
    with pytest.raises(RuntimeError, match="append"):
        DeltaApriori(4, device="cpu").query(2, 1)


def test_unknown_count_backend_raises():
    with pytest.raises(ValueError, match="count backend"):
        DeltaApriori(4, backend="jnp", device="cpu")


def test_concat_dbs_rejects_mismatched_universes_and_devices():
    a = TransactionDB.from_dense(np.ones((2, 4), dtype=bool), device="cpu")
    b = TransactionDB.from_dense(np.ones((2, 6), dtype=bool), device="cpu")
    with pytest.raises(ValueError, match="universes"):
        concat_dbs([a, b])
    with pytest.raises(ValueError, match="at least one"):
        concat_dbs([])
    meta = TransactionDB(packed=torch.zeros((2, 1), dtype=torch.int32, device="meta"), n_items=4, n_tx=2)
    with pytest.raises(ValueError, match="devices"):
        concat_dbs([a, meta])
    both = concat_dbs([a, a])
    assert both.n_tx == 4 and torch.equal(both.packed, torch.cat([a.packed, a.packed]))


@pytest.mark.parametrize("k_max,top,floor", [(3, 10, 1), (2, 4, 1), (3, 50, 6)])
def test_topk_matches_jax_and_bruteforce(k_max, top, floor):
    rng = np.random.default_rng(11)
    batches = _random_batches(rng, 3, 9)
    state = DeltaApriori(9, backend="kernel", device="cpu")
    jstate = japr.DeltaApriori(9)
    for b in batches:
        state.append(b)
        jstate.append(b)
    got = topk_itemsets(state, k_max, top, floor=floor)
    want = japr.topk_itemsets(jstate, k_max, top, floor=floor)
    assert (got.items, got.threshold, got.k_max, got.count_calls) == (
        want.items, want.threshold, want.k_max, want.count_calls
    )
    ranked = sorted(bruteforce_frequent(np.concatenate(batches), k_max, got.threshold).items(),
                    key=lambda ic: (-ic[1], len(ic[0]), ic[0]))
    assert got.items == ranked[:top]
    assert topk_itemsets(state, k_max, top, floor=floor).count_calls == 0  # warm: fully cached


def test_topk_rejects_bad_arguments():
    state = DeltaApriori(3, device="cpu")
    state.append(np.ones((2, 3), dtype=bool))
    with pytest.raises(ValueError, match="top"):
        topk_itemsets(state, 2, 0)
    with pytest.raises(ValueError, match="floor"):
        topk_itemsets(state, 2, 3, floor=0)


def test_bruteforce_matches_the_reference_oracle():
    rng = np.random.default_rng(2)
    dense = rng.random((80, 10)) < 0.45
    assert bruteforce_frequent(dense, 3, 12) == japr.bruteforce_frequent(dense, 3, 12)
