"""The port's request-side primitives against the JAX package's, on the
CPU: ``params_key`` (the canonicalization that coalescing and result-cache
keying stand on), the bounded weighted-round-robin grant table, and the
service's queue-full and failed-execution ledgers.  Pure Python on both
sides; the same seeded push/pick sequence gives the same pick order in
both packages.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.runtime.cache import params_key as jax_params_key
from repro.workflow import requests as jreq
from repro_torch.launch.serve import MiningService
from repro_torch.runtime import ResultCache, params_key
from repro_torch.workflow.requests import MAX_BURST, MiningRequest, QueueFullError, TenantQueues

_SPECIALS = (math.inf, -math.inf, math.nan)


def _rand_value(rng: np.random.Generator, depth: int = 0):
    """One random JSON-ish value, with non-finite floats in the mix."""
    k = int(rng.integers(8 if depth < 3 else 5))
    if k == 0:
        return int(rng.integers(-10_000, 10_000))
    if k == 1:
        return float(rng.normal() * 10)
    if k == 2:
        return _SPECIALS[int(rng.integers(3))]
    if k == 3:
        return bool(rng.integers(2))
    if k == 4:
        return f"s{int(rng.integers(50))}"
    if k == 5:
        return [_rand_value(rng, depth + 1) for _ in range(int(rng.integers(4)))]
    if k == 6:
        return {f"k{i}": _rand_value(rng, depth + 1) for i in range(int(rng.integers(4)))}
    return {int(rng.integers(20)) for _ in range(int(rng.integers(4)))}


def _rand_params(rng: np.random.Generator) -> dict:
    return {f"p{i}": _rand_value(rng) for i in range(int(rng.integers(1, 6)))}


def _respell(v, rng: np.random.Generator):
    """A logically identical respelling: reordered dict keys, list<->tuple,
    small exact ints as floats, fresh nan objects, reshuffled sets."""
    if isinstance(v, dict):
        keys = list(v)
        rng.shuffle(keys)
        return {k: _respell(v[k], rng) for k in keys}
    if isinstance(v, list):
        return tuple(_respell(x, rng) for x in v)
    if isinstance(v, tuple):
        return [_respell(x, rng) for x in v]
    if isinstance(v, (set, frozenset)):
        items = list(v)
        rng.shuffle(items)
        return frozenset(items) if isinstance(v, set) else set(items)
    if isinstance(v, float) and math.isnan(v):
        return float("nan")  # another nan object, the same meaning
    if isinstance(v, bool):
        return v
    if isinstance(v, int) and abs(v) < 2**52:
        return float(v)  # exact as a double; canonicalizes back to int
    return v


def _same_key(a, b) -> bool:
    """Key equality that also holds the one-nan rule: equal keys compare
    equal, and a nan in one sits where the other has the one nan object."""
    return a == b and repr(a) == repr(b)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(min_value=0, max_value=100_000))
def test_params_key_total_hashable_deterministic(seed):
    params = _rand_params(np.random.default_rng(seed))
    key = params_key(params)  # never raises, non-finite floats included
    hash(key)
    assert key == params_key(params)
    hash(ResultCache.key("ds", 1, "app", params))
    assert _same_key(key, jax_params_key(params))  # the JAX package's key, spelled alike


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(min_value=0, max_value=100_000))
def test_logically_identical_params_map_to_equal_keys(seed):
    params = _rand_params(np.random.default_rng(seed))
    respelled = {k: _respell(v, np.random.default_rng(seed + 1)) for k, v in params.items()}
    assert params_key(params) == params_key(respelled)


def test_nonfinite_and_spelling_equivalences():
    assert params_key({"minsup": float("inf")}) == params_key({"minsup": math.inf})
    assert params_key({"minsup": float("nan")}) == params_key({"minsup": math.nan})
    assert params_key({"a": math.inf}) != params_key({"a": -math.inf})
    assert params_key({"a": math.inf}) != params_key({"a": math.nan})
    assert params_key({"k": 3}) == params_key({"k": 3.0})
    assert params_key({"a": 1, "b": 2}) == params_key({"b": 2, "a": 1})
    assert params_key({"xs": [1, 2]}) == params_key({"xs": (1, 2)})
    assert params_key({"s": {3, 1, 2}}) == params_key({"s": frozenset({2, 3, 1})})
    assert params_key({"k": 3}) != params_key({"k": 3.5})
    assert params_key(None) == params_key({})


def test_result_cache_lru_and_stats():
    cache = ResultCache(capacity=2)
    keys = [ResultCache.key("tx", v, "apriori", {"k": 2}) for v in (1, 2, 3)]
    cache.put(keys[0], "a")
    cache.put(keys[1], "b")
    assert cache.get(keys[0]) == "a"  # refreshes keys[0]
    cache.put(keys[2], "c")  # evicts keys[1], the least recently used
    assert keys[1] not in cache and keys[0] in cache and len(cache) == 2
    assert cache.get(keys[1]) is None
    assert (cache.stats.hits, cache.stats.misses, cache.stats.evictions, cache.stats.puts) == (1, 1, 1, 3)
    assert cache.stats.hit_rate() == 0.5
    with pytest.raises(ValueError, match="capacity"):
        ResultCache(0)


# ---------------------------------------------------------------------------
# Bounded weighted-round-robin grants
# ---------------------------------------------------------------------------


@settings(max_examples=20, deadline=None)
@given(w=st.floats(min_value=1e-9, max_value=1e9))
def test_grant_table_is_bounded(w):
    q = TenantQueues(weights={"a": w, "b": 1.0})
    for grant in q.grant_table().values():
        assert 1 <= grant <= MAX_BURST
    assert q.grant_table() == jreq.TenantQueues(weights={"a": w, "b": 1.0}).grant_table()


def test_grant_table_preserves_moderate_ratios():
    assert TenantQueues(weights={"big": 3.0, "small": 1.0}).grant_table() == {"big": 3, "small": 1}
    assert TenantQueues(weights={"big": 1.0, "small": 0.25}).grant_table() == {"big": 4, "small": 1}


def test_extreme_fractional_weights_cannot_starve():
    q = TenantQueues(max_depth=64, weights={"hog": 1.0, "meek": 1e-6})
    assert q.grant_table() == {"hog": MAX_BURST, "meek": 1}
    for i in range(40):
        q.push(MiningRequest(request_id=i, tenant="hog", app="x", dataset="d"))
        q.push(MiningRequest(request_id=100 + i, tenant="meek", app="x", dataset="d"))
    picks = [q.pick().tenant for _ in range(2 * (MAX_BURST + 1))]
    assert "meek" in picks[: MAX_BURST + 1]


@settings(max_examples=15, deadline=None)
@given(w_a=st.floats(min_value=1e-6, max_value=1e6), w_b=st.floats(min_value=1e-6, max_value=1e6))
def test_no_starvation_under_any_weights(w_a, w_b):
    q = TenantQueues(max_depth=64, weights={"a": w_a, "b": w_b})
    for i in range(40):
        q.push(MiningRequest(request_id=i, tenant="a", app="x", dataset="d"))
        q.push(MiningRequest(request_id=1000 + i, tenant="b", app="x", dataset="d"))
    head = [q.pick().tenant for _ in range(2 * (MAX_BURST + 1))][: MAX_BURST + 1]
    assert "a" in head and "b" in head


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pick_order_equals_the_jax_package(seed):
    """The same seeded sequence of pushes, picks and full-queue rejections
    through both packages' TenantQueues: the same picks, in order."""
    rng = np.random.default_rng(seed)
    tenants = ["t0", "t1", "t2", "t3"]
    weights = {"t0": 1.0, "t1": 0.5, "t2": 3.0}
    queues = (TenantQueues(max_depth=5, weights=weights), jreq.TenantQueues(max_depth=5, weights=weights))
    reqs = (MiningRequest, jreq.MiningRequest)
    errs = (QueueFullError, jreq.QueueFullError)
    picks: tuple[list, list] = ([], [])
    for i in range(400):
        if rng.random() < 0.55:
            t = tenants[int(rng.integers(len(tenants)))]
            for q, req, err, out in zip(queues, reqs, errs, picks):
                try:
                    q.push(req(request_id=i, tenant=t, app="apriori", dataset="d"))
                except err:
                    out.append(("rejected", i))
        else:
            for q, out in zip(queues, picks):
                got = q.pick()
                out.append(None if got is None else (got.tenant, got.request_id))
    assert picks[0] == picks[1]
    assert queues[0].rejected == queues[1].rejected > 0
    assert sum(p is not None and p[0] != "rejected" for p in picks[0]) > 100


# ---------------------------------------------------------------------------
# Queue-full and failed-execution ledgers of the service
# ---------------------------------------------------------------------------


def _tx_batch(seed: int, n_tx: int = 40, n_items: int = 8) -> np.ndarray:
    return np.random.default_rng(seed).random((n_tx, n_items)) < 0.45


def _service(**kw) -> MiningService:
    kw.setdefault("n_sites", 2)
    svc = MiningService(device="cpu", **kw)
    svc.register_dataset("tx", "transactions", n_items=8)
    svc.append_transactions("tx", _tx_batch(0))
    return svc


def test_queue_full_is_ledgered_like_param_rejection():
    svc = _service(max_depth=1)
    svc.submit("a", "apriori", "tx", {"k": 1, "minsup": 0.9})
    with pytest.raises(QueueFullError, match="full"):
        svc.submit("a", "apriori", "tx", {"k": 1, "minsup": 0.8})
    assert svc.rejected_full == 1
    led = svc.ledger()
    assert (led["rejected_full"], led["rejected_invalid"], led["rejected"]) == (1, 0, 1)
    rej = [r for r in led["requests"] if r["status"] == "rejected"]
    assert len(rej) == 1 and rej[0]["error"].startswith("QueueFullError")
    assert svc.request(rej[0]["request_id"]).finished_at is not None
    assert led["per_tenant"]["a"]["rejected"] == 1


BAD = {"k": 2, "minsup": 0.3, "n_sites": 0}  # valid at submit, fails at the split


def test_failed_execution_records_attempt():
    svc = _service()
    bad = svc.submit("a", "gfm", "tx", BAD)
    svc.step()
    req = svc.request(bad)
    assert req.status == "failed" and req.error
    assert req.backend == svc.backend_name and req.compute_s >= 0.0
    led = svc.ledger()
    assert (led["failures"], led["failure_memo_hits"], led["per_tenant"]["a"]["failed"]) == (1, 0, 1)


def test_failure_memo_short_circuits_resubmission():
    svc = _service()
    svc.submit("a", "gfm", "tx", BAD)
    svc.step()
    execs = svc.executions
    bad2 = svc.submit("a", "gfm", "tx", BAD)
    svc.step()
    req2 = svc.request(bad2)
    assert req2.status == "failed" and req2.backend == "failure-memo"
    assert (svc.failure_memo_hits, svc.failures, svc.executions) == (1, 1, execs)


def test_failure_memo_invalidated_by_dataset_version():
    svc = _service()
    svc.submit("a", "gfm", "tx", BAD)
    svc.step()
    svc.append_transactions("tx", _tx_batch(1))
    bad3 = svc.submit("a", "gfm", "tx", BAD)
    svc.step()
    assert svc.request(bad3).backend == svc.backend_name  # a real attempt
    assert (svc.failures, svc.failure_memo_hits) == (2, 0)


def test_failure_memo_is_bounded():
    svc = _service(failure_memo_capacity=2)
    for minsup in (0.3, 0.4, 0.5):
        svc.submit("a", "gfm", "tx", {"k": 2, "minsup": minsup, "n_sites": 0})
        svc.step()
    assert svc.failures == 3 and len(svc._failure_memo) == 2
