"""The port's mining service (``repro_torch.launch.serve``) on the CPU:
the JAX package's service tests, test for test — submit/poll/result
lifecycle, versioned cache (hits never cross a dataset version), request
coalescing, admission control, weighted round-robin fairness, the
per-request and per-tenant ledger — and parity with the JAX package's
service:

  * the CLI trace (``main``) through both packages: equal service-level
    counters, equal per-request ledgers apart from the times, and equal
    digests of every served itemset result (exact);
  * ``kmeans`` and ``vclustering`` served with the JAX package's
    k-means++ draws, handed over through the internal ``init_centers``
    param: equal assignments, labels and merge counts; inertia within
    1e-5 relative (float32 sums in another order).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import kmeans as jkm
from repro.data import synthetic as jsyn
from repro.launch import serve as jserve
from repro.workflow.registry import get_workload as jax_workload
from repro_torch.core.apriori import concat_dbs, local_apriori
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.serve import MiningService, fairness_violations
from repro_torch.workflow.registry import get_workload, workloads
from repro_torch.workflow.requests import MiningRequest, QueueFullError, TenantQueues

ITEMSET_APPS = ("apriori", "gfm", "fdm", "cd_apriori", "topk")
TIMES = ("queue_wait_s", "compute_s", "service_s")


def _tx_batch(seed: int, n_tx: int = 40, n_items: int = 8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((n_tx, n_items)) < 0.45


def _service(**kw) -> MiningService:
    kw.setdefault("n_sites", 2)
    kw.setdefault("device", "cpu")
    svc = MiningService(**kw)
    svc.register_dataset("tx", "transactions", n_items=8)
    svc.append_transactions("tx", _tx_batch(0))
    return svc


def test_submit_poll_result_lifecycle():
    svc = _service()
    rid = svc.submit("alice", "apriori", "tx", {"k": 3, "minsup": 0.2})
    assert svc.poll(rid) == "queued"
    with pytest.raises(RuntimeError, match="queued"):
        svc.result(rid)
    assert svc.step() == [rid]
    assert svc.poll(rid) == "done"
    assert svc.result(rid).frequent[1]
    req = svc.request(rid)
    assert req.dataset_version == 1 and req.backend == "batched" and not req.cache_hit
    assert req.service_s >= req.queue_wait_s >= 0.0


def test_validation_errors():
    svc = _service()
    with pytest.raises(KeyError, match="register_dataset"):
        svc.submit("a", "apriori", "nope")
    with pytest.raises(ValueError, match="unknown app"):
        svc.submit("a", "word2vec", "tx")
    with pytest.raises(ValueError, match="points dataset"):
        svc.submit("a", "kmeans", "tx")
    with pytest.raises(ValueError, match="already registered"):
        svc.register_dataset("tx", "transactions", n_items=8)


def test_cache_hit_on_repeated_query():
    svc = _service()
    r1 = svc.submit("alice", "apriori", "tx", {"k": 3, "minsup": 0.2})
    svc.step()
    r2 = svc.submit("bob", "apriori", "tx", {"minsup": 0.2, "k": 3})  # reordered params
    svc.step()
    assert svc.cache.stats.hits == 1 and svc.executions == 1
    req2 = svc.request(r2)
    assert req2.cache_hit and req2.backend == "cache" and req2.compute_s == 0.0
    assert svc.result(r2) is svc.result(r1)


def test_cache_never_serves_across_versions():
    svc = _service()
    r1 = svc.submit("alice", "apriori", "tx", {"k": 3, "minsup": 0.2})
    svc.step()
    svc.append_transactions("tx", _tx_batch(1))
    r2 = svc.submit("alice", "apriori", "tx", {"k": 3, "minsup": 0.2})
    svc.step()
    assert (svc.request(r1).dataset_version, svc.request(r2).dataset_version) == (1, 2)
    assert not svc.request(r2).cache_hit and svc.cache.stats.hits == 0
    assert svc.result(r2).counts != svc.result(r1).counts


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(min_value=0, max_value=5_000))
def test_served_results_always_match_current_version(seed):
    """Interleaved appends and repeated queries: every served result —
    cached or computed — equals from-scratch Apriori over the data as of
    the request's dataset_version."""
    rng = np.random.default_rng(seed)
    svc = MiningService(device="cpu")
    svc.register_dataset("tx", "transactions", n_items=6)
    svc.append_transactions("tx", rng.random((int(rng.integers(5, 20)), 6)) < 0.5)
    for _ in range(4):
        if rng.random() < 0.5:
            svc.append_transactions("tx", rng.random((int(rng.integers(3, 15)), 6)) < 0.5)
        params = {"k": int(rng.integers(1, 4)), "min_count": int(rng.integers(1, 8))}
        rid = svc.submit("t0", "apriori", "tx", params)
        svc.step()
        got = svc.result(rid)
        scratch = local_apriori(concat_dbs(svc._datasets["tx"].delta._batches), params["k"], params["min_count"])
        assert got.counts == scratch.counts and got.frequent == scratch.frequent
    assert svc.cache.stats.hits + svc.cache.stats.misses == 4


def test_coalescing_identical_requests_one_execution():
    svc = _service()
    rids = [svc.submit(t, "apriori", "tx", {"k": 2, "minsup": 0.3}) for t in ("a", "b", "c")]
    assert sorted(svc.step(max_requests=8)) == sorted(rids)
    assert svc.executions == 1 and svc.coalesced == 2
    assert svc.request(rids[0]).coalesced_into is None
    for rid in rids[1:]:
        assert svc.request(rid).coalesced_into == rids[0]
        assert svc.result(rid) is svc.result(rids[0])
    r4 = svc.submit("a", "apriori", "tx", {"k": 2, "minsup": 0.5})
    r5 = svc.submit("b", "apriori", "tx", {"k": 2, "minsup": 0.3})
    svc.step(max_requests=8)
    assert svc.request(r4).coalesced_into is None and not svc.request(r4).cache_hit
    assert svc.request(r5).cache_hit


def test_admission_control_bounded_queues():
    svc = _service(max_depth=2)
    svc.submit("a", "apriori", "tx", {"k": 1, "minsup": 0.9})
    svc.submit("a", "apriori", "tx", {"k": 1, "minsup": 0.8})
    with pytest.raises(QueueFullError, match="full"):
        svc.submit("a", "apriori", "tx", {"k": 1, "minsup": 0.7})
    assert svc.queues.rejected == 1
    led = svc.ledger()
    assert led["rejected"] == 1 and led["per_tenant"]["a"]["rejected"] == 1
    svc.submit("b", "apriori", "tx", {"k": 1, "minsup": 0.9})
    assert svc.queues.depth("b") == 1


def test_round_robin_fairness_bound():
    svc = _service()
    tenants = ["t0", "t1", "t2"]
    for i in range(4):
        for t in tenants:
            svc.submit(t, "apriori", "tx", {"k": 1, "min_count": i + 1})
    svc.drain(max_requests=5)
    assert len(svc.pick_log) == 12
    assert fairness_violations(svc.pick_log, tenants, len(svc.pick_log)) == []


def _picks(q: TenantQueues, n_big: int, n_small: int) -> list[str]:
    for i in range(n_big):
        q.push(MiningRequest(request_id=i, tenant="big", app="apriori", dataset="d"))
    for i in range(n_small):
        q.push(MiningRequest(request_id=100 + i, tenant="small", app="apriori", dataset="d"))
    out = [q.pick().tenant for _ in range(n_big + n_small)]
    assert q.pick() is None
    return out


def test_weighted_fairness_shares():
    q = TenantQueues(max_depth=32, weights={"big": 2.0, "small": 1.0})
    assert _picks(q, 6, 3) == ["big", "big", "small"] * 3


def test_fractional_weights_honor_ratios():
    q = TenantQueues(max_depth=32, weights={"big": 1.0, "small": 0.5})
    assert q.weights == {"big": 2.0, "small": 1.0}
    assert _picks(q, 6, 3) == ["big", "big", "small"] * 3
    assert TenantQueues(weights={"a": 3.0, "b": 1.0}).weights == {"a": 3.0, "b": 1.0}
    with pytest.raises(ValueError, match="must be > 0"):
        TenantQueues(weights={"a": 0.0})


def test_failed_request_does_not_kill_service():
    svc = _service()
    bad = svc.submit("a", "gfm", "tx", {"k": 2, "minsup": 0.3, "n_sites": 0})
    ok = svc.submit("b", "apriori", "tx", {"k": 2, "minsup": 0.3})
    assert sorted(svc.step(max_requests=4)) == sorted([bad, ok])
    assert svc.poll(bad) == "failed"
    with pytest.raises(RuntimeError, match="failed"):
        svc.result(bad)
    assert svc.poll(ok) == "done"
    assert svc.ledger()["per_tenant"]["a"]["failed"] == 1


def test_malformed_params_rejected_at_submit():
    svc = _service()
    with pytest.raises(ValueError, match="non-finite"):
        svc.submit("a", "apriori", "tx", {"minsup": float("inf")})
    with pytest.raises(ValueError, match="non-finite"):
        svc.submit("a", "apriori", "tx", {"minsup": float("nan")})
    with pytest.raises(ValueError, match="expects int"):
        svc.submit("a", "apriori", "tx", {"min_count": "not-a-number"})
    with pytest.raises(ValueError, match="does not accept param"):
        svc.submit("a", "apriori", "tx", {"bogus": 1})
    led = svc.ledger()
    assert led["rejected"] == 4
    rejected = [r for r in led["requests"] if r["status"] == "rejected"]
    assert len(rejected) == 4 and all(r["error"] for r in rejected)
    ok = svc.submit("a", "apriori", "tx", {"k": 2, "minsup": 0.3})
    assert svc.step() == [ok] and svc.poll(ok) == "done"


def test_kmeans_warm_start_across_versions():
    svc = MiningService(device="cpu")
    svc.register_dataset("pts", "points", dim=2)
    rng = np.random.default_rng(0)
    svc.append_points("pts", rng.normal(size=(60, 2)).astype(np.float32))
    r1 = svc.submit("a", "kmeans", "pts", {"k": 3, "iters": 8})
    svc.step()
    warm = svc._datasets["pts"].warm_centers[3]
    assert isinstance(warm, np.ndarray)  # a host copy
    svc.append_points("pts", rng.normal(loc=2.0, size=(30, 2)).astype(np.float32))
    r2 = svc.submit("a", "kmeans", "pts", {"k": 3, "iters": 8})
    svc.step()
    res1, res2 = svc.result(r1), svc.result(r2)
    assert tuple(res2.centers.shape) == (3, 2) and tuple(res2.assign.shape) == (90,)
    assert not svc.request(r2).cache_hit
    assert np.isfinite(float(res2.inertia)) and float(res1.inertia) >= 0.0
    assert np.array_equal(warm, res1.centers.numpy())  # the stored copy did not move


def _registry_tx_pool(n_sites: int) -> list[tuple[str, dict]]:
    pool: list[tuple[str, dict]] = []
    for spec in workloads():
        if spec.dataset_kind != "transactions":
            continue
        for smoke in spec.smoke_params:
            params = dict(smoke)
            if spec.runner == "grid":
                params["n_sites"] = n_sites
            pool.append((spec.name, params))
    return pool


def test_mixed_tenant_trace_ledger():
    svc = _service()
    tenants = ["t0", "t1", "t2"]
    pool = _registry_tx_pool(n_sites=2)
    assert {app for app, _ in pool} == {s.name for s in workloads() if s.dataset_kind == "transactions"}
    rng = np.random.default_rng(7)
    for burst in range(3):
        for t in tenants:
            app, params = pool[(burst // 2) % len(pool)]
            svc.submit(t, app, "tx", params)
            app, params = pool[int(rng.integers(len(pool)))]
            svc.submit(t, app, "tx", params)
        svc.drain(max_requests=6)
        if burst == 1:
            svc.append_transactions("tx", _tx_batch(burst + 10, n_tx=20))
    led = svc.ledger()
    assert len(led["requests"]) == 18
    assert all(r["status"] == "done" for r in led["requests"])
    assert led["cache"]["hits"] > 0 and led["coalesced"] > 0
    assert led["executions"] + led["cache"]["hits"] + led["coalesced"] == 18
    assert fairness_violations(svc.pick_log, tenants, len(svc.pick_log)) == []
    for t in tenants:
        assert led["per_tenant"][t]["submitted"] == 6 and led["per_tenant"][t]["done"] == 6
    json.dumps(led)


def test_ledger_records_shape():
    svc = _service()
    rid = svc.submit("a", "apriori", "tx", {"k": 2, "minsup": 0.3})
    svc.step()
    rec = next(r for r in svc.ledger()["requests"] if r["request_id"] == rid)
    for field in ("tenant", "app", "dataset", "dataset_version", "status", "cache_hit", "coalesced_into",
                  "backend", "queue_wait_s", "compute_s", "service_s", "error"):
        assert field in rec
    assert rec["status"] == "done" and rec["error"] is None


def test_service_defaults_to_the_card():
    if torch.cuda.is_available():
        assert MiningService().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            MiningService()
    svc = MiningService(device="cpu")
    assert (svc.count_backend, svc.use_kernel) == ("kernel", True)
    svc.register_dataset("tx", "transactions", n_items=4)
    assert svc._datasets["tx"].delta.device.type == "cpu"


# ---------------------------------------------------------------------------
# Parity with the JAX package's service
# ---------------------------------------------------------------------------


def _captured_main(module, monkeypatch, argv) -> tuple[int, object]:
    """``module.main(argv)``, keeping the service it built."""
    built = []
    real = module._build_service

    def build(args):
        built.append(real(args))
        return built[0]

    monkeypatch.setattr(module, "_build_service", build)
    return module.main(argv), built[0]


def test_cli_trace_equals_the_jax_package(monkeypatch, tmp_path):
    """The CLI's seeded burst trace through both packages' ``main`` with
    ``--check``: the same service-level counters, the same per-request
    ledger apart from the times, and the same served results for every
    itemset app (the JAX side on its plain path, the port on the kernel
    wrappers, which run their plain versions on the CPU)."""
    argv = ["--requests", "24", "--tenants", "3", "--check"]
    ja, tb = tmp_path / "jax.json", tmp_path / "torch.json"
    jrc, jsvc = _captured_main(jserve, monkeypatch, argv + ["--ledger-out", str(ja)])
    ops.reset_launches()
    trc, tsvc = _captured_main(serve, monkeypatch, argv + ["--device", "cpu", "--ledger-out", str(tb)])
    assert jrc == trc == 0
    assert all(v == 0 for v in ops.LAUNCHES.values())  # CPU tensors launch nothing
    jled, tled = json.loads(ja.read_text()), json.loads(tb.read_text())
    for key in jled:
        if key == "per_tenant":
            for t, row in jled[key].items():
                assert {k: v for k, v in tled[key][t].items() if k not in TIMES} == \
                    {k: v for k, v in row.items() if k not in TIMES}, t
        elif key != "requests":
            assert tled[key] == jled[key], key
    assert len(tled["requests"]) == len(jled["requests"]) == 27
    for jr, tr in zip(jled["requests"], tled["requests"]):
        assert {k: v for k, v in tr.items() if k not in TIMES} == {k: v for k, v in jr.items() if k not in TIMES}
    assert tled["fused_requests"] > 0 and tled["cache"]["hits"] > 0 and tled["coalesced"] > 0
    served = 0
    for jr in jled["requests"]:
        if jr["app"] in ITEMSET_APPS and jr["status"] == "done":
            rid = jr["request_id"]
            assert get_workload(jr["app"]).digest(tsvc.result(rid)) == \
                jax_workload(jr["app"]).digest(jsvc.result(rid)), jr
            served += 1
    assert served >= 10
    assert {r["app"] for r in tled["requests"]} == {s.name for s in workloads()}


def _enqueue(svc, tenant: str, app: str, dataset: str, params: dict) -> int:
    """Admit a request as a runtime caller would: internal params (the
    JAX package's draws, as nested lists so that the params stay
    hashable for coalescing) included, which ``submit`` rejects."""
    req = MiningRequest(request_id=next(svc._ids), tenant=tenant, app=app, dataset=dataset,
                        params=dict(params), submitted_at=svc._clock())
    svc._requests[req.request_id] = req
    svc.queues.push(req)
    return req.request_id


def _points(seed: int, n: int) -> np.ndarray:
    return jsyn.gaussian_mixture(seed, n, 2, 3)[0]


def test_kmeans_through_the_service_equals_jax():
    """A cold start from the JAX package's k-means++ draw, then (after an
    append) a warm start from each package's own stored centroids."""
    jsvc = jserve.MiningService(count_backend="jnp", use_kernel=False)
    tsvc = MiningService(device="cpu")
    first, second = _points(0, 240), _points(1, 60)
    for svc in (jsvc, tsvc):
        svc.register_dataset("pts", "points", dim=2)
        svc.append_points("pts", first)
    params = {"k": 4, "iters": 10, "seed": 3}
    init = np.asarray(jkm.kmeans_plus_plus_init(jax.random.PRNGKey(3), jnp.asarray(first), 4))
    rids = [(jsvc.submit("a", "kmeans", "pts", params), _enqueue(tsvc, "a", "kmeans", "pts",
                                                                 {**params, "init_centers": init.tolist()}))]
    jsvc.step()
    tsvc.step()
    for svc in (jsvc, tsvc):
        svc.append_points("pts", second)
    rids.append((jsvc.submit("a", "kmeans", "pts", params), tsvc.submit("a", "kmeans", "pts", params)))
    jsvc.step()
    tsvc.step()
    for jr, tr in rids:
        j, t = jsvc.result(jr), tsvc.result(tr)
        np.testing.assert_array_equal(t.assign.numpy(), np.asarray(j.assign))
        np.testing.assert_allclose(float(t.inertia), float(j.inertia), rtol=1e-5)
        np.testing.assert_allclose(t.centers.numpy(), np.asarray(j.centers), rtol=1e-5, atol=1e-6)
    assert tsvc.request(rids[1][1]).dataset_version == 2


def test_vclustering_through_the_service_equals_jax():
    """Two seeds served at n_sites 3, each from the JAX package's per-site
    draws for that seed (``PRNGKey(seed)`` split over the sites)."""
    pts, _ = jsyn.gaussian_mixture(7, 1200, 2, 4, spread=12.0, sigma=0.5)
    jsvc = jserve.MiningService(count_backend="jnp", use_kernel=False, n_sites=3)
    tsvc = MiningService(device="cpu", n_sites=3)
    for svc in (jsvc, tsvc):
        svc.register_dataset("pts", "points", dim=2)
        svc.append_points("pts", pts)
    xs = jsyn.split_sites(pts, 3, seed=0)
    pairs = []
    for seed in (0, 1):
        keys = jax.random.split(jax.random.PRNGKey(seed), 3)
        init = np.stack([np.asarray(jkm.kmeans_plus_plus_init(keys[i], jnp.asarray(xs[i]), 4)) for i in range(3)])
        params = {"k_local": 4, "iters": 8, "seed": seed}
        pairs.append((jsvc.submit("a", "vclustering", "pts", params),
                      _enqueue(tsvc, "a", "vclustering", "pts", {**params, "init_centers": init.tolist()})))
    jsvc.drain()
    tsvc.drain()
    assert tsvc.device_dispatches == tsvc.executions == 2  # handed-over draws never fuse
    for jr, tr in pairs:
        want = jax_workload("vclustering").digest(jsvc.result(jr))
        assert get_workload("vclustering").digest(tsvc.result(tr)) == want
        assert want["n_global"] > 1
