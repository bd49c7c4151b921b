"""The service half of the port's workload registry, on the CPU, against
the JAX package's registry: the same apps in the same order, the same
public param schemas (names, kinds, effective defaults), submit-time
validation, the local workloads (``apriori``, ``topk``, ``kmeans``) served
through ``MiningService`` with their accounting, and cross-request fusion
in the service (fused equals serial, one engine run for local workloads,
signature boundaries respected).
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from repro.workflow import registry as jreg
from repro_torch.core.apriori import DeltaApriori, bruteforce_frequent, topk_itemsets
from repro_torch.data.synthetic import ibm_transactions
from repro_torch.launch.serve import APPS, MiningService
from repro_torch.runtime import GridRuntime
from repro_torch.workflow import registry as reg
from repro_torch.workflow.registry import (
    Param,
    WorkloadSpec,
    app_names,
    app_table_markdown,
    conformance_apps,
    get_workload,
    register,
    validate_registry,
    workloads,
)


def test_registry_fully_specified_in_the_reference_order():
    assert validate_registry() == []
    assert app_names() == jreg.app_names()
    assert app_names() == ("apriori", "gfm", "fdm", "cd_apriori", "topk", "kmeans", "vclustering")
    assert conformance_apps() == jreg.conformance_apps()
    for spec in workloads():
        jspec = jreg.get_workload(spec.name)
        assert (spec.dataset_kind, spec.runner, spec.terminal) == (jspec.dataset_kind, jspec.runner, jspec.terminal)
        assert spec.smoke_params == jspec.smoke_params
        assert (spec.exec_batch_key is None) == (jspec.exec_batch_key is None)
        assert (spec.finalize is None) == (jspec.finalize is None)


def _effective_default(app: str, p: Param):
    """A default as the workload reads it: the port spells vclustering's
    ``k_local``/``iters`` as None, meaning 8 and 15 without a ``cfg``."""
    if app == "vclustering" and p.default is None and p.name in reg._VCLUSTER_DEFAULTS:
        return reg._VCLUSTER_DEFAULTS[p.name]
    return p.default


@pytest.mark.parametrize("app", jreg.app_names())
def test_public_params_equal_the_jax_package(app):
    mine = [(p.name, p.kind, _effective_default(app, p)) for p in get_workload(app).public_params()]
    theirs = [(p.name, p.kind, p.default) for p in jreg.get_workload(app).public_params()]
    assert mine == theirs


def test_unknown_app_error_names_the_family():
    with pytest.raises(ValueError, match="unknown app"):
        get_workload("word2vec")


def test_param_coercion_and_defaults():
    spec = get_workload("gfm")
    p = spec.resolve({"k": "4", "minsup": "0.2"})
    assert p["k"] == 4 and isinstance(p["k"], int)
    assert p["minsup"] == pytest.approx(0.2)
    assert p["split_seed"] == 0 and p["n_sites"] is None
    with pytest.raises(ValueError, match="no param"):
        spec.resolve({"bogus": 1})
    with pytest.raises(ValueError, match="expects int"):
        spec.resolve({"k": 2.5})


def test_validate_submitted_rejects_internal_and_nonfinite():
    spec = get_workload("vclustering")
    assert spec.validate_submitted({"k_local": 4, "iters": 8}) == {"k_local": 4, "iters": 8}
    for internal in ("cfg", "init_centers"):
        with pytest.raises(ValueError, match="does not accept"):
            spec.validate_submitted({internal: None})
    with pytest.raises(ValueError, match="does not accept"):
        get_workload("kmeans").validate_submitted({"init_centers": [[0.0]]})
    mine = get_workload("apriori")
    for bad in (float("inf"), float("-inf"), float("nan")):
        with pytest.raises(ValueError, match="non-finite"):
            mine.validate_submitted({"minsup": bad})
    with pytest.raises(ValueError, match="non-finite"):
        mine.validate_submitted({"min_count": math.inf})
    with pytest.raises(ValueError, match="non-finite"):
        mine.validate_submitted({"k": [1.0, float("nan")]})


def test_app_table_markdown_lists_every_app():
    table = app_table_markdown()
    for spec in workloads():
        assert f"`{spec.name}`" in table
        assert f"| {spec.runner} |" in table


def test_registering_requires_unique_names(monkeypatch):
    with pytest.raises(ValueError, match="already registered"):
        register(get_workload("gfm"))
    bad = WorkloadSpec(name="", dataset_kind="nope", runner="nope", description="",
                       params=(Param("x", "complex"),), result_fields=(), digest=None)
    local = WorkloadSpec(name="bare", dataset_kind="points", runner="local", description="d",
                         params=(Param("x", "int", 1, "x"),), result_fields=("x",), digest=dict,
                         smoke_params=({"x": float("inf")},))
    monkeypatch.setitem(reg._REGISTRY, "__bad__", bad)
    monkeypatch.setitem(reg._REGISTRY, "__local__", local)
    problems = validate_registry()
    for want in ("bad dataset_kind", "bad runner", "bad kind", "result schema", "missing local_fn",
                 "smoke params"):
        assert any(want in p for p in problems), want


@pytest.mark.parametrize("app", ["apriori", "topk", "kmeans"])
def test_generic_run_rejects_local_workloads(app):
    rt = GridRuntime(device="cpu")
    with pytest.raises(ValueError, match="'local' workload"):
        rt.run(app, None, {})
    with pytest.raises(ValueError, match="'local' workload"):
        rt.run_many(app, [None], [{}])


def test_generic_run_refuses_the_service_split_params():
    with pytest.raises(ValueError, match="sites already split"):
        GridRuntime(device="cpu").run("vclustering", np.zeros((2, 4, 2), np.float32), {"split_seed": 1})


# ---------------------------------------------------------------------------
# One source of truth: serve-side validation == registry
# ---------------------------------------------------------------------------


def _service(n_items: int = 10, **kw) -> MiningService:
    svc = MiningService(device="cpu", n_sites=2, **kw)
    svc.register_dataset("tx", "transactions", n_items=n_items)
    svc.register_dataset("pts", "points", dim=2)
    svc.append_transactions("tx", ibm_transactions(0, 120, n_items))
    rng = np.random.default_rng(0)
    svc.append_points("pts", rng.normal(size=(90, 2)).astype(np.float32))
    return svc


def test_submit_validated_set_equals_registered_set():
    assert tuple(APPS) == app_names()
    svc = _service()
    for spec in workloads():
        ds = "tx" if spec.dataset_kind == "transactions" else "pts"
        wrong = "pts" if ds == "tx" else "tx"
        rid = svc.submit("t", spec.name, ds, dict(spec.smoke_params[0]))
        assert svc.poll(rid) == "queued"
        with pytest.raises(ValueError, match="dataset"):
            svc.submit("t", spec.name, wrong, dict(spec.smoke_params[0]))


def test_every_registered_app_is_served():
    svc = _service()
    rids = {}
    for spec in workloads():
        ds = "tx" if spec.dataset_kind == "transactions" else "pts"
        rids[spec.name] = svc.submit("t", spec.name, ds, dict(spec.smoke_params[0]))
    svc.drain()
    for name, rid in rids.items():
        assert svc.poll(rid) == "done", (name, svc.request(rid).error)


def test_new_workloads_through_service_with_accounting():
    svc = _service()
    a = svc.submit("t0", "cd_apriori", "tx", {"k": 2, "minsup": 0.3})
    b = svc.submit("t1", "cd_apriori", "tx", {"k": 2, "minsup": 0.3})
    svc.step()
    assert svc.request(b).coalesced_into == a
    assert svc.executions == 1 and svc.coalesced == 1
    c = svc.submit("t2", "cd_apriori", "tx", {"k": 2, "minsup": 0.3})
    t = svc.submit("t2", "topk", "tx", {"k": 2, "top": 5})
    svc.step()
    assert svc.request(c).cache_hit and svc.request(c).backend == "cache"
    assert svc.poll(t) == "done" and not svc.request(t).cache_hit
    t2 = svc.submit("t0", "topk", "tx", {"k": 2, "top": 5})
    svc.step()
    assert svc.request(t2).cache_hit
    assert svc.executions == 2  # one cd_apriori + one topk


def test_topk_matches_bruteforce_ranking():
    n_items = 10
    dense = ibm_transactions(3, 150, n_items, avg_tx_len=4, n_patterns=3)
    delta = DeltaApriori(n_items, backend="kernel", device="cpu")
    delta.append(dense)
    res = topk_itemsets(delta, 2, 7)
    counts = dict(bruteforce_frequent(dense, 2, 1))
    best = sorted(counts.items(), key=lambda ic: (-ic[1], len(ic[0]), ic[0]))[:7]
    assert res.items == best
    assert all(c >= res.threshold for _, c in res.items)
    res2 = topk_itemsets(delta, 2, 7)
    assert res2.items == res.items and res2.count_calls == 0


# ---------------------------------------------------------------------------
# Cross-request fusion in the service
# ---------------------------------------------------------------------------


def test_service_cross_request_fusion_matches_serial():
    queries = [
        ("a", "fdm", {"k": 2, "minsup": 0.3}),
        ("b", "fdm", {"k": 2, "minsup": 0.45}),
        ("c", "fdm", {"k": 2, "minsup": 0.6}),
        ("a", "gfm", {"k": 2, "minsup": 0.35}),
        ("b", "gfm", {"k": 2, "minsup": 0.5}),
    ]
    fsvc, ssvc = _service(), _service(fuse_requests=False)
    rids_f = [fsvc.submit(t, app, "tx", p) for t, app, p in queries]
    rids_s = [ssvc.submit(t, app, "tx", p) for t, app, p in queries]
    fsvc.drain(max_requests=8)
    ssvc.drain(max_requests=8)
    for rf, rs, (_t, app, _p) in zip(rids_f, rids_s, queries):
        assert fsvc.poll(rf) == "done" and ssvc.poll(rs) == "done"
        digest = get_workload(app).digest
        assert digest(fsvc.result(rf)) == digest(ssvc.result(rs))
    led_f, led_s = fsvc.ledger(), ssvc.ledger()
    assert led_f["executions"] == 5 and led_f["exec_groups"] == 5
    assert led_f["device_dispatches"] == 2  # one for the fdm trio, one for the gfm pair
    assert led_f["fused_requests"] == 5
    assert all(fsvc.request(r).fused for r in rids_f)
    assert led_f["per_tenant"]["a"]["fused"] == 2
    assert led_s["device_dispatches"] == led_s["executions"] == 5
    assert led_s["fused_requests"] == 0 and not any(ssvc.request(r).fused for r in rids_s)


def test_service_local_workload_fuses_one_engine_run():
    fsvc, ssvc = _service(), _service(fuse_requests=False)
    digest = get_workload("topk").digest
    rf = [fsvc.submit("a", "topk", "tx", {"k": 2, "top": 5}), fsvc.submit("b", "topk", "tx", {"k": 2, "top": 3})]
    rs = [ssvc.submit("a", "topk", "tx", {"k": 2, "top": 5}), ssvc.submit("b", "topk", "tx", {"k": 2, "top": 3})]
    fsvc.step(max_requests=4)
    ssvc.step(max_requests=4)
    assert (fsvc.device_dispatches, fsvc.executions, fsvc.fused_requests) == (1, 2, 2)
    for a, b in zip(rf, rs):
        assert digest(fsvc.result(a)) == digest(ssvc.result(b))


def test_service_fusion_respects_signature_boundaries():
    """Different k (DAG depth) must not fuse; nor do kmeans requests
    (no signature) or vclustering requests of different k_local."""
    svc = _service()
    svc.submit("a", "fdm", "tx", {"k": 2, "minsup": 0.3})
    svc.submit("b", "fdm", "tx", {"k": 3, "minsup": 0.3})
    svc.submit("a", "kmeans", "pts", {"k": 3, "iters": 4})
    svc.submit("b", "kmeans", "pts", {"k": 3, "iters": 4, "seed": 1})
    svc.submit("a", "vclustering", "pts", {"k_local": 3, "iters": 4})
    svc.submit("b", "vclustering", "pts", {"k_local": 4, "iters": 4})
    svc.step(max_requests=8)
    assert svc.executions == 6 and svc.device_dispatches == 6 and svc.fused_requests == 0


def test_vclustering_default_spelling_fuses_like_the_reference():
    """``{}`` and ``{"k_local": 8, "iters": 15}`` share a signature (the
    defaults the port spells as None), so the two seeds fuse."""
    svc = _service()
    a = svc.submit("a", "vclustering", "pts", {"seed": 0})
    b = svc.submit("b", "vclustering", "pts", {"k_local": 8, "iters": 15, "seed": 1})
    svc.step(max_requests=4)
    assert svc.device_dispatches == 1 and svc.fused_requests == 2
    solo = _service()
    c = solo.submit("a", "vclustering", "pts", {"k_local": 8, "iters": 15, "seed": 1})
    solo.step()
    digest = get_workload("vclustering").digest
    assert digest(svc.result(b)) == digest(solo.result(c))
    assert svc.poll(a) == "done"
