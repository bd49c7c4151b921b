"""Cross-request fusion in the port (``GridRuntime.run_many``), on the CPU:
each request's slice of one merged engine run is digest-identical to the
request run alone, across both execution backends and both schedulers,
and to the JAX package's ``run_many`` of the same requests.  Exact
equality throughout: the tolerance is zero.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import apriori as japr
from repro.core import kmeans as jkm
from repro.data import synthetic as jsyn
from repro.runtime import GridRuntime as JaxGridRuntime
from repro.workflow.registry import get_workload as jax_workload
from repro_torch.convert import (
    init_centers_from_reference,
    site_points_from_reference,
    transaction_dbs_from_reference,
)
from repro_torch.kernels import ops
from repro_torch.runtime import GridRuntime
from repro_torch.workflow import registry
from repro_torch.workflow.registry import get_workload

N_ITEMS = 40
MINE_APPS = ("gfm", "fdm", "cd_apriori")
# the second member exhausts a level before the first: the per-member
# live/dead seam of the fused fan-outs
MINSUPS = (0.1, 0.5)
K_LOCAL, ITERS = 6, 6


def _sites(n_sites=4, n_tx=1200, seed=2):
    dense = jsyn.ibm_transactions(seed=seed, n_tx=n_tx, n_items=N_ITEMS, avg_tx_len=6, n_patterns=8)
    jdbs = [japr.TransactionDB.from_dense(p) for p in jsyn.split_transactions(dense, n_sites, seed=0)]
    tdbs = transaction_dbs_from_reference([np.asarray(db.packed) for db in jdbs], N_ITEMS, "cpu")
    return jdbs, tdbs


def _rt(backend="batched", schedule="staged", **kw) -> GridRuntime:
    return GridRuntime(backend=backend, schedule=schedule, device="cpu", **kw)


@pytest.mark.parametrize("schedule", ["staged", "async"])
@pytest.mark.parametrize("backend", ["inline", "batched"])
@pytest.mark.parametrize("app", MINE_APPS)
def test_run_many_digest_matches_serial(app, backend, schedule):
    digest = get_workload(app).digest
    _, tdbs = _sites()
    params = [{"k": 3, "minsup": m} for m in MINSUPS]
    serial = [_rt(backend, schedule).run(app, tdbs, p) for p in params]
    ops.reset_launches()
    fused = _rt(backend, schedule).run_many(app, [tdbs, tdbs], params)
    assert len(fused) == len(params)
    for s_run, f_run in zip(serial, fused):
        assert digest(f_run.result) == digest(s_run.result)
        assert f_run.backend == backend
    assert all(v == 0 for v in ops.LAUNCHES.values())  # CPU tensors launch nothing
    if app != "gfm":  # the members stop at different levels
        levels = [len(f.result.per_level_candidates) for f in fused]
        assert levels[0] > levels[1]


@settings(max_examples=6, deadline=None)
@given(
    minsup_a=st.sampled_from([0.05, 0.1, 0.2]),
    minsup_b=st.sampled_from([0.07, 0.15, 0.3]),
    app=st.sampled_from(list(MINE_APPS)),
)
def test_fused_digest_property(minsup_a, minsup_b, app):
    """Any threshold pair fuses without changing either result."""
    digest = get_workload(app).digest
    _, tdbs = _sites(n_sites=3, n_tx=600)
    params = [{"k": 3, "minsup": minsup_a}, {"k": 3, "minsup": minsup_b}]
    serial = [_rt().run(app, tdbs, p).result for p in params]
    fused = _rt().run_many(app, [tdbs, tdbs], params)
    for s_res, f_run in zip(serial, fused):
        assert digest(f_run.result) == digest(s_res)


@pytest.mark.parametrize("app", MINE_APPS)
def test_run_many_matches_jax_run_many(app):
    jdbs, tdbs = _sites()
    params = [{"k": 3, "minsup": m} for m in (0.05, *MINSUPS)]
    jruns = JaxGridRuntime(count_backend="jnp").run_many(app, [jdbs] * 3, params)
    truns = _rt(count_backend="kernel").run_many(app, [tdbs] * 3, params)
    for t, j in zip(truns, jruns):
        assert get_workload(app).digest(t.result) == jax_workload(app).digest(j.result)


def _points(n_sites=4, n=800, seed=7):
    pts, _ = jsyn.gaussian_mixture(seed, n_sites * n, 8, 6, spread=20.0, sigma=0.8)
    return jsyn.split_sites(pts, n_sites, seed=1)


def _jax_init(xs, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), xs.shape[0])
    return np.stack([np.asarray(jkm.kmeans_plus_plus_init(keys[i], jnp.asarray(xs[i]), K_LOCAL))
                     for i in range(len(xs))])


@pytest.mark.parametrize("backend", ["inline", "batched"])
def test_run_many_vclustering_two_seeds_matches_serial(backend):
    """Different seeds fuse: each member's k-means++ draws come from its
    own seed through the batch args, and the perturbation wave carries one
    merge result per member."""
    digest = get_workload("vclustering").digest
    xs = site_points_from_reference(_points(), "cpu")
    params = [{"seed": s, "k_local": K_LOCAL, "iters": ITERS} for s in (0, 1)]
    serial = [_rt(backend).run("vclustering", xs, p) for p in params]
    fused = _rt(backend).run_many("vclustering", [xs, xs], params)
    for s_run, f_run in zip(serial, fused):
        assert digest(f_run.result) == digest(s_run.result)
    assert digest(serial[0].result) != digest(serial[1].result)  # the seeds matter


def test_run_many_vclustering_matches_jax_run_many():
    """Against the JAX package's run_many with seeds 0 and 1: each member
    is fed its JAX k-means++ draws through init_centers."""
    xs_np = _points()
    jruns = JaxGridRuntime(use_kernel=True).run_many(
        "vclustering", [xs_np, xs_np], [{"seed": s, "k_local": K_LOCAL, "iters": ITERS} for s in (0, 1)]
    )
    xs = site_points_from_reference(xs_np, "cpu")
    params = [{"k_local": K_LOCAL, "iters": ITERS, "init_centers": init_centers_from_reference(_jax_init(xs_np, s), "cpu")}
              for s in (0, 1)]
    truns = _rt().run_many("vclustering", [xs, xs], params)
    for t, j in zip(truns, jruns):
        assert get_workload("vclustering").digest(t.result) == jax_workload("vclustering").digest(j.result)


def test_run_many_mixes_seeded_and_given_centres():
    """A merged wave whose members seed differently (one k-means++, one
    given centres) still gives each its own serial result."""
    digest = get_workload("vclustering").digest
    xs = site_points_from_reference(_points(n_sites=3, n=500), "cpu")
    init = init_centers_from_reference(_jax_init(_points(n_sites=3, n=500), 3), "cpu")
    params = [{"seed": 2, "k_local": K_LOCAL, "iters": ITERS},
              {"k_local": K_LOCAL, "iters": ITERS, "init_centers": init}]
    serial = [_rt().run("vclustering", xs, p) for p in params]
    fused = _rt().run_many("vclustering", [xs, xs], params)
    for s_run, f_run in zip(serial, fused):
        assert digest(f_run.result) == digest(s_run.result)


def test_run_many_apportions_measured_compute():
    _, tdbs = _sites(n_sites=2, n_tx=400)
    runs = _rt().run_many("gfm", [tdbs, tdbs], [{"k": 2, "minsup": 0.1}, {"k": 2, "minsup": 0.2}])
    rep = runs[0].report
    assert all(r.report is rep for r in runs)  # one engine invocation served both
    for j, r in enumerate(runs):
        mine = {n: t for n, t in rep.job_times.items() if n.startswith(f"r{j}/")}
        assert mine and r.compute_s == sum(mine.values()) > 0.0
    assert sum(r.compute_s for r in runs) == pytest.approx(sum(rep.job_times.values()), rel=0, abs=1e-12)


def test_run_many_validation(monkeypatch):
    _, tdbs = _sites(n_sites=2, n_tx=100)
    rt = _rt()
    with pytest.raises(ValueError, match="param sets"):
        rt.run_many("gfm", [tdbs], [])
    with pytest.raises(ValueError, match="unknown app"):
        rt.run_many("word2vec", [tdbs], [{"k": 2}])
    with pytest.raises(ValueError, match="local"):  # served by the mining service, as in the JAX package
        rt.run_many("topk", [tdbs], [{"k": 2}])
    with pytest.raises(ValueError, match="no param"):
        rt.run_many("fdm", [tdbs], [{"k": 2, "local_minsup": 0.1}])
    spec = get_workload("gfm")
    modes = iter(["host", "pooled"])

    def build(data, p, ctx):
        jobs, _ = spec.build_jobs(data, p, ctx)
        return jobs, next(modes)

    monkeypatch.setitem(registry._REGISTRY, "gfm", dataclasses.replace(spec, build_jobs=build))
    with pytest.raises(RuntimeError, match="sync modes"):
        rt.run_many("gfm", [tdbs, tdbs], [{"k": 2}, {"k": 2}])


@pytest.mark.parametrize("app,wrapper", [("gfm", "support_count_prune_sites"), ("fdm", "support_count_sites"),
                                         ("cd_apriori", "support_count_sites"),
                                         ("vclustering", "kmeans_assign_sites")])
def test_fused_wave_spans_every_requests_sites(monkeypatch, app, wrapper):
    """Under the batched backend one site-form call serves both requests'
    sites (S = 2 x 4), with each member's own candidate count (ragged C,
    padded and sliced away) for the itemset miners."""
    shapes = []
    real = getattr(ops, wrapper)

    def spy(*args):
        shapes.append((tuple(args[0].shape), tuple(args[1].shape)))
        return real(*args)

    monkeypatch.setattr(ops, wrapper, spy)
    if app == "vclustering":
        xs = site_points_from_reference(_points(), "cpu")
        params = [{"seed": s, "k_local": K_LOCAL, "iters": ITERS} for s in (0, 1)]
        _rt().run_many(app, [xs, xs], params)
        assert len(shapes) == ITERS + 1 and all(x[0] == 8 for x, _ in shapes)
    else:
        _, tdbs = _sites()
        _rt().run_many(app, [tdbs, tdbs], [{"k": 3, "minsup": m} for m in MINSUPS])
        assert max(x[0] for x, _ in shapes) == 8
