"""The port's workflow layer held to the JAX package's, engine by engine.

The same pure-Python DAGs (jobs that return ``TimedResult``s, so every
compute time is simulated and exact) are built once for each package and
run through each package's ``Engine``: fixed, round-robin, random and
greedy-ETA placement, injected faults with retries and rescue, straggler
speculation, worker-slot contention, skewed links and site speeds, both
schedulers.  Each case requires equal ``RunReport``s (every field of the
port's report: the simulated clock, the critical path, placements,
retries, speculation, ``job_times``), equal scheduler traces and equal
results.  The analytical bounds (``estimate_dag``,
``estimate_stages_from_specs``, ``plan_specs``) are held to the same
values, on hand-made specs and on the mining apps' own DAG topologies,
which each package builds from its own site-job factories.
"""

import dataclasses
import importlib
import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

POLICIES = ("fixed", "round_robin", "random", "greedy_eta")
SCHEDULES = ("staged", "async")
N_SITES = 5


def _pkg(root: str) -> SimpleNamespace:
    mods = {n: importlib.import_module(f"{root}.workflow.{n}") for n in
            ("dag", "engine", "faults", "overhead", "placement", "sitejob")}
    return SimpleNamespace(
        root=root,
        DAG=mods["dag"].DAG,
        TimedResult=mods["dag"].TimedResult,
        Engine=mods["engine"].Engine,
        RunReport=mods["engine"].RunReport,
        FaultInjector=mods["faults"].FaultInjector,
        GridModel=mods["overhead"].GridModel,
        JobSpec=mods["overhead"].JobSpec,
        SKEW_SITE_SPEED=mods["overhead"].SKEW_SITE_SPEED,
        estimate_dag=mods["overhead"].estimate_dag,
        estimate_stages=mods["overhead"].estimate_stages,
        estimate_stages_from_specs=mods["overhead"].estimate_stages_from_specs,
        plan_specs=mods["placement"].plan_specs,
        replay_dag=mods["sitejob"].replay_dag,
        job_specs=mods["sitejob"].job_specs,
    )


PKGS = (_pkg("repro"), _pkg("repro_torch"))
ZERO = dict(prep_latency_s=0.0, submit_latency_s=0.0)


def _sim(P, value=None):
    return lambda *a: P.TimedResult(value, 0.0)


def _report(rep) -> dict:
    """Every field of the port's RunReport, read off either package's."""
    out = {f.name: getattr(rep, f.name) for f in dataclasses.fields(PKGS[1].RunReport)}
    out["critical_path_s"] = rep.critical_path_s
    out["overhead_pct"] = rep.overhead_pct()
    return out


def _run(P, build, tmp=None) -> dict:
    """One scenario on package ``P``: ``build(P)`` (or ``build(P, tmp)``)
    returns the engine, the DAG and the run's keyword arguments.  What the
    run leaves behind is returned: the report (or the error), the results,
    each job's status and attempts, the scheduler trace."""
    eng, dag, kw = build(P) if tmp is None else build(P, tmp)
    eng.trace = []
    results = dict(kw.pop("results", {}))
    try:
        rep = eng.run(dag, results=results, **kw)
        out = {"report": _report(rep)}
    except RuntimeError as e:
        out = {"error": str(e)}
    out["results"] = results
    out["jobs"] = {n: (j.status, j.attempts, j.site) for n, j in dag.jobs.items()}
    out["trace"] = eng.trace
    return out


def _both(build, tmp_path=None):
    outs = []
    for P in PKGS:
        tmp = None
        if tmp_path is not None:
            tmp = tmp_path / P.root
            tmp.mkdir(parents=True)
        outs.append(_run(P, build, tmp))
    assert outs[1] == outs[0]
    return outs[1]


# ---------------------------------------------------------------------------
# scenarios: each builds (engine, dag, run kwargs) from one package
# ---------------------------------------------------------------------------


def diamond(P, schedule="staged", policy="fixed", overlap=False, straggler=0.0):
    dag = P.DAG("diamond")
    dag.job("a", lambda: P.TimedResult(1, 0.0), site=1, input_bytes=10**6, sim_compute_s=1.0)
    dag.job("b", lambda a: P.TimedResult(a + 1, 0.0), deps=["a"], site=2, sim_compute_s=2.0,
            output_bytes=10**5)
    dag.job("c", lambda a: P.TimedResult(a + 2, 0.0), deps=["a"], site=3, sim_compute_s=0.5)
    dag.job("d", lambda b, c: P.TimedResult(b + c, 0.0), deps=["b", "c"], site=0, sim_compute_s=1.5)
    eng = P.Engine(model=P.GridModel(), schedule=schedule, placement=policy, overlap_prep=overlap,
                   straggler_factor=straggler)
    return eng, dag, {}


def pinned(P, schedule="async", policy="fixed", workers=1, n=4):
    """``n`` one-second jobs pinned to one site: contention under fixed
    placement, spread by the adaptive policies."""
    dag = P.DAG()
    for i in range(n):
        dag.job(f"j{i}", _sim(P), site=0, sim_compute_s=1.0)
    eng = P.Engine(model=P.GridModel(**ZERO, workers_per_site=workers), schedule=schedule, placement=policy)
    return eng, dag, {}


def flaky(P, schedule="staged", policy="fixed", fail=2, retries=2):
    dag = P.DAG()
    dag.job("a", lambda: P.TimedResult(1, 0.25), site=2)
    dag.job("flaky", lambda a: P.TimedResult(a + 41, 0.5), deps=["a"], retries=retries, site=3)
    eng = P.Engine(model=P.GridModel(**ZERO), schedule=schedule, placement=policy,
                   faults=P.FaultInjector(fail={"flaky": fail}))
    return eng, dag, {}


def fault_rate(P, schedule="staged", seed=0):
    """Seeded random faults over a fan-out: the same failures, retries and
    clock in both packages."""
    dag = P.DAG()
    for i in range(6):
        dag.job(f"m{i}", lambda i=i: P.TimedResult(i, 0.1), site=i % N_SITES, retries=6, sim_compute_s=0.3 * i)
    dag.job("join", lambda *xs: P.TimedResult(sum(xs), 0.0), deps=[f"m{i}" for i in range(6)], retries=6)
    eng = P.Engine(model=P.GridModel(), schedule=schedule, faults=P.FaultInjector(rate=0.3, seed=seed))
    return eng, dag, {}


def stragglers(P, variant, schedule="async", policy="fixed"):
    """The async scheduler's speculation cases (and the staged one's)."""
    dag = P.DAG()
    model = P.GridModel(**ZERO)
    if variant == "copy_wins":
        for i in range(3):
            dag.job(f"fast{i}", _sim(P), site=i, sim_compute_s=1.0)
        dag.job("straggler", _sim(P), site=3, sim_compute_s=10.0)
    elif variant == "early":
        dag.job("straggler", _sim(P), site=3, sim_compute_s=10.0)
        for i in range(3):
            dag.job(f"fast{i}", _sim(P), site=i, sim_compute_s=1.0)
    elif variant == "staging":
        dag.job("heavy", _sim(P), site=1, input_bytes=10**8, sim_compute_s=100.0)
        for i in range(3):
            dag.job(f"fast{i}", _sim(P), site=2 + i, sim_compute_s=1.0)
    elif variant == "deferred":
        model = P.GridModel(**ZERO, workers_per_site=1)
        dag.job("straggler", _sim(P), site=0, sim_compute_s=10.0)
        for i in range(3):
            dag.job(f"fast{i}", _sim(P), site=1, sim_compute_s=1.0)
    else:  # "grid_full"
        model = P.GridModel(**ZERO, workers_per_site=1)
        for i in range(4):
            dag.job(f"j{i}", _sim(P), site=0, sim_compute_s=1.0)
        dag.job("straggler", _sim(P), site=0, sim_compute_s=10.0)
    eng = P.Engine(model=model, schedule=schedule, placement=policy, straggler_factor=3.0)
    return eng, dag, {}


def table3_shape(P, overlap=False, schedule="staged"):
    """Cheap parallel jobs behind the paper's full 295 s preparation."""
    dag = P.DAG()
    for i in range(8):
        dag.job(f"cluster_{i}", lambda: P.TimedResult(0, 0.002 * i), site=i % 5)
    dag.job("merge", lambda *a: P.TimedResult(0, 0.01), deps=[f"cluster_{i}" for i in range(8)])
    return P.Engine(model=P.GridModel(), overlap_prep=overlap, schedule=schedule), dag, {}


def skewed(P, schedule="async", policy="greedy_eta", model="skewed", seed=3):
    """A random topology on a heterogeneous grid: skewed links, skewed
    site speeds, or both."""
    m = {
        "skewed": P.GridModel.skewed(workers_per_site=2),
        "links": P.GridModel(links="skewed"),
        "speeds": P.GridModel(site_speed=P.SKEW_SITE_SPEED, submit_latency_s=0.5),
        "lan": P.GridModel(links="lan", bw_scale=0.5, lat_scale=2.0),
    }[model]
    return P.Engine(model=m, schedule=schedule, placement=policy, straggler_factor=2.5), random_dag(P, seed, 12), {}


def random_dag(P, seed: int, n_jobs: int):
    """Each job depends on a subset of earlier jobs, with random sites,
    staging sizes and simulated compute."""
    rng = random.Random(seed)
    dag = P.DAG(f"rand-{seed}")
    names = [f"j{i}" for i in range(n_jobs)]
    for i, name in enumerate(names):
        deps = [d for d in names[:i] if rng.random() < 0.3][:3]
        dag.job(
            name,
            _sim(P, i),
            deps=deps,
            site=rng.randrange(N_SITES),
            input_bytes=rng.randrange(0, 10**6),
            output_bytes=rng.randrange(0, 10**5),
            sim_compute_s=round(rng.uniform(0.0, 3.0), 3),
        )
    return dag


# ---------------------------------------------------------------------------
# engine cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_diamond_matches(schedule, policy, overlap):
    out = _both(lambda P: diamond(P, schedule, policy, overlap))
    assert out["results"]["d"] == 5
    assert out["report"]["placement"] == policy


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_contention_matches(schedule, workers, policy):
    out = _both(lambda P: pinned(P, schedule, policy, workers))
    if schedule == "async" and policy == "fixed":
        assert out["report"]["wall_s"] == pytest.approx(4.0 if workers == 1 else 2.0)


@pytest.mark.parametrize("policy", ["fixed", "greedy_eta"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_retries_match(schedule, policy):
    out = _both(lambda P: flaky(P, schedule, policy))
    assert out["report"]["retries"] == 2 and out["results"]["flaky"] == 42
    assert out["jobs"]["flaky"][:2] == ("done", 3)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_retry_exhaustion_matches(schedule):
    out = _both(lambda P: flaky(P, schedule, fail=5, retries=1))
    assert "exhausted retries" in out["error"]
    assert out["jobs"]["flaky"][0] == "failed"


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_seeded_fault_rate_matches(schedule, seed):
    out = _both(lambda P: fault_rate(P, schedule, seed))
    assert out["report"]["retries"] > 0


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_rescue_resume_matches(schedule, tmp_path):
    """Crash mid-DAG, then resume from the rescue file: the same frontier
    saved, the same suffix re-executed, the same report."""

    def mk(P, fail):
        calls = []
        dag = P.DAG()
        dag.job("a", lambda: calls.append("a") or P.TimedResult(1, 0.5))
        dag.job("b", lambda a: calls.append("b") or P.TimedResult(a + 1, 0.5), deps=["a"], site=2)
        dag.job("boom", lambda b: calls.append("boom") or P.TimedResult(b, 0.5), deps=["b"], retries=0)
        dag.job("tail", lambda x: calls.append("tail") or P.TimedResult(x + 10, 0.5), deps=["boom"])
        faults = P.FaultInjector(fail={"boom": 5} if fail else {})
        return calls, dag, faults

    def crash(P, tmp):
        calls, dag, faults = mk(P, True)
        eng = P.Engine(model=P.GridModel(**ZERO), schedule=schedule, faults=faults, rescue_path=tmp / "r.json")
        return eng, dag, {}

    first = _both(crash, tmp_path / "crash")
    assert "exhausted" in first["error"]
    saved = [json.loads((tmp_path / "crash" / P.root / "r.json").read_text()) for P in PKGS]
    assert saved[0] == saved[1] == ["a", "b"]

    def resume(P, tmp):
        calls, dag, faults = mk(P, False)
        (tmp / "r.json").write_text(json.dumps(["a", "b"]))
        eng = P.Engine(model=P.GridModel(**ZERO), schedule=schedule, rescue_path=tmp / "r.json")
        return eng, dag, {"results": {"a": 1, "b": 2}}

    out = _both(resume, tmp_path / "resume")
    assert out["results"]["tail"] == 12


@pytest.mark.parametrize(
    "variant,schedule",
    [(v, "async") for v in ("copy_wins", "early", "staging", "deferred", "grid_full")]
    + [("copy_wins", "staged"), ("staging", "staged")],
)
def test_speculation_matches(variant, schedule):
    out = _both(lambda P: stragglers(P, variant, schedule))
    want = {"grid_full": 0}.get(variant, 1)
    assert out["report"]["speculative"] == want


@pytest.mark.parametrize("policy", POLICIES)
def test_speculation_under_adaptive_placement_matches(policy):
    out = _both(lambda P: stragglers(P, "copy_wins", "async", policy))
    assert out["report"]["speculative"] >= 1 and out["report"]["wall_s"] < 10.0


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("overlap", [False, True])
def test_table3_overhead_shape_matches(overlap, schedule):
    out = _both(lambda P: table3_shape(P, overlap, schedule))
    if not overlap:
        assert out["report"]["overhead_pct"] > 90.0


@pytest.mark.parametrize("model", ["skewed", "links", "speeds", "lan"])
@pytest.mark.parametrize("policy", POLICIES)
def test_heterogeneous_grid_matches(policy, model):
    _both(lambda P: skewed(P, "async", policy, model))
    _both(lambda P: skewed(P, "staged", policy, model, seed=4))


def test_run_placement_override_matches():
    def build(P):
        eng, dag, _ = pinned(P, "async", "fixed", workers=2, n=5)
        return eng, dag, {"placement": "round_robin"}

    out = _both(build)
    assert out["report"]["placement"] == "round_robin"
    assert sorted(out["report"]["placements"].values()) == [0, 1, 2, 3, 4]


@settings(max_examples=30, deadline=None)
@given(
    st.integers(min_value=0, max_value=10**9),
    st.integers(min_value=1, max_value=14),
    st.sampled_from(POLICIES),
    st.sampled_from(SCHEDULES),
    st.integers(min_value=1, max_value=3),
    st.sampled_from([0.0, 2.5]),
)
def test_random_dags_match(seed, n_jobs, policy, schedule, workers, straggler):
    """The scheduler-invariant sweep's random topologies: identical
    reports and traces in both packages."""

    def build(P):
        model = P.GridModel(prep_latency_s=0.0, submit_latency_s=0.5, workers_per_site=workers)
        eng = P.Engine(model=model, schedule=schedule, placement=policy, straggler_factor=straggler)
        return eng, random_dag(P, seed, n_jobs), {}

    out = _both(build)
    assert set(out["report"]["placements"]) == {f"j{i}" for i in range(n_jobs)}


# ---------------------------------------------------------------------------
# analytical bounds
# ---------------------------------------------------------------------------


def _hand_specs(P, which):
    S = P.JobSpec
    return {
        "chain": [S("a", (), 1.0), S("b", ("a",), 2.0), S("c", ("b",), 3.0)],
        "fork_join": [S("a", (), 1.0), S("fast", ("a",), 1.0), S("slow", ("a",), 5.0),
                      S("join", ("fast", "slow"), 1.0)],
        "unordered": [S("join", ("x", "y"), 1.0), S("y", ("x",), 2.0), S("x", (), 1.0)],
        "waves": [S("a0", (), 1.0, 10**6, 0, 1), S("b0", (), 3.0, 10**6, 0, 2),
                  S("a1", ("a0",), 3.0, 0, 10**5, 1), S("b1", ("b0",), 0.5, 0, 10**5, 2)],
        "penalized": [S("a", (), 2.0, 10**6, 0, 1), S("b", ("a",), 2.0, 0, 10**5, 4)],
        "heavy": [S("a", (), 1.0, 10**7, 10**7, 2)],
    }[which]


def _models(P):
    return {
        "grid5000": P.GridModel(),
        "zero": P.GridModel(**ZERO),
        "lan": P.GridModel(links="lan"),
        "skewed": P.GridModel.skewed(**ZERO),
    }


def _bounds(P, specs) -> dict:
    out = {}
    for mname, model in _models(P).items():
        for policy in (None,) + POLICIES:
            out[(mname, policy)] = (
                P.estimate_dag(specs, model, placement=policy),
                P.estimate_stages_from_specs(specs, model, placement=policy),
                [tuple(sp) for sp in P.plan_specs(specs, model, policy or "fixed")],
            )
    return out


@pytest.mark.parametrize("which", ["chain", "fork_join", "unordered", "waves", "penalized", "heavy"])
def test_bounds_match(which):
    got = [_bounds(P, _hand_specs(P, which)) for P in PKGS]
    assert got[1] == got[0]
    if which == "chain":
        assert got[1][("grid5000", None)][0] == pytest.approx(6.0)


def test_stage_estimate_matches():
    stages = [[(2.0, 10**6, 10**4, s) for s in range(5)], [(0.5, 10**4, 0, 0)]]
    got = [P.estimate_stages(stages, P.GridModel()) for P in PKGS]
    assert got[1] == got[0] and got[1] > 2.5


def _app_specs(P, app):
    """An app's DAG topology from the package's own site-job factory (no
    job runs), as analytical specs."""
    from repro.data import synthetic as syn

    if app == "gfm":
        dense = syn.ibm_transactions(seed=2, n_tx=200, n_items=16, avg_tx_len=5, n_patterns=4)
        parts = syn.split_transactions(dense, 4, seed=0)
        if P.root == "repro":
            from repro.core.apriori import TransactionDB
            from repro.core.gfm import gfm_site_jobs

            return P.job_specs(gfm_site_jobs([TransactionDB.from_dense(s) for s in parts], 2, 0.1))
        from repro_torch.core.apriori import TransactionDB
        from repro_torch.core.gfm import gfm_site_jobs

        return P.job_specs(gfm_site_jobs([TransactionDB.from_dense(s, "cpu") for s in parts], 2, 0.1))
    pts, _ = syn.gaussian_mixture(0, 400, 2, 4, spread=12.0, sigma=0.5)
    xs = syn.split_sites(pts, 4, seed=1)
    if P.root == "repro":
        import jax

        from repro.core.vclustering import VClusterConfig, vcluster_site_jobs

        return P.job_specs(vcluster_site_jobs(jax.random.PRNGKey(0), xs, VClusterConfig(k_local=4, kmeans_iters=5)))
    import torch

    from repro_torch.core.vclustering import VClusterConfig, vcluster_site_jobs

    return P.job_specs(vcluster_site_jobs(torch.from_numpy(np.array(xs)), VClusterConfig(k_local=4, kmeans_iters=5)))


@pytest.fixture(scope="module")
def app_specs():
    return {(P.root, app): _app_specs(P, app) for P in PKGS for app in ("gfm", "vclustering")}


@pytest.mark.parametrize("app", ["gfm", "vclustering"])
def test_app_topologies_and_bounds_match(app, app_specs):
    specs = [app_specs[(P.root, app)] for P in PKGS]
    assert [tuple(s) for s in specs[1]] == [tuple(s) for s in specs[0]]
    times = {sp.name: 0.05 * (i % 3 + 1) for i, sp in enumerate(specs[0])}
    timed = [[sp._replace(compute_s=times[sp.name]) for sp in s] for s in specs]
    assert _bounds(PKGS[1], timed[1]) == _bounds(PKGS[0], timed[0])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("app", ["gfm", "vclustering"])
def test_app_replays_match(app, schedule, policy, app_specs):
    """The apps' topologies replayed with calibrated times on the skewed
    grid, with speculation on: equal reports, and the async wall above the
    bound priced at the chosen sites."""

    def build(P):
        specs = app_specs[(P.root, app)]
        times = {sp.name: 0.05 * (i % 3 + 1) for i, sp in enumerate(specs)}
        eng = P.Engine(model=P.GridModel.skewed(workers_per_site=2), schedule=schedule, placement=policy,
                       straggler_factor=2.5)
        return eng, P.replay_dag(specs, times), {}

    out = _both(build)
    if schedule == "async":
        P = PKGS[1]
        specs = app_specs[(P.root, app)]
        times = {sp.name: 0.05 * (i % 3 + 1) for i, sp in enumerate(specs)}
        placed = [sp._replace(site=out["report"]["placements"][sp.name], compute_s=times[sp.name])
                  for sp in specs]
        assert out["report"]["wall_s"] >= P.estimate_dag(placed, P.GridModel.skewed(workers_per_site=2)) - 1e-9
