"""The port's conformance matrix: inline × batched × multihost (2 and 3
gloo processes, per-job and wave-fused shipping) × every conformance app
× both engine schedules, held to the JAX package's inline cells.

The children are ``python -m repro_torch.runtime.conformance --device cpu
--count-backend torch``; they import no JAX.  The parent computes the JAX
package's inline cells in this process
(``repro.runtime.conformance.conformance_cell``) and hands the JAX
k-means++ draws to the children as an ``.npy`` (``jax.random`` cannot be
redrawn in torch).  Every process's multihost digest and scheduling
fingerprint must equal the JAX inline cell; each site's jobs must execute
in exactly one process; the shipment ledger must add up, with wave-fused
groups shipping fewer times than there are jobs.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.kmeans import kmeans_plus_plus_init
from repro.runtime import conformance as jconf
from repro.workflow.faults import FaultInjector as JaxFaultInjector
from repro_torch.runtime import conformance as tconf
from repro_torch.runtime.backends import MultiHostBackend

SRC = str(Path(__file__).resolve().parent.parent / "src")

# (n_processes, n_sites, fuse): sites deliberately do NOT divide evenly
# over the processes, so the ownership map must handle ragged partitions.
GROUPS = {
    "2p": (2, 3, 0),
    "3p": (3, 4, 0),
    "2p_batched": (2, 3, 1),
    "3p_batched": (3, 4, 1),
}
APPS = tconf.APPS
SCHEDULES = tconf.SCHEDULES
CELLS = [(app, sched) for app in APPS for sched in SCHEDULES]
FAULT = {"cluster_1": 1}


def test_apps_are_the_jax_packages():
    assert APPS == jconf.APPS == ("gfm", "fdm", "cd_apriori", "vclustering")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_init_centers(n_sites: int) -> np.ndarray:
    """The per-site k-means++ centres the JAX conformance cell draws
    (``vcluster_site_jobs`` splits ``PRNGKey(0)`` over the sites)."""
    xs, _ = jconf.make_inputs(n_sites)
    keys = jax.random.split(jax.random.PRNGKey(0), n_sites)
    return np.stack(
        [np.asarray(kmeans_plus_plus_init(keys[i], jnp.asarray(xs[i]), tconf.K_LOCAL)) for i in range(n_sites)]
    )


def _launch_group(nprocs: int, n_sites: int, fuse: int, init_path: Path) -> dict:
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    argv = [
        sys.executable, "-m", "repro_torch.runtime.conformance",
        "--nprocs", str(nprocs), "--port", str(port), "--sites", str(n_sites), "--fuse", str(fuse),
        "--device", "cpu", "--count-backend", "torch", "--init-centers", str(init_path),
    ]
    procs = [
        subprocess.Popen(argv + ["--pid", str(pid)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(nprocs)
    ]
    reports, errors = [], []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            if p.returncode != 0:
                errors.append(err[-4000:])
                continue
            lines = [ln for ln in out.splitlines() if ln.startswith(tconf.MARKER)]
            if not lines:
                errors.append(f"no conformance marker in child output: {out[-2000:]!r}")
                continue
            reports.append(json.loads(lines[0][len(tconf.MARKER):]))
    except subprocess.TimeoutExpired:
        errors.append("conformance child timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        return {"error": "\n".join(errors)}
    reports.sort(key=lambda r: r["pid"])
    return {"reports": reports, "nprocs": nprocs, "n_sites": n_sites}


_group_cache: dict = {}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    def get(name: str) -> dict:
        if name not in _group_cache:
            nprocs, n_sites, fuse = GROUPS[name]
            path = tmp_path_factory.mktemp("init") / f"init_{n_sites}.npy"
            np.save(path, _jax_init_centers(n_sites))
            _group_cache[name] = _launch_group(nprocs, n_sites, fuse, path)
        g = _group_cache[name]
        if "error" in g:
            pytest.fail(f"multihost conformance group {name} failed:\n{g['error']}")
        return g

    return get


_jax_cache: dict = {}


def _jax_cell(app: str, n_sites: int, schedule: str) -> dict:
    """The JAX package's inline cell, cached."""
    key = (app, n_sites, schedule)
    if key not in _jax_cache:
        _jax_cache[key] = jconf.conformance_cell(app, n_sites, schedule, "inline")
    return _jax_cache[key]


def _cell(report: dict, app: str, schedule: str) -> dict:
    for cell in report["cells"]:
        if cell["multihost"]["app"] == app and cell["multihost"]["schedule"] == schedule:
            return cell
    raise AssertionError(f"cell ({app}, {schedule}) missing from child report")


def _port_cell(app: str, n_sites: int, schedule: str, backend) -> dict:
    init = _jax_init_centers(n_sites) if app == "vclustering" else None
    return tconf.conformance_cell(app, n_sites, schedule, backend, init_centers=init)


# ---------------------------------------------------------------------------
# in-process cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["inline", "batched"])
@pytest.mark.parametrize("app,schedule", CELLS)
def test_in_process_cells_match_jax(app, schedule, backend):
    """inline and batched in this process, at both of the matrix's site
    counts: digests and fingerprints equal to the JAX inline cell."""
    for n_sites in sorted({g[1] for g in GROUPS.values()}):
        ref = _jax_cell(app, n_sites, schedule)
        got = _port_cell(app, n_sites, schedule, backend)
        assert got["digest"] == ref["digest"]
        assert got["fingerprint"] == ref["fingerprint"]


@pytest.mark.parametrize("app", APPS)
def test_multihost_single_process_matches_jax(app):
    """Engine(backend="multihost") without a coordinator degrades to
    inline execution — same digests, same fingerprints, no partition."""
    be = MultiHostBackend()
    n_sites = GROUPS["2p"][1]
    ref = _jax_cell(app, n_sites, "staged")
    init = _jax_init_centers(n_sites) if app == "vclustering" else None
    run = tconf.run_app(app, n_sites, "staged", be, init_centers=init)
    assert tconf.result_digest(app, run) == ref["digest"]
    assert tconf.schedule_fingerprint(run.report) == ref["fingerprint"]
    assert run.n_processes == 1 and run.owned_sites is None
    assert sorted(be.executed_log) == sorted(run.report.job_times)


# ---------------------------------------------------------------------------
# multihost subprocess cells (2 and 3 processes, uneven sites)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GROUPS))
@pytest.mark.parametrize("app,schedule", CELLS)
def test_multihost_matches_jax(group, name, app, schedule):
    """Every process's multihost digest and fingerprint, and its own
    inline run's, equal the JAX package's inline cell."""
    g = group(name)
    ref = _jax_cell(app, g["n_sites"], schedule)
    for report in g["reports"]:
        cell = _cell(report, app, schedule)
        for kind in ("multihost", "inline"):
            assert cell[kind]["digest"] == ref["digest"], f"pid {report['pid']}: {kind} diverged from JAX"
            assert cell[kind]["fingerprint"] == ref["fingerprint"], f"pid {report['pid']}: {kind} fingerprint"


@pytest.mark.parametrize("name", sorted(GROUPS))
@pytest.mark.parametrize("app,schedule", CELLS)
def test_multihost_identical_across_processes(group, name, app, schedule):
    g = group(name)
    cells = [_cell(r, app, schedule)["multihost"] for r in g["reports"]]
    assert len(cells) == g["nprocs"]
    for cell in cells[1:]:
        assert cell["digest"] == cells[0]["digest"]
        assert cell["fingerprint"] == cells[0]["fingerprint"]


@pytest.mark.parametrize("name", sorted(GROUPS))
@pytest.mark.parametrize("app,schedule", CELLS)
def test_each_sites_jobs_execute_on_exactly_one_process(group, name, app, schedule):
    """The acceptance audit: per-process execution logs partition the DAG
    — each job (and hence each site's whole job set) executes in exactly
    one process; everything else arrives shipped."""
    g = group(name)
    cells = [_cell(r, app, schedule)["multihost"] for r in g["reports"]]
    job_sites = cells[0]["job_sites"]
    assert job_sites == tconf.job_sites(app, g["n_sites"])
    executed_by = [set(c["executed"]) for c in cells]
    union: set = set()
    for ex in executed_by:
        assert not (union & ex), f"jobs executed on more than one process: {union & ex}"
        union |= ex
    assert union == set(job_sites)
    for pid, mh in enumerate(cells):
        owned_sites = set(mh["owned_sites"])
        assert all(job_sites[n] in owned_sites for n in mh["executed"])
        assert all(n in executed_by[pid] for n, s in job_sites.items() if s in owned_sites)
    claimed = sorted(s for mh in cells for s in mh["owned_sites"])
    assert claimed == sorted(set(job_sites.values()))
    for mh, ex in zip(cells, executed_by):
        assert set(mh["shipped"]) == set(job_sites) - ex


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_fault_injection_under_distribution(group, name):
    """A seeded injected failure retries identically on every process and
    the result equals the JAX package's inline run under the same fault."""
    g = group(name)
    jrun = jconf.run_app("vclustering", g["n_sites"], "staged", "inline", faults=JaxFaultInjector(fail=FAULT))
    want = jconf.result_digest("vclustering", jrun)
    for report in g["reports"]:
        fc = report["fault_cell"]
        assert fc["retries_mh"] == fc["retries_inline"] == int(jrun.report.retries) == 1
        assert fc["digest_mh"] == fc["digest_inline"] == want
        assert fc["n_processes"] == g["nprocs"]
        assert fc["owned_sites"] == _cell(report, "vclustering", "staged")["multihost"]["owned_sites"]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_shipment_ledger(group, name):
    """Wave-fused groups ship once per ready WAVE, fewer times than there
    are jobs; per-job groups once per job; two all_gather rounds each."""
    g = group(name)
    fused = bool(GROUPS[name][2])
    for report in g["reports"]:
        assert report["fuse_waves"] is fused
        for cell in report["cells"]:
            mh = cell["multihost"]
            led = mh["ledger"]
            n_jobs = len(mh["job_sites"])
            assert led["collective_rounds"] == 2 * led["shipments"]
            assert led["shipped_results"] == len(mh["shipped"])
            if fused:
                assert led["shipments"] == led["waves"] < n_jobs
            else:
                assert led["waves"] == 0
                assert led["shipments"] == n_jobs


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_topology(group, name):
    """The group really is multi-process over gloo, one CPU device each."""
    g = group(name)
    for pid, report in enumerate(g["reports"]):
        topo = report["topology"]
        assert topo["is_multiprocess"] is True
        assert topo["process_count"] == g["nprocs"] and topo["process_index"] == pid
        assert topo["capacity"] == {str(p): 1 for p in range(g["nprocs"])}
        assert (topo["device"], topo["wire"]) == ("cpu", "gloo")
