"""Cross-backend conformance harness — the contract every execution
backend must satisfy, and the multi-process audit trail that proves true
site ownership.

The contract: execution backends change HOW job callables run (inline
host loop, fused site-axis launch, site-partitioned multi-host with
result shipping) — never WHAT the scheduler decides or WHAT the mining
computes.  For any (app, schedule) cell this module can produce

  * a **result digest** — the mining outputs themselves (cluster labels,
    frequent itemsets with exact counts, the CommLog) in canonical
    JSON-able form; backends must match BIT-FOR-BIT, and so must the JAX
    package's digest of the same cell;
  * a **scheduling fingerprint** — the simulated-clock quantities that
    are deterministic under fixed placement (prep/submit/transfer,
    placements, retries, job set); backends must match exactly.

Run as a module it is the multi-host conformance CHILD: each process of
a gloo group executes every cell through ``MultiHostBackend`` *and*
through the inline backend in the same process, then prints one JSON
report (digests, fingerprints, per-process execution logs, ownership) for
the parent harness (``tests/test_torch_backend_conformance.py``) to cross
check:

    python -m repro_torch.runtime.conformance --pid 0 --nprocs 3 \\
        --port 12345 --sites 4 --device cpu

The execution logs are the acceptance check for true distribution: each
site's jobs must appear in EXACTLY ONE process's ``executed`` list.

``jax.random`` draws cannot be redrawn in torch, so vclustering's
k-means++ centres come from ``--init-centers`` (an ``.npy`` of per-site
``(S, k_local, D)`` centres) when the parent holds the child to the JAX
package; without it the child draws its own seeded centres and is held to
its own inline run.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed

from repro_torch.core.apriori import TransactionDB
from repro_torch.core.vclustering import VClusterConfig
from repro_torch.data.synthetic import (
    gaussian_mixture,
    ibm_transactions,
    split_sites,
    split_transactions,
)
from repro_torch.device import resolve_device
from repro_torch.runtime.gridruntime import GridRuntime
from repro_torch.workflow.engine import Engine, RunReport
from repro_torch.workflow.faults import FaultInjector
from repro_torch.workflow.overhead import GridModel
from repro_torch.workflow.registry import RunContext, conformance_apps, get_workload

# every registered grid workload that opted into the conformance matrix
APPS = conformance_apps()
SCHEDULES = ("staged", "async")

# small-but-nontrivial canonical inputs (the JAX package's): enough
# structure that the mining produces real itemsets/clusters, small enough
# that a 3-process CPU conformance run stays quick
_N_POINTS_PER_SITE = 60
_N_TX = 160
_N_ITEMS = 12
_K_ITEMSETS = 3
_MINSUP = 0.15
K_LOCAL = 3
_KMEANS_ITERS = 5


def make_inputs(n_sites: int, seed: int = 0, device: str | torch.device = "cpu"):
    """Deterministic synthetic inputs for one conformance cell: per-site
    point sets (an ``(S, n, 2)`` numpy array) for clustering and per-site
    TransactionDBs on ``device`` for mining.  Every process derives the
    identical inputs from the seed, byte for byte the JAX package's."""
    pts, _ = gaussian_mixture(seed, _N_POINTS_PER_SITE * n_sites, 2, 3, spread=9.0, sigma=0.8)
    xs = split_sites(pts, n_sites, seed=seed + 1)
    dense = ibm_transactions(seed=seed + 2, n_tx=_N_TX, n_items=_N_ITEMS, avg_tx_len=5, n_patterns=4)
    dbs = [TransactionDB.from_dense(d, device) for d in split_transactions(dense, n_sites, seed=seed)]
    return xs, dbs


def _conf_params(app: str, seed: int = 0, init_centers=None) -> dict:
    """The canonical params of one conformance cell, by dataset kind."""
    if get_workload(app).dataset_kind == "points":
        cfg = VClusterConfig(k_local=K_LOCAL, kmeans_iters=_KMEANS_ITERS)
        return {"cfg": cfg, "seed": seed, "init_centers": init_centers}
    return {"k": _K_ITEMSETS, "minsup": _MINSUP}


def run_app(
    app: str,
    n_sites: int,
    schedule: str,
    backend,
    *,
    faults=None,
    seed: int = 0,
    count_backend: str = "torch",
    use_kernel: bool = False,
    device: str | torch.device = "cpu",
    init_centers=None,
    block: str | None = None,
):
    """Execute one registered app through the generic GridRuntime.run on
    the given execution backend (name or instance); returns the
    RuntimeRun.  ``count_backend``/``use_kernel`` select the compute path
    exactly as ``GridRuntime`` does (the plain path keeps the CPU matrix
    cheap); ``init_centers`` are vclustering's per-site starting
    centres.  ``block`` (``"default"`` or ``"auto"``) sets the kernel
    wrappers' block mode for the run and restores it afterwards, so the
    digests can be checked with autotuned launches: the autotuner's
    never-changes-results contract, on the real apps."""
    xs, dbs = make_inputs(n_sites, seed, device)
    engine = Engine(model=GridModel(), faults=faults, overlap_prep=True, schedule=schedule, backend=backend)
    rt = GridRuntime(engine=engine, count_backend=count_backend, use_kernel=use_kernel, device=device)
    data = xs if get_workload(app).dataset_kind == "points" else dbs
    if block is None:
        return rt.run(app, data, _conf_params(app, seed, init_centers))
    from repro_torch.kernels import ops

    prev = ops.set_default_block(block)
    try:
        return rt.run(app, data, _conf_params(app, seed, init_centers))
    finally:
        ops.set_default_block(prev)


def result_digest(app: str, run) -> dict:
    """The mining output in canonical JSON-able form — the thing that must
    be bit-for-bit identical across backends, processes and packages.  The
    digest shape is the registered WorkloadSpec's."""
    return get_workload(app).digest(run.result)


def schedule_fingerprint(rep: RunReport) -> dict:
    """What the scheduler decided, independent of measured compute and of
    the executing backend: identical across backends under fixed
    placement, and identical across the processes of one multi-host run
    (the globally-consistent clock/ledger invariant)."""
    return {
        "schedule": rep.schedule,
        "placement": rep.placement,
        "placements": {k: int(v) for k, v in sorted(rep.placements.items())},
        "prep_s": rep.prep_s,
        "submit_s": rep.submit_s,
        "transfer_s": rep.transfer_s,
        "retries": int(rep.retries),
        "speculative": int(rep.speculative),
        "jobs": sorted(rep.job_times),
    }


def conformance_cell(app: str, n_sites: int, schedule: str, backend, **knobs) -> dict:
    """One (app, schedule) cell on one backend: digest + fingerprint.
    ``knobs`` are :func:`run_app`'s compute-path keywords."""
    run = run_app(app, n_sites, schedule, backend, **knobs)
    return {
        "app": app,
        "schedule": schedule,
        "backend": run.backend,
        "digest": result_digest(app, run),
        "fingerprint": schedule_fingerprint(run.report),
    }


def job_sites(app: str, n_sites: int) -> dict[str, int]:
    """job name -> pre-assigned site for one app's DAG (the ownership
    audit needs it to check each SITE's jobs land on one process)."""
    spec = get_workload(app)
    xs, dbs = make_inputs(n_sites)
    data = xs if spec.dataset_kind == "points" else dbs
    ctx = RunContext(measured={}, count_backend="torch", use_kernel=False, device=torch.device("cpu"))
    jobs, _ = spec.build_jobs(data, spec.resolve(_conf_params(app)), ctx)
    return {j.name: int(j.site) for j in jobs}


# ---------------------------------------------------------------------------
# Multi-host conformance child (one process of a gloo group)
# ---------------------------------------------------------------------------

MARKER = "MULTIHOST_CONFORMANCE "


def child_main(argv=None) -> dict:
    """Run every conformance cell through the multihost backend AND the
    inline baseline in THIS process; print one JSON report."""
    from repro_torch.runtime.backends import MultiHostBackend

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--sites", type=int, required=True)
    ap.add_argument("--apps", default=",".join(APPS))
    ap.add_argument("--schedules", default=",".join(SCHEDULES))
    # --fuse 1 (default) = wave-fused shipping (one collective per ready
    # wave); --fuse 0 = one collective per executed job.  Both modes must
    # produce bit-identical digests.
    ap.add_argument("--fuse", type=int, default=1, choices=(0, 1))
    ap.add_argument("--device", default=None, help="where the sites compute (default: the CUDA card)")
    ap.add_argument("--count-backend", default="torch", choices=("torch", "kernel"),
                    help="support counting, and the K-Means assignment: the CUDA kernels or the plain path")
    ap.add_argument("--init-centers", default=None,
                    help=".npy of vclustering's per-site (S, k_local, D) starting centres")
    # with --count-backend kernel, --block auto runs the matrix with the
    # autotuned launches of the mining kernels
    ap.add_argument("--block", default=None, choices=("default", "auto"),
                    help="the kernel wrappers' block mode for every run (default: the module's)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    torch.set_num_threads(1)  # several ranks share the host's cores
    init = np.load(args.init_centers) if args.init_centers else None
    be = MultiHostBackend(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=args.nprocs,
        process_id=args.pid,
        fuse_waves=bool(args.fuse),
    )
    report = {
        "pid": args.pid,
        "n_sites": args.sites,
        "fuse_waves": bool(args.fuse),
        "topology": be.describe(),
        "cells": [],
    }
    knobs = {
        "count_backend": args.count_backend,
        "use_kernel": args.count_backend == "kernel",
        "device": device,
        "init_centers": init,
        "block": args.block,
    }
    for app in args.apps.split(","):
        for schedule in args.schedules.split(","):
            mh = conformance_cell(app, args.sites, schedule, be, **knobs)
            mh["executed"] = list(be.executed_log)
            mh["shipped"] = sorted(be.shipped_log)
            mh["owned_sites"] = list(be._partition.owned_sites if be._partition is not None else [])
            mh["job_sites"] = job_sites(app, args.sites)
            # the collective/shipment ledger for this cell: under wave
            # fusion shipments must equal waves (O(waves) collectives);
            # per-job mode ships once per executed job
            mh["ledger"] = dict(be.ledger(), waves=int(be.waves))
            inline = conformance_cell(app, args.sites, schedule, "inline", **knobs)
            report["cells"].append({"multihost": mh, "inline": inline})

    # fault injection under true distribution: a seeded injected failure
    # retries identically on every process, the shipment collectives stay
    # in lockstep, and the result still matches the inline run under the
    # same faults
    fault = {"cluster_1": 1}
    run_mh = run_app("vclustering", args.sites, "staged", be, faults=FaultInjector(fail=fault), **knobs)
    run_in = run_app("vclustering", args.sites, "staged", "inline", faults=FaultInjector(fail=fault), **knobs)
    report["fault_cell"] = {
        "retries_mh": int(run_mh.report.retries),
        "retries_inline": int(run_in.report.retries),
        "digest_mh": result_digest("vclustering", run_mh),
        "digest_inline": result_digest("vclustering", run_in),
        "executed": list(be.executed_log),
        "n_processes": int(run_mh.n_processes),
        "owned_sites": list(run_mh.owned_sites or []),
    }
    from repro_torch.kernels import autotune

    report["autotune"] = autotune.cache_stats()  # the searches the cells' launches made
    print(MARKER + json.dumps(report), flush=True)
    torch.distributed.destroy_process_group()
    return report


if __name__ == "__main__":
    child_main()
