"""SiteJob — the shared unit of site-local mining work.

Both of the paper's applications (variance-based clustering and GFM/FDM
itemset mining) decompose into the same shape: a stage of per-site compute
jobs, a synchronization job over their outputs, and optionally more
per-site work.  ``SiteJob`` is that contract: the core algorithm modules
(`core.vclustering`, `core.gfm`, `core.fdm`) emit lists of SiteJobs, and
one scheduler — ``workflow.engine.Engine`` — executes any of them through
the same DAGMan-analog grid model.

``timed`` wraps a site job's callable so the engine's simulated clock is
fed the *measured* device compute time: on a CUDA device the bracket ends
with ``torch.cuda.synchronize()``, so queued kernels cannot hide from it.
"""

from __future__ import annotations

import functools
import time
import warnings
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.workflow.dag import DAG, Job, TimedResult
from repro_torch.workflow.overhead import JobSpec


class MissingJobTimeWarning(UserWarning):
    """A job fed to ``job_specs`` has no measured time — its analytical
    compute defaults to 0.0, which silently miscalibrates estimates."""


@dataclass
class SiteJob:
    """One unit of site-local (or synchronization) work.

    ``fn`` receives the results of ``deps`` in order and does the real
    compute; ``site`` indexes into the grid model's link matrix for the
    staging-cost simulation; byte counts size the staged transfers.
    """

    name: str
    fn: Callable[..., Any]
    deps: list[str] = field(default_factory=list)
    site: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    retries: int = 2
    # fused-execution hooks (``workflow.executor.BatchedBackend``): jobs
    # sharing a ``batch_key`` are one shape-identical fan-out group;
    # ``batched_fn(names, batch_args, argss)`` executes the whole group
    # in one fused (site-axis) call and returns one TimedResult per member
    # (see ``timed_batch``); ``batch_arg`` is this member's payload —
    # for the site-job factories, the site index
    batch_key: str | None = None
    batched_fn: Callable[..., Any] | None = None
    batch_arg: Any = None

    def to_job(self) -> Job:
        return Job(
            name=self.name,
            fn=self.fn,
            deps=list(self.deps),
            site=self.site,
            input_bytes=self.input_bytes,
            output_bytes=self.output_bytes,
            retries=self.retries,
            batch_key=self.batch_key,
            batched_fn=self.batched_fn,
            batch_arg=self.batch_arg,
        )


def _sync_fn(device) -> Callable[[], None]:
    """What ends a measurement on ``device``: a CUDA synchronize, so that
    queued kernels are inside the bracket; nothing elsewhere."""
    if device is not None and torch.device(device).type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def timed(
    fn: Callable[..., Any],
    record: dict[str, float] | None = None,
    name: str = "",
    device: str | torch.device | None = None,
) -> Callable[..., Any]:
    """Wrap ``fn`` to return a TimedResult with device-measured compute.

    On a CUDA ``device`` the measurement ends with a synchronize, so
    asynchronous launches cannot hide compute from the clock.  When
    ``record`` is given the measurement is also stored under ``name`` —
    the runtime uses this to cross-check the engine's ledger.
    """
    sync = _sync_fn(device)

    @functools.wraps(fn)
    def wrapper(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        dt = time.perf_counter() - t0
        if record is not None:
            record[name or getattr(fn, "__name__", "job")] = dt
        return TimedResult(out, dt)

    return wrapper


def timed_batch(
    fused_fn: Callable[..., list],
    record: dict[str, float] | None = None,
    device: str | torch.device | None = None,
    owned: Callable[[str], bool] | None = None,
) -> Callable[..., list]:
    """Wrap a fused group executor into a ``batched_fn`` for the batched
    execution backend.

    ``fused_fn(batch_args, argss) -> list`` computes every member's
    result in one call (one launch across the site axis).  The wrapper
    measures the fused call ONCE (ending with a synchronize on a CUDA
    ``device``, like ``timed``) and apportions the wall time equally
    across the members — the honest per-site calibration for
    shape-identical fan-out jobs, since the fused call does the same total
    work the serial per-site loop would.  Each member's share is recorded
    in ``record`` (the runtime's cross-check ledger) and returned as its
    ``TimedResult``, so the engine's simulated clock, job_times, and the
    analytical estimators see per-job times exactly as they do on the
    inline backend.

    ``owned`` enforces OWNER-ONLY timing for multi-process execution:
    when given, only member names it accepts are recorded — a fused group
    that (redundantly) covers jobs owned by another process must not
    write process-local shares for them, or the record would diverge from
    the owner-measured times the engine's global ledger carries.  The
    returned TimedResults are unaffected (the execution backend decides
    which of them ship).
    """
    sync = _sync_fn(device)

    def batched(names: list[str], batch_args: list, argss: list) -> list:
        t0 = time.perf_counter()
        outs = fused_fn(batch_args, argss)
        sync()
        share = (time.perf_counter() - t0) / max(len(names), 1)
        if record is not None:
            for name in names:
                if owned is None or owned(name):
                    record[name] = share
        return [TimedResult(out, share) for out in outs]

    return batched


def merge_owner_times(
    measured: dict[str, float],
    job_times: dict[str, float],
    owned: tuple | frozenset | list | None,
) -> dict[str, float]:
    """Normalize a per-process ``measured`` record against the engine's
    globally-consistent ledger for a partitioned (multi-host) run.

    Under true site ownership a process only executes — and therefore
    only records — its OWNED jobs; every other job's time exists solely
    as the owner-measured value shipped with its result, which the engine
    ledgers in ``RunReport.job_times``.  Feeding the partial local record
    straight into ``job_specs(strict=True)`` would raise on every
    non-owned job, so this helper completes it from the ledger — and, for
    jobs that WERE recorded locally, keeps the local measurement only if
    it is actually this process's own (``owned``; stale entries for jobs
    owned elsewhere — the redundant-execution hazard — are overwritten
    with the authoritative shipped times).

    An ``owned`` entry naming a job the ledger has never heard of is a
    caller bug (a stale partition, a typo'd name) that would otherwise
    pass silently — so it raises, naming the stray entries.
    """
    owned_set = set(owned) if owned is not None else None
    if owned_set is not None:
        stray = sorted(str(n) for n in owned_set - set(job_times))
        if stray:
            raise ValueError(
                f"merge_owner_times: {len(stray)} owned job name(s) not in the "
                f"job_times ledger: {', '.join(stray[:5])}"
                + ("..." if len(stray) > 5 else "")
            )
    out = dict(measured)
    for name, dt in job_times.items():
        if name not in out or (owned_set is not None and name not in owned_set):
            out[name] = dt
    return out


def build_dag(site_jobs: list[SiteJob], name: str = "site-jobs") -> DAG:
    """Assemble SiteJobs into an executable DAG (insertion order must be
    topological, as with ``DAG.add``).  Duplicate job names and unknown
    or self dependencies are rejected by ``DAG.add`` with the offending
    job named — which also makes a cycle unconstructible here; cycles
    introduced by later mutation are caught by ``DAG.validate_acyclic``
    at run time."""
    dag = DAG(name)
    for sj in site_jobs:
        dag.add(sj.to_job())
    return dag


def replay_dag(specs: list[JobSpec], job_times: dict[str, float] | None = None) -> DAG:
    """Rebuild a workflow topology as a pure-simulation DAG: trivial jobs
    whose simulated compute is the recorded measurement (``job_times``,
    falling back to each spec's ``compute_s``).  Replaying the same specs
    and times through different engine schedules or link matrices isolates
    the scheduling policy — identical DAG/model/times, zero timing noise —
    which is how the sweep benchmark compares staged vs async fairly."""
    times = job_times or {}
    dag = DAG("replay")
    for sp in specs:
        sim = float(times.get(sp.name, sp.compute_s))
        dag.job(
            sp.name,
            lambda *a: TimedResult(None, 0.0),
            deps=list(sp.deps),
            site=sp.site,
            input_bytes=sp.input_bytes,
            output_bytes=sp.output_bytes,
            sim_compute_s=sim,
        )
    return dag


def job_specs(
    site_jobs: list[SiteJob],
    job_times: dict[str, float] | None = None,
    strict: bool = False,
) -> list[JobSpec]:
    """Strip SiteJobs down to the analytical ``overhead.JobSpec`` view,
    with compute times taken from a run's measured ``RunReport.job_times``
    — the inputs to ``estimate_dag`` / ``estimate_stages_from_specs``, so
    the paper's measured-vs-estimated comparison is calibrated by the same
    kernel timings that fed the simulated clock.

    A job name with no measured time silently feeding ``compute_s=0.0``
    into the estimators is exactly how a calibration goes quietly wrong,
    so missing entries are loud: when ``job_times`` is given but lacks a
    job, a ``MissingJobTimeWarning`` is emitted (or, with
    ``strict=True``, a ``KeyError`` raised — also when ``job_times`` is
    None entirely).  Passing ``job_times=None`` without ``strict`` keeps
    the explicit "no calibration, zero-compute topology view" behavior,
    warning-free."""
    if strict and job_times is None:
        raise KeyError("job_specs(strict=True) requires measured job_times, got None")
    missing = [sj.name for sj in site_jobs if job_times is not None and sj.name not in job_times]
    if missing:
        msg = (
            f"{len(missing)} job(s) have no measured time and default to compute_s=0.0 "
            f"(miscalibrated estimate): {', '.join(missing[:5])}"
            + ("..." if len(missing) > 5 else "")
        )
        if strict:
            raise KeyError(msg)
        warnings.warn(msg, MissingJobTimeWarning, stacklevel=2)
    times = job_times or {}
    return [
        JobSpec(
            name=sj.name,
            deps=tuple(sj.deps),
            compute_s=float(times.get(sj.name, 0.0)),
            input_bytes=sj.input_bytes,
            output_bytes=sj.output_bytes,
            site=sj.site,
        )
        for sj in site_jobs
    ]
