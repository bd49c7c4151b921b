"""Pluggable execution backends — HOW the device executes what the
scheduler decides.

The engine's schedulers (staged / async) decide WHEN each job becomes
eligible and WHERE it runs (placement); an :class:`ExecutionBackend`
decides HOW the job's callable actually executes on the hardware.  The
split is the layer the paper attributes most lost performance to: the S
site-local mining jobs of every fan-out stage (``cluster_i``,
``apriori_i``, ``recount_i``, ``perturb_i``) are embarrassingly parallel
on the simulated grid, but a host Python loop dispatching them
one-at-a-time serializes them on the device.

Backends:

  * ``inline`` (the bare ``Engine`` default) — the reference behavior,
    bit-for-bit: each job's ``fn`` is called in scheduler order, one
    dispatch per job.
  * ``batched`` (the ``GridRuntime`` default) — groups ready
    shape-identical fan-out jobs by their ``batch_key`` and dispatches
    ONE fused call across the site axis (one kernel launch for every
    site) via the group's ``batched_fn``, then apportions the
    measured batch wall time equally per job — so the simulated grid
    clock, ``RunReport.job_times`` and the ``overhead.estimate_dag``
    calibration stay honest: each site's job is credited what one
    site's share of the fused call cost, which is what a real grid
    site would have spent.
  * ``multihost`` (``repro_torch.runtime.backends.MultiHostBackend``) —
    site-partitioned execution over a ``torch.distributed`` process group
    (gloo): grid sites are partitioned over the processes
    (``launch.mesh.site_ownership``), each process executes ONLY its
    owned jobs, and their results ship to every process through
    ``all_gather`` — the paper's site-partitioned deployment, with result
    shipping as the only cross-process traffic.

The scheduler contract is :meth:`ExecutionBackend.call` (replacing the
engine's direct ``job.fn(*args)`` invocation inside ``Engine._attempt``)
plus the optional :meth:`ExecutionBackend.partition` ownership hook.
Everything else — fault injection, retries, rescue files, speculation,
the simulated clock — is scheduler policy and stays in the engine,
identical across backends.

"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.workflow.dag import DAG, Job, TimedResult

BACKENDS = ("inline", "batched", "multihost")


def ready_wave(dag: DAG, results: dict, skip=()) -> list[Job]:
    """The ready wave as a backend sees it mid-run: every job that has
    not yet executed (``status != "done"`` and not already pre-executed
    into ``skip``) whose dependency results are ALL available.

    This is the wave-grouping hook shared by the dispatch-fusing
    backends: because both engine schedulers invoke ``call`` in an order
    that is deterministic on (dag, model, seeds, measured times), every
    process of a distributed run computes the identical wave at the
    identical ``call`` — which is what lets the multihost backend ship a
    whole wave in one collective.  Insertion (scheduler) order.
    """
    return [
        j
        for j in dag.jobs.values()
        if j.status != "done"
        and j.name not in skip
        and all(d in results for d in j.deps)
    ]


def group_wave(wave: list[Job]) -> list[list[Job]]:
    """Split a ready wave into fused-dispatch groups: jobs sharing a
    ``batch_key`` (with a ``batched_fn``) form one group — ONE fused
    dispatch covers them — and every other job is its own singleton
    group.  Group order follows each group's first member (insertion
    order), so grouping is deterministic everywhere."""
    groups: dict[Any, list[Job]] = {}
    for j in wave:
        key = ("batch", j.batch_key) if j.batch_key is not None and j.batched_fn is not None else ("solo", j.name)
        groups.setdefault(key, []).append(j)
    return list(groups.values())


@dataclass(frozen=True)
class Partition:
    """How a distributed backend splits one DAG over its processes.

    ``owned`` names the jobs THIS process executes; ``owner_of`` maps
    every job to its owning process id.  The engine still schedules the
    whole DAG locally — placement, the simulated clock and the ledger
    are global state and must stay identical on every process — but only
    owned jobs' callables run here; the rest arrive as owner-measured
    shipped results through ``ExecutionBackend.call``.
    """

    owned: frozenset[str]
    owner_of: dict[str, int]
    n_processes: int
    process_index: int
    owned_sites: tuple[int, ...]


class ExecutionBackend:
    """Executes job callables for the workflow engine.

    ``begin_run`` is called once per ``Engine.run`` with the DAG and the
    shared results dict (the backend may inspect both to find co-batchable
    peers); ``call`` replaces the engine's direct ``job.fn(*args)``.
    Whatever ``call`` returns flows through the engine's TimedResult
    handling unchanged.

    ``partition`` (called once per run, after ``begin_run``) lets a
    distributed backend declare per-process job ownership: return a
    :class:`Partition` and the engine will require every non-owned job's
    ``call`` to return an owner-measured ``TimedResult`` (a host-side
    bracket around a job that executed elsewhere would poison the
    globally-consistent clock).  The default — every job local — returns
    None.
    """

    name = "?"

    def begin_run(self, dag: DAG, results: dict) -> None:
        return None

    def partition(self, dag: DAG, model=None) -> Partition | None:
        return None

    def ledger(self) -> dict | None:
        """Per-run collective/shipment ledger (distributed backends):
        ``{"shipments", "collective_rounds", "shipped_results"}`` counts
        accumulated since ``begin_run``.  The engine copies a non-None
        ledger onto ``RunReport`` so the O(jobs) -> O(waves) collective
        reduction is measurable per run, not asserted by hand.  Local
        backends return None (no collectives to count)."""
        return None

    def call(self, job: Job, args: list) -> Any:
        raise NotImplementedError


class InlineBackend(ExecutionBackend):
    """The sequential host loop: one dispatch per job, in scheduler
    order — the engine's original behavior, kept as the default and the
    baseline every other backend is gated against (bit-for-bit)."""

    name = "inline"

    def call(self, job: Job, args: list) -> Any:
        return job.fn(*args)


class BatchedBackend(ExecutionBackend):
    """Fused site-compute: when a job carries a ``batch_key`` and a
    ``batched_fn``, every not-yet-executed job with the same key whose
    dependencies are all available is executed in ONE fused call, and
    the results are cached for the peers' turns.

    The group's ``batched_fn`` receives ``(names, batch_args, argss)``
    (one entry per member, scheduler order) and returns one
    ``TimedResult`` per member — the ``sitejob.timed_batch`` helper
    measures the fused call once and apportions the wall time equally,
    which is the honest per-site calibration for shape-identical jobs
    (a fused fan-out does the same total work as the serial loop, so
    one member's share IS one site's cost).

    Correctness notes:
      * peers are only pre-executed when every dependency result is
        already available, so dependency order is preserved exactly;
      * a group smaller than ``min_batch`` (default 2) falls back to the
        jobs' own ``fn`` — no fused-call overhead for one job; ``min_batch=1``
        forces even singletons through ``batched_fn`` (profiling the
        fused path);
      * DAGMan fault injection happens in the engine BEFORE ``call``,
        so an injected retry simply consumes the cached result on the
        next attempt (batched_fn never re-executes).
    """

    name = "batched"

    def __init__(self, min_batch: int = 2):
        if min_batch < 1:
            raise ValueError(f"min_batch must be >= 1, got {min_batch}")
        self.min_batch = min_batch
        self._dag: DAG | None = None
        self._results: dict | None = None
        self._cache: dict[str, Any] = {}

    def begin_run(self, dag: DAG, results: dict) -> None:
        self._dag = dag
        self._results = results
        self._cache.clear()

    def _peers(self, job: Job) -> list[Job]:
        """The co-batchable group: same batch_key, not yet executed, all
        dependency results available — i.e. this job's group within the
        current ready wave (``ready_wave``/``group_wave``).  Scheduler
        (insertion) order — deterministic."""
        assert self._dag is not None and self._results is not None
        wave = ready_wave(self._dag, self._results, skip=self._cache)
        for group in group_wave(wave):
            if any(j.name == job.name for j in group):
                return group
        return [job]  # pragma: no cover - the requested job is always in the wave

    def call(self, job: Job, args: list) -> Any:
        if job.name in self._cache:
            return self._cache.pop(job.name)
        if job.batch_key is None or job.batched_fn is None or self._dag is None:
            return job.fn(*args)
        batch = self._peers(job)
        if len(batch) < self.min_batch:
            return job.fn(*args)
        assert self._results is not None
        argss = [[self._results[d] for d in j.deps] for j in batch]
        outs = job.batched_fn([j.name for j in batch], [j.batch_arg for j in batch], argss)
        if len(outs) != len(batch):
            raise RuntimeError(
                f"batched_fn for {job.batch_key!r} returned {len(outs)} results "
                f"for {len(batch)} jobs"
            )
        for j, out in zip(batch, outs):
            self._cache[j.name] = out
        return self._cache.pop(job.name)


def resolve_backend(backend: str | ExecutionBackend | None) -> ExecutionBackend:
    """Resolve a backend name (or pass through an instance).  Unknown
    names raise with the valid set, mirroring the engine's schedule and
    placement validation.  ``multihost`` imports lazily from
    ``repro_torch.runtime.backends`` (an import cycle otherwise)."""
    if backend is None:
        return InlineBackend()
    if isinstance(backend, ExecutionBackend):
        return backend
    if backend == "inline":
        return InlineBackend()
    if backend == "batched":
        return BatchedBackend()
    if backend == "multihost":
        from repro_torch.runtime.backends import MultiHostBackend  # import cycle guard

        return MultiHostBackend()
    raise ValueError(
        f"unknown backend {backend!r}; expected one of {BACKENDS} or an ExecutionBackend"
    )


__all__ = [
    "BACKENDS",
    "BatchedBackend",
    "ExecutionBackend",
    "InlineBackend",
    "Partition",
    "TimedResult",
    "group_wave",
    "ready_wave",
    "resolve_backend",
]
