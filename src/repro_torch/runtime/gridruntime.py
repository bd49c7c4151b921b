"""GridRuntime — execute the paper's mining applications on the card
through the simulated grid.

The paper's central measurement is the gap between what a grid workflow
engine *spends* (preparation, submission, staging) and what the mining
itself *costs*.  This runtime closes the loop: every ``workflow.dag.Job``
maps onto site-local compute on the runtime's device (the hand-written
CUDA support-count kernels for the support counting of GFM, FDM and
count distribution, the K-Means assignment kernel for vclustering's
local clustering), the clustering's single synchronization runs as a
real gather over a ``launch.mesh`` site mesh — one process a site — when
the process group has one (the bit-identical pooled merge otherwise),
and each job's measured wall time — ended by a CUDA synchronize — feeds
the engine's simulated clock via ``TimedResult``, so reported overhead
percentages are calibrated by real kernels.

    rt = GridRuntime()                        # the CUDA card
    rt = GridRuntime.for_sites(4)             # a site mesh in a 4-process group
    run = rt.run("gfm", sites, {"k": 4, "minsup": 0.01})
    run.result.frequent, run.report.overhead_pct()
    run = rt.run("vclustering", xs, {"k_local": 20, "iters": 20, "seed": 0})
    runs = rt.run_many("fdm", [sites, sites], [{"minsup": 0.01}, {"minsup": 0.02}])
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.core.stats import SuffStats
from repro_torch.core.vclustering import MergeResult, merge_gathered
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.workflow.engine import Engine, RunReport
from repro_torch.workflow.executor import ExecutionBackend
from repro_torch.workflow.overhead import (
    GridModel,
    estimate_dag,
    estimate_stages_from_specs,
    overhead_pct,
)
from repro_torch.workflow.placement import resolve_placement
from repro_torch.workflow.registry import SPLIT_PARAM_NAMES, RunContext, WorkloadSpec, get_workload
from repro_torch.workflow.sitejob import job_specs, merge_owner_times


def _backend_differs(backend: str | ExecutionBackend, engine: Engine) -> bool:
    """Whether a requested backend requires rebuilding the engine.  An
    instance is honored by IDENTITY (a configured BatchedBackend with a
    custom min_batch must not be silently dropped just because its name
    matches); a name is compared as a string — no throwaway instance."""
    if isinstance(backend, ExecutionBackend):
        return backend is not engine.backend
    return backend != engine.backend.name


@dataclass
class RuntimeRun:
    """One application run: the mining result, the engine's grid report,
    and the runtime's own per-job device-time measurements (the numbers
    that were fed into the simulated clock)."""

    result: Any
    report: RunReport
    measured: dict[str, float] = field(default_factory=dict)
    sync_mode: str = "pooled"  # how the single synchronization executed
    schedule: str = "staged"  # which engine scheduler executed the DAG
    placement: str = "fixed"  # which matchmaking policy placed the jobs
    backend: str = "inline"  # which execution backend ran the callables
    # multi-host ownership (multihost backend): how many processes
    # cooperated, and which grid sites THIS process executed — None means
    # the run was not partitioned (every job ran locally)
    n_processes: int = 1
    owned_sites: tuple | None = None
    # the analytical view of the DAG that was actually executed (deps,
    # bytes, the sites the policy actually chose, measured compute) —
    # feed to overhead.estimate_* or sitejob.replay_dag
    specs: list = field(default_factory=list)
    # analytical bounds (paper §5.2.2), calibrated by the measured job
    # times: per-job critical path (the async ideal) and the stage-barrier
    # formula (the staged ideal)
    estimated_s: float = 0.0
    estimated_staged_s: float = 0.0

    def est_overhead_pct(self) -> float:
        """Table 3's 'Estimated overhead': measured wall vs the analytical
        bound matching this run's schedule mode."""
        est = self.estimated_s if self.schedule == "async" else self.estimated_staged_s
        return overhead_pct(self.report.wall_s, est)


@dataclass
class FusedRun:
    """One request's slice of a cross-request fused run
    (:meth:`GridRuntime.run_many`): its own mining result, its share of
    the measured device compute (summed from the merged report's per-job
    times under this request's name prefix), and the shared
    :class:`RunReport` of the ONE engine invocation that served every
    member."""

    result: Any
    compute_s: float
    backend: str
    report: RunReport


def _grid_workload(app: str) -> WorkloadSpec:
    spec = get_workload(app)
    if spec.runner != "grid":
        raise ValueError(
            f"app {app!r} is a {spec.runner!r} workload, not a grid DAG; "
            "serve it through launch.serve.MiningService"
        )
    return spec


def _resolve_grid(spec: WorkloadSpec, params: dict | None) -> dict:
    """The spec's resolved params, refusing the service's split params:
    the runtime is handed sites already split, so there they would be
    knobs that do nothing."""
    given = [k for k in (params or {}) if k in SPLIT_PARAM_NAMES]
    if given:
        known = tuple(n for n in spec.schema() if n not in SPLIT_PARAM_NAMES)
        raise ValueError(
            f"app {spec.name!r}: {given[0]!r} splits the mining service's dataset into sites, and "
            f"GridRuntime takes sites already split; known params here: {known}"
        )
    return spec.resolve(params)


class GridRuntime:
    """Maps SiteJobs from the core algorithms onto one grid scheduler, with
    every site's data and compute on one device.

    ``device`` is where the site data lives and the kernels run: None
    means the CUDA card (a host without one raises; pass ``device="cpu"``
    to run the plain PyTorch path there).  ``count_backend`` selects the
    support counting: ``"kernel"`` (the CUDA kernels; on the CPU their
    wrappers run the plain versions) or ``"torch"`` (the plain path).
    ``use_kernel`` does the same for the K-Means assignment: the CUDA
    kernel, or the matmul form followed by argmin.

    ``sync`` selects how the clustering synchronization runs:
      * "auto" (default): a gather over a site mesh (``mesh``, or one
        ``launch.mesh.make_site_mesh`` builds over the process group) when
        one with a site-sized ``axis`` exists, else the pooled merge;
      * "shard_map": require the mesh (raises without one);
      * "pooled": the in-process merge of the gathered statistics.
    Both are bit-identical — the logical merge is deterministic on the
    gathered statistics (the paper's redundant "logical merging").  The
    mesh mode keeps the JAX package's name, so ``run.sync_mode ==
    "shard_map"`` reads the same in both packages.  On the mesh every
    process runs the whole DAG (the SPMD-redundant mode: an inline or
    batched backend, or ``MultiHostBackend(partition_sites=False)``) and
    the merge job's gather is a collective each process enters once a
    run, in job order.
    """

    def __init__(
        self,
        engine: Engine | None = None,
        count_backend: str = "kernel",
        schedule: str | None = None,
        placement: str | None = None,
        backend: str | ExecutionBackend | None = None,
        device: str | torch.device | None = None,
        use_kernel: bool = True,
        mesh: mesh_mod.SiteMesh | None = None,
        axis: str = "sites",
        sync: str = "auto",
    ):
        if sync not in ("auto", "shard_map", "pooled"):
            raise ValueError(f"unknown sync mode {sync!r}")
        # ``schedule`` / ``placement`` / ``backend`` thread the engine's
        # scheduler mode ("staged" | "async"), matchmaking policy
        # ("fixed" | "round_robin" | "random" | "greedy_eta") and
        # execution backend ("inline" | "batched" | "multihost") through
        # the runtime;
        # None keeps the given engine's own settings (or the Engine
        # defaults) untouched.  A caller-supplied engine is never mutated —
        # a differing setting gets an equivalent engine.  Runtime-built
        # engines default to the BATCHED backend: one fused launch per
        # fan-out, bit-identical to inline.
        self.device = resolve_device(device)
        if engine is None:
            engine = Engine(
                model=GridModel(),
                overlap_prep=True,
                schedule=schedule or "staged",
                placement=placement or "fixed",
                backend=backend or "batched",
            )
        elif (
            (schedule is not None and engine.schedule != schedule)
            or (placement is not None and resolve_placement(engine.placement).name != placement)
            or (backend is not None and _backend_differs(backend, engine))
        ):
            engine = Engine(
                model=engine.model,
                faults=engine.faults,
                rescue_path=engine.rescue_path,
                overlap_prep=engine.overlap_prep,
                straggler_factor=engine.straggler_factor,
                schedule=schedule or engine.schedule,
                placement=placement if placement is not None else engine.placement,
                backend=backend if backend is not None else engine.backend,
                trace=engine.trace,
            )
        self.engine = engine
        self.count_backend = count_backend
        self.use_kernel = use_kernel
        self.mesh = mesh
        self.axis = axis
        self.sync = sync

    @classmethod
    def for_sites(cls, n_sites: int, **kw) -> "GridRuntime":
        """Runtime with a ``launch.mesh`` site mesh when the process group
        has one process a site (otherwise mesh=None and the pooled merge
        is used, unless a group is up by the first run)."""
        return cls(mesh=mesh_mod.make_site_mesh(n_sites, kw.get("axis", "sites"), kw.get("device")), **kw)

    def _bring_up(self) -> None:
        """A distributed backend joins its process group before the
        engine partitions a run and before the sync mode is chosen, so a
        failed rendezvous fails before any site data is built."""
        ensure = getattr(self.engine.backend, "ensure_initialized", None)
        if ensure is not None:
            ensure()

    # -- synchronization strategies -----------------------------------------

    def _cluster_sync(self, n_sites: int, cfg):
        """Returns (sync_fn, mode) for the merge job."""
        if getattr(self.engine.backend, "partition_sites", False) and mesh_mod.process_count() > 1:
            # A site-PARTITIONED multi-process run executes the merge job
            # on ONE owning process, so its sync must not be a collective
            # over the mesh (entered from one process, it would strand the
            # others).  The pooled merge is bit-identical, and the shipped
            # result reaches every process.
            if self.sync == "shard_map":
                raise RuntimeError(
                    "sync='shard_map' is not supported on a site-partitioned "
                    "multi-process runtime: the merge job executes on its "
                    "owning process only; use sync='pooled' (bit-identical "
                    "logical merge) or MultiHostBackend(partition_sites=False)"
                )
            return None, "pooled"
        site_mesh = self.mesh
        if self.sync != "pooled" and site_mesh is None:
            site_mesh = mesh_mod.make_site_mesh(n_sites, self.axis, self.device)
        usable = (
            site_mesh is not None
            and self.axis in site_mesh.shape
            and site_mesh.shape[self.axis] == n_sites
        )
        if self.sync == "shard_map" and not usable:
            raise RuntimeError(
                f"shard_map sync requires a mesh with {self.axis}={n_sites} "
                f"(have {dict(site_mesh.shape) if site_mesh is not None else None})"
            )
        if self.sync == "pooled" or not usable:
            return None, "pooled"  # vcluster_site_jobs defaults to merge_gathered

        def sync(per_site: SuffStats) -> MergeResult:
            # this process contributes its own site's triple; the gather is
            # the protocol's single communication, and the merge on the
            # runtime's device is the paper's redundant logical merge
            i = site_mesh.coordinate()
            mine = SuffStats(sizes=per_site.sizes[i], centers=per_site.centers[i], sse=per_site.sse[i])
            g = mesh_mod.allgather_stats(mine, site_mesh)
            return merge_gathered(SuffStats(*(t.to(self.device) for t in g)), cfg)

        return sync, "shard_map"

    # -- applications --------------------------------------------------------

    def _finish_run(self, jobs, rep: RunReport, result, measured, sync_mode: str) -> RuntimeRun:
        """Attach the measured-time-calibrated analytical bounds to a run.
        The specs carry the sites the placement policy ACTUALLY chose
        (``rep.placements``), so the bounds price the executed assignment
        rather than the sites the DAG pre-assigned."""
        if rep.owned_jobs is not None:
            # partitioned (multi-host) run: this process only measured its
            # OWNED jobs — complete the record with the owner-measured
            # times the engine ledgered from shipped results, so
            # job_specs(strict=True) and the estimators see one
            # owner-authoritative time per job on every process
            measured = merge_owner_times(measured, rep.job_times, rep.owned_jobs)
        specs = job_specs(jobs, rep.job_times)
        if rep.placements:
            specs = [sp._replace(site=rep.placements.get(sp.name, sp.site)) for sp in specs]
        model = self.engine.model
        return RuntimeRun(
            result=result,
            report=rep,
            measured=measured,
            sync_mode=sync_mode,
            schedule=rep.schedule,
            placement=rep.placement,
            backend=rep.backend,
            n_processes=rep.n_processes,
            owned_sites=rep.owned_sites,
            specs=specs,
            estimated_s=estimate_dag(specs, model),
            estimated_staged_s=estimate_stages_from_specs(specs, model),
        )

    def run(self, app: str, data, params: dict | None = None) -> RuntimeRun:
        """Run ANY registered grid workload: the registry's
        :class:`~repro_torch.workflow.registry.WorkloadSpec` resolves the
        params, builds the SiteJob DAG and names the terminal job; this
        method supplies the runtime context (count backend, kernel toggle,
        device) and the engine.  A ``"local"`` workload has no DAG: the
        mining service serves it."""
        spec = _grid_workload(app)
        p = _resolve_grid(spec, params)
        self._bring_up()
        measured: dict[str, float] = {}
        ctx = RunContext(
            measured=measured,
            count_backend=self.count_backend,
            use_kernel=self.use_kernel,
            device=self.device,
            cluster_sync=self._cluster_sync,
        )
        jobs, mode = spec.build_jobs(data, p, ctx)
        rep, results = self.engine.run_site_jobs(jobs, name=spec.name)
        return self._finish_run(jobs, rep, results[spec.terminal], measured, mode)

    def run_many(self, app: str, datas: list, params_list: list) -> list[FusedRun]:
        """Run SEVERAL same-app requests as ONE engine invocation — the
        cross-request batching seam.

        Each request's SiteJob DAG is built independently (its own
        resolved params, its own ``RunContext`` on the runtime's device,
        its own closures and ledgers) and merged into one job list under a
        ``r{j}/`` name prefix; ``batch_key``s are left UNPREFIXED, so
        same-shape fan-out jobs from different requests land in the same
        wave groups and the batched backend executes them as one fused
        launch over every request's sites (the ``*_site_jobs`` batch args carry
        every request-specific value — thresholds, seeds, initial
        centres, delta states — so the first member's closure can serve
        the whole merged group).

        The caller's contract: the requests share one dataset and differ
        only in the values the batch args carry per member (``minsup`` for
        the itemset miners; ``seed`` or ``init_centers`` for
        vclustering).  Anything that changes job shapes (``k``,
        ``k_local``, ``iters``, the site split) belongs in separate calls.

        Returns one :class:`FusedRun` per request, in order: its own
        terminal result plus its measured device-compute share (the sum
        of the merged report's per-job times under its prefix).
        """
        spec = _grid_workload(app)
        if len(datas) != len(params_list):
            raise ValueError(f"run_many: {len(datas)} datasets vs {len(params_list)} param sets")
        self._bring_up()
        all_jobs: list = []
        modes: list[str] = []
        for j, (data, params) in enumerate(zip(datas, params_list)):
            p = _resolve_grid(spec, params)
            ctx = RunContext(
                measured={},
                count_backend=self.count_backend,
                use_kernel=self.use_kernel,
                device=self.device,
                cluster_sync=self._cluster_sync,
            )
            jobs, mode = spec.build_jobs(data, p, ctx)
            modes.append(mode)
            prefix = f"r{j}/"
            for job in jobs:
                job.name = prefix + job.name
                job.deps = [prefix + d for d in job.deps]
            all_jobs.extend(jobs)
        if len(set(modes)) > 1:
            raise RuntimeError(f"run_many: requests resolved to different sync modes {modes}")
        if modes and modes[0] == "shard_map" and len(modes) > 1 and self.engine.schedule == "async":
            # the async scheduler starts each member's merge when its own
            # sites finish on the simulated clock, which every process
            # advances by its own measured times: the members' gathers
            # could meet in another order on another process
            raise RuntimeError(
                "run_many with the shard_map sync needs schedule='staged': the async scheduler "
                "orders the members' merge gathers by each process's own measured times; "
                "use schedule='staged' or sync='pooled'"
            )
        rep, results = self.engine.run_site_jobs(all_jobs, name=f"{spec.name}x{len(datas)}")
        outs: list[FusedRun] = []
        for j in range(len(datas)):
            prefix = f"r{j}/"
            compute = sum(t for name, t in rep.job_times.items() if name.startswith(prefix))
            outs.append(
                FusedRun(
                    result=results[prefix + spec.terminal],
                    compute_s=compute,
                    backend=rep.backend,
                    report=rep,
                )
            )
        return outs

    def run_gfm(
        self, sites, k: int, minsup: float, local_minsup: float | None = None
    ) -> RuntimeRun:
        """Algorithm 2 end-to-end: per-site local Apriori (CUDA support
        counting by default), then the single 2-pass synchronization and
        top-down descent, scheduled through the grid engine."""
        return self.run(
            "gfm", sites, {"k": k, "minsup": minsup, "local_minsup": local_minsup}
        )

    def run_fdm(self, sites, k: int, minsup: float) -> RuntimeRun:
        """FDM baseline through the same scheduler (k level-synchronous
        rounds) — the comparison the paper draws against GFM."""
        return self.run("fdm", sites, {"k": k, "minsup": minsup})

    def run_vclustering(self, xs, cfg=None, seed: int = 0, init_centers=None) -> RuntimeRun:
        """Algorithm 1 end-to-end: per-site K-Means (the CUDA assignment
        kernel by default) -> gather + logical merge -> per-site border
        perturbation, scheduled through the grid engine.  ``xs`` is an
        (S, n, D) numpy array or tensor, moved to the runtime's device;
        ``cfg`` defaults to ``VClusterConfig()``; the kernel choice is the
        runtime's ``use_kernel`` either way."""
        if cfg is None:
            from repro_torch.core.vclustering import VClusterConfig

            cfg = VClusterConfig()
        return self.run("vclustering", xs, {"cfg": cfg, "seed": seed, "init_centers": init_centers})
