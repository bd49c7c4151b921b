"""GridRuntime — execute the paper's mining applications on the card
through the simulated grid.

The paper's central measurement is the gap between what a grid workflow
engine *spends* (preparation, submission, staging) and what the mining
itself *costs*.  This runtime closes the loop: every ``workflow.dag.Job``
maps onto site-local compute on the runtime's device (the hand-written
CUDA support-count kernels for GFM's local Apriori and recounts, the
K-Means assignment kernel for vclustering's local clustering), and each
job's measured wall time — ended by a CUDA synchronize — feeds the
engine's simulated clock via ``TimedResult``, so reported overhead
percentages are calibrated by real kernels.

    rt = GridRuntime()                        # the CUDA card
    run = rt.run("gfm", sites, {"k": 4, "minsup": 0.01})
    run.result.frequent, run.report.overhead_pct()
    run = rt.run("vclustering", xs, {"k_local": 20, "iters": 20, "seed": 0})
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.workflow.engine import Engine, RunReport
from repro_torch.workflow.executor import ExecutionBackend
from repro_torch.workflow.overhead import (
    GridModel,
    estimate_dag,
    estimate_stages_from_specs,
    overhead_pct,
)
from repro_torch.workflow.placement import resolve_placement
from repro_torch.workflow.registry import RunContext, get_workload
from repro_torch.workflow.sitejob import job_specs


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
    sync_mode: str = "host"  # how the single synchronization executed
    schedule: str = "staged"  # which engine scheduler executed the DAG
    placement: str = "fixed"  # which matchmaking policy placed the jobs
    backend: str = "inline"  # which execution backend ran the callables
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
    ):
        # ``schedule`` / ``placement`` / ``backend`` thread the engine's
        # scheduler mode ("staged" | "async"), matchmaking policy
        # ("fixed" | "round_robin" | "random" | "greedy_eta") and
        # execution backend ("inline" | "batched") through the runtime;
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

    # -- applications --------------------------------------------------------

    def _finish_run(self, jobs, rep: RunReport, result, measured, sync_mode: str) -> RuntimeRun:
        """Attach the measured-time-calibrated analytical bounds to a run.
        The specs carry the sites the placement policy ACTUALLY chose
        (``rep.placements``), so the bounds price the executed assignment
        rather than the sites the DAG pre-assigned."""
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
            specs=specs,
            estimated_s=estimate_dag(specs, model),
            estimated_staged_s=estimate_stages_from_specs(specs, model),
        )

    def run(self, app: str, data, params: dict | None = None) -> RuntimeRun:
        """Run ANY registered grid workload: the registry's
        :class:`~repro_torch.workflow.registry.WorkloadSpec` resolves the
        params, builds the SiteJob DAG and names the terminal job; this
        method supplies the runtime context (count backend, kernel toggle,
        device) and the engine."""
        spec = get_workload(app)
        p = spec.resolve(params)
        measured: dict[str, float] = {}
        ctx = RunContext(
            measured=measured,
            count_backend=self.count_backend,
            use_kernel=self.use_kernel,
            device=self.device,
        )
        jobs, mode = spec.build_jobs(data, p, ctx)
        rep, results = self.engine.run_site_jobs(jobs, name=spec.name)
        return self._finish_run(jobs, rep, results[spec.terminal], measured, mode)

    def run_gfm(
        self, sites, k: int, minsup: float, local_minsup: float | None = None
    ) -> RuntimeRun:
        """Algorithm 2 end-to-end: per-site local Apriori (CUDA support
        counting by default), then the single 2-pass synchronization and
        top-down descent, scheduled through the grid engine."""
        return self.run(
            "gfm", sites, {"k": k, "minsup": minsup, "local_minsup": local_minsup}
        )

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
