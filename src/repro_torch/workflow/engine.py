"""DAGMan-analog workflow engine with a simulated grid clock.

Executes a DAG of Python jobs while modelling the grid behaviours the
paper measures:
  * workflow preparation latency (the paper's 295 s DAGMan observation)
    and per-job submit/matchmaking latency — optionally OVERLAPPED with
    running computation (`overlap_prep=True`), the optimisation the paper
    suggests ("partly overlapped by computations in the DAG");
  * data staging times from the Table 2 link matrix;
  * fault injection with DAGMan-style retries;
  * rescue files: a crashed run resumes from the last completed frontier
    (``rescue_path``), re-executing only unfinished jobs;
  * straggler mitigation: speculative duplicates of outlier jobs, first
    completion wins (``straggler_factor``).  The detector is
    per-scheduler: staged compares each job's stage total (staging +
    compute) against the stage median; async compares measured compute
    against the compute median of already-started jobs (staging is a
    deterministic model quantity there, not a straggler symptom).

Two schedulers share those semantics:

  * ``schedule="staged"`` — the original stage-barrier loop: the ready
    frontier runs as one synchronous stage, the next frontier only after
    the whole stage completes.  This is what a level-synchronous grid
    deployment does and what ``overhead.estimate_stages`` bounds.
  * ``schedule="async"`` — an event-driven simulator: each job
    independently walks submit -> stage-in -> compute -> stage-out on a
    simulated-clock event queue, becomes eligible the moment its last
    dependency completes (no barrier), pays its matchmaking latency in a
    pipelined fashion (submissions overlap each other and running
    computation), and contends for per-site worker slots
    (``GridModel.workers_per_site``) through per-site FIFO queues.
    Its analytical bound is ``overhead.estimate_dag``.  Because staged
    mode models unlimited per-site parallelism within a stage, async
    wall <= staged wall is guaranteed only while per-site concurrency
    stays within the worker slots (true for both applications' DAGs,
    which run one job per site per wave).

The COMPUTE time of each job is measured for real (wall clock of fn());
everything grid-related advances the simulated clock, so experiments are
deterministic and reproducible — the property Grid'5000 was built to
approximate and the paper laments ordinary grids lack.

HOW a job's callable executes is delegated to a pluggable execution
backend (``workflow.executor``): ``backend="inline"`` is the sequential
host loop (default, bit-for-bit the original engine), ``"batched"``
fuses ready shape-identical fan-out jobs into one site-axis device call,
``"multihost"`` executes over a ``torch.distributed`` process group.  Both
schedulers route every fn invocation through ``ExecutionBackend.call``;
scheduling semantics (faults, retries, rescue, speculation, the clock)
are backend-independent.
"""

from __future__ import annotations

import heapq
import json
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.workflow.dag import DAG, Job, TimedResult
from repro_torch.workflow.executor import ExecutionBackend, resolve_backend
from repro_torch.workflow.faults import FaultInjector
from repro_torch.workflow.overhead import GridModel
from repro_torch.workflow.placement import (
    PlacementPolicy,
    PlacementRequest,
    resolve_placement,
)

SCHEDULES = ("staged", "async")


@dataclass
class RunReport:
    wall_s: float = 0.0  # simulated grid wall-clock
    compute_s: float = 0.0  # Σ measured job compute
    # The critical path through the schedule, split into its mining-compute
    # and data-staging components.  Everything else on the wall clock
    # (preparation, submission, queue waits, barrier gaps) is overhead by
    # construction; staging is ALSO overhead — the grid moved bytes the
    # mining never needed moved — so overhead_pct() charges it as such.
    critical_compute_s: float = 0.0
    critical_transfer_s: float = 0.0
    prep_s: float = 0.0
    submit_s: float = 0.0  # Σ submit latency charged (may overlap compute)
    transfer_s: float = 0.0  # Σ staging over ALL jobs, not just critical
    retries: int = 0
    speculative: int = 0
    schedule: str = "staged"
    job_times: dict = field(default_factory=dict)
    # matchmaking: which policy placed the jobs, and where each job
    # actually ran (job name -> site) — for fixed placement this echoes
    # the DAG's pre-assigned sites
    placement: str = "fixed"
    placements: dict = field(default_factory=dict)
    # which execution backend ran the job callables (workflow.executor)
    backend: str = "inline"
    # multi-host ownership (ExecutionBackend.partition): how many
    # processes cooperated on this run, which one this report came from,
    # and which jobs/sites executed LOCALLY (None = no partitioning —
    # every job ran in this process).  The clock and the ledger above are
    # globally consistent regardless: non-owned jobs are scheduled with
    # owner-measured shipped times.
    n_processes: int = 1
    process_index: int = 0
    owned_jobs: tuple | None = None
    owned_sites: tuple | None = None
    # collective/shipment ledger (ExecutionBackend.ledger): how many
    # result-shipment collectives the backend performed this run, the
    # underlying all_gather rounds they cost, and how many job results
    # arrived shipped from other processes.  Wave-fused shipping makes
    # shipments scale with ready WAVES; the per-job mode scales with
    # jobs — the paper's communication-round count, made measurable.
    shipments: int = 0
    collective_rounds: int = 0
    shipped_results: int = 0

    @property
    def critical_path_s(self) -> float:
        return self.critical_compute_s + self.critical_transfer_s

    @property
    def max_stage_compute_s(self) -> float:
        """Backward-compat alias for the pre-split field.  Historically this
        accumulated transfer+compute per stage under a compute-only name,
        which made overhead_pct() silently credit staging as mining time."""
        return self.critical_path_s

    def overhead_pct(self) -> float:
        """Share of the wall clock that is grid overhead rather than mining
        compute (prep + submission + staging + waits), Table 3 style."""
        if self.wall_s <= 0:
            return 0.0
        return 100.0 * (self.wall_s - self.critical_compute_s) / self.wall_s


class Engine:
    def __init__(
        self,
        model: GridModel | None = None,
        faults: FaultInjector | None = None,
        rescue_path: str | Path | None = None,
        overlap_prep: bool = False,
        straggler_factor: float = 0.0,  # 0 = no speculation
        schedule: str = "staged",
        placement: str | PlacementPolicy = "fixed",
        backend: str | ExecutionBackend = "inline",
        trace: list | None = None,
    ):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; expected one of {SCHEDULES}")
        resolve_placement(placement)  # fail fast on unknown policy names
        self.model = model or GridModel()
        self.faults = faults or FaultInjector()
        self.rescue_path = Path(rescue_path) if rescue_path else None
        self.overlap_prep = overlap_prep
        self.straggler_factor = straggler_factor
        self.schedule = schedule
        self.placement = placement
        # how job callables execute (inline host loop / batched fused
        # site-compute / multihost site partitioning) — scheduler
        # decisions are backend-independent; see workflow.executor
        self.backend = resolve_backend(backend)
        self._backend = self.backend  # per-run override lives here
        self._partition = None  # per-run ownership (ExecutionBackend.partition)
        # optional observability hook: when a list is given, both
        # schedulers append (t, kind, job, site, site_busy_after) records
        # — the scheduler-invariant test suite audits these
        self.trace = trace

    def _trace(self, t: float, kind: str, job: str, site: int, busy: int) -> None:
        if self.trace is not None:
            self.trace.append((t, kind, job, site, busy))

    # -- rescue bookkeeping --------------------------------------------------

    def _load_rescue(self, dag: DAG) -> set[str]:
        if self.rescue_path and self.rescue_path.exists():
            return set(json.loads(self.rescue_path.read_text()))
        return set()

    def _save_rescue(self, done: set[str]) -> None:
        if self.rescue_path:
            self.rescue_path.parent.mkdir(parents=True, exist_ok=True)
            self.rescue_path.write_text(json.dumps(sorted(done)))

    # -- execution ------------------------------------------------------------

    def run_site_jobs(self, site_jobs, name: str = "site-jobs") -> tuple[RunReport, dict]:
        """Execute a list of ``workflow.sitejob.SiteJob`` through the grid
        model — the one scheduler shared by clustering and itemset mining.
        Returns (report, results-by-job-name)."""
        from repro_torch.workflow.sitejob import build_dag

        results: dict = {}
        rep = self.run(build_dag(site_jobs, name), results=results)
        return rep, results

    def run(
        self,
        dag: DAG,
        results: dict | None = None,
        schedule: str | None = None,
        placement: str | PlacementPolicy | None = None,
        backend: str | ExecutionBackend | None = None,
    ) -> RunReport:
        schedule = schedule or self.schedule
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; expected one of {SCHEDULES}")
        policy = resolve_placement(placement if placement is not None else self.placement)
        policy.reset()  # per-run state (RNG, round-robin cursor)
        self._backend = resolve_backend(backend) if backend is not None else self.backend
        dag.validate_acyclic()
        rep = RunReport(schedule=schedule, placement=policy.name, backend=self._backend.name)
        results = results if results is not None else {}
        self._backend.begin_run(dag, results)
        # multi-host ownership: a distributed backend partitions the DAG's
        # sites over its processes (the model is passed so a backend can
        # derive per-site load weights from it); the engine keeps
        # scheduling EVERY job — the simulated clock/ledger must stay
        # globally consistent — but only owned jobs execute here, the
        # rest arrive as shipped results
        self._partition = self._backend.partition(dag, self.model)
        if self._partition is not None:
            rep.n_processes = self._partition.n_processes
            rep.process_index = self._partition.process_index
            rep.owned_jobs = tuple(sorted(self._partition.owned))
            rep.owned_sites = tuple(self._partition.owned_sites)

        # workflow preparation (the 295 s DAGMan latency).  With
        # overlap_prep the first stage's submission pipeline hides all but
        # a fixed connection setup.
        prep = self.model.prep_latency_s
        if self.overlap_prep:
            prep = min(prep, 10.0)
        rep.prep_s = prep

        done = self._load_rescue(dag)
        for name in done:
            if name in dag.jobs:
                dag.jobs[name].status = "done"

        if schedule == "async":
            self._run_async(dag, results, rep, done, policy)
        else:
            self._run_staged(dag, results, rep, done, policy)
        led = self._backend.ledger()
        if led is not None:
            rep.shipments = int(led.get("shipments", 0))
            rep.collective_rounds = int(led.get("collective_rounds", 0))
            rep.shipped_results = int(led.get("shipped_results", 0))
        return rep

    # -- matchmaking ----------------------------------------------------------

    @staticmethod
    def _median(samples: list[float]) -> float:
        return sorted(samples)[len(samples) // 2] if samples else 0.0

    def _request(
        self,
        job: Job,
        now: float,
        sites: list[int],
        workers: int,
        site_busy: dict,
        queue_depth: dict,
        busy_until: dict,
        samples: list[float],
    ) -> PlacementRequest:
        """Snapshot the grid for one placement decision.  The expected
        compute is the job's own simulated time when declared (replay
        DAGs carry calibrated times there), else the running median of
        scheduled compute observed so far — the matchmaker cannot see a
        measurement that has not happened yet."""
        med = self._median(samples)
        expected = job.sim_compute_s if job.sim_compute_s > 0 else med
        return PlacementRequest(
            name=job.name,
            fixed_site=job.site,
            input_bytes=job.input_bytes,
            output_bytes=job.output_bytes,
            expected_compute_s=expected,
            now=now,
            model=self.model,
            sites=sites,
            workers=workers,
            site_busy=site_busy,
            queue_depth=queue_depth,
            busy_until=busy_until,
            service_est_s=med,
        )

    # -- staged (stage-barrier) scheduler -------------------------------------

    def _run_staged(
        self, dag: DAG, results: dict, rep: RunReport, done: set[str], policy: PlacementPolicy
    ) -> None:
        model = self.model
        workers = max(1, model.workers_per_site)
        sites = policy.candidate_sites([j.site for j in dag.jobs.values()], model)
        samples: list[float] = []  # scheduled compute of completed jobs
        clock = rep.prep_s

        while not dag.done():
            stage = dag.ready()
            if not stage:
                failed = dag.failed()
                raise RuntimeError(f"workflow stuck; failed jobs: {[j.name for j in failed]}")

            # matchmaking: place every job of the stage before it runs.
            # The stage itself has no slot limit (the barrier model runs
            # the whole frontier in parallel), so contention is priced
            # through the per-stage assignment count alone.
            stage_load: dict[int, int] = {}
            for job in stage:
                job.site = policy.place(
                    self._request(job, clock, sites, workers, stage_load, {}, {}, samples)
                )
                rep.placements[job.name] = job.site
                stage_load[job.site] = stage_load.get(job.site, 0) + 1

            # submit latency: serial per job unless overlapped
            submit = self.model.submit_latency_s * len(stage)
            if self.overlap_prep:
                submit = self.model.submit_latency_s
            clock += submit
            rep.submit_s += submit

            splits: list[tuple[float, float]] = []  # (transfer, compute) per job
            for job in stage:
                transfer, dt, attempts = self._execute(job, results, rep, done)
                rep.retries += attempts - 1
                sim_dt = model.site_compute_s(job.site, dt)
                samples.append(sim_dt)
                splits.append((transfer, sim_dt))
                self._trace(clock, "start", job.name, job.site, stage_load[job.site])

            # straggler speculation: duplicate the slowest job(s) if they
            # exceed factor x median — the duplicate "runs elsewhere" and
            # wins with the stage-median time (charged entirely as compute,
            # since the winning copy's own staging is not modelled).
            eff = list(splits)
            if self.straggler_factor and len(splits) >= 3:
                totals = sorted(tr + dt for tr, dt in splits)
                med = totals[len(totals) // 2]
                for i, (tr, dt) in enumerate(eff):
                    if tr + dt > self.straggler_factor * med:
                        eff[i] = (0.0, med)  # speculative copy wins
                        rep.speculative += 1

            if eff:
                tr_c, dt_c = max(eff, key=lambda p: p[0] + p[1])
                rep.critical_transfer_s += tr_c
                rep.critical_compute_s += dt_c
                clock += tr_c + dt_c

            for job in stage:
                self._trace(clock, "finish", job.name, job.site, 0)
            done.update(j.name for j in stage if j.status == "done")
            self._save_rescue(done)

        rep.wall_s = clock

    # -- async (event-driven) scheduler ---------------------------------------

    def _run_async(
        self, dag: DAG, results: dict, rep: RunReport, done: set[str], policy: PlacementPolicy
    ) -> None:
        """Simulated-clock event queue: every job independently walks
        submit -> stage-in -> compute -> stage-out; per-site worker slots
        (``GridModel.workers_per_site``) model contention via FIFO queues;
        a job is submitted the instant its last dependency completes, and
        the placement policy matches it to a site when that matchmaking
        round completes (the "arrive" event) — fixed placement echoes the
        pre-assigned ``job.site``, adaptive policies decide from the
        queue-state snapshot at that instant.

        fn() executes at slot-acquisition order on the simulated clock, so
        jobs sharing mutable state (the CommLog job factories) still observe
        dependency order.  Determinism: events tie-break on insertion
        sequence and every policy is seeded/reset per run, so identical
        (dag, model, measured times, seed) replay identically.
        """
        model = self.model
        workers = max(1, model.workers_per_site)
        t0 = rep.prep_s

        heap: list[tuple[float, int, str, str]] = []  # (time, seq, kind, job)
        seq = 0

        def push(t: float, kind: str, name: str) -> None:
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, name))
            seq += 1

        pending = {
            j.name: sum(1 for d in j.deps if dag.jobs[d].status != "done")
            for j in dag.jobs.values()
            if j.status != "done"
        }
        finish_t: dict[str, float] = {n: t0 for n in done if n in dag.jobs}
        pred: dict[str, str | None] = dict.fromkeys(finish_t)
        # (transfer, compute) on the schedule for finished jobs
        split: dict[str, tuple[float, float]] = dict.fromkeys(finish_t, (0.0, 0.0))
        # the slot universe: fixed placement keeps exactly the DAG's
        # pre-assigned sites (bit-for-bit the pre-placement engine, slot
        # choices of speculation included); adaptive policies match over
        # every site the grid model knows
        sites = policy.candidate_sites([j.site for j in dag.jobs.values()], model)
        site_busy: dict[int, int] = {s: 0 for s in sites}
        site_queue: dict[int, deque[str]] = {}  # FIFO of jobs waiting for a slot
        samples: list[float] = []  # scheduled compute of started jobs
        samples_base: list[float] = []  # the same, in baseline (speed-1) units
        clock = t0

        def submit(name: str, t_elig: float) -> None:
            """Charge per-job matchmaking latency and schedule arrival at
            the job's site.  Event-driven submission is inherently
            pipelined — each job pays the latency, but submissions overlap
            each other and running computation (the paper's "partly
            overlapped by computations in the DAG"), unlike the staged
            scheduler's serial per-stage submit loop."""
            lat = model.submit_latency_s
            rep.submit_s += lat
            push(t_elig + lat, "arrive", name)

        # jobs whose compute is in flight on the simulated clock:
        # name -> {t_start, transfer_in, transfer_out, dt, t_done, spec}
        running: dict[str, dict] = {}
        version: dict[str, int] = {}

        def maybe_speculate(t_now: float) -> None:
            """Online straggler detection: whenever a new compute sample
            lands, any in-flight job whose measured compute exceeds
            factor x the sample median gets a speculative duplicate on a
            second free slot — first completion wins, so its finish event
            is rescheduled to the duplicate's (lazy-deleted via version).
            Evaluated at every start (not only a job's own) so a straggler
            that started BEFORE enough peers had been observed is still
            caught, and at every slot release so a detection deferred by a
            full grid fires as soon as capacity exists."""
            if not self.straggler_factor or len(samples) < 3:
                return
            med = sorted(samples)[len(samples) // 2]
            for name, r in running.items():
                if r["spec"] or r["dt"] <= self.straggler_factor * med:
                    continue
                job = dag.jobs[name]
                spec_site = self._spec_site(job.site, site_busy, workers)
                if spec_site is None:
                    continue  # every slot in the grid is busy
                # a straggler is only observable once its compute is
                # actually running — never during its stage-in, even though
                # the simulator knows dt up-front
                detect = max(t_now, r["t_start"] + r["transfer_in"])
                # the duplicate stages the input to ITS slot and stages the
                # result back — speculation pays real bandwidth, it cannot
                # finish before its own input arrives
                tr_dup = model.transfer_s(0, spec_site, job.input_bytes) + model.transfer_s(
                    spec_site, 0, job.output_bytes
                )
                # the duplicate's run is estimated at the baseline-units
                # median scaled by ITS site's speed — a copy landing on a
                # slow site must not "win" in fast-site time
                med_base = sorted(samples_base)[len(samples_base) // 2]
                new_done = detect + tr_dup + model.site_compute_s(spec_site, med_base)
                if new_done >= r["t_done"]:
                    continue  # duplicate would not beat the original
                site_busy[spec_site] += 1  # the duplicate's slot
                r["spec"] = True
                r["t_done"] = new_done
                rep.speculative += 1
                rep.transfer_s += tr_dup
                self._trace(detect, "speculate", name, spec_site, site_busy[spec_site])
                # the winning chain: original stage-in (transfer) + original
                # compute until detection + duplicate staging (transfer) +
                # the duplicate's median run — the compute part is always
                # >= med, never negative
                transfer = r["transfer_in"] + tr_dup
                split[name] = (transfer, new_done - r["t_start"] - transfer)
                version[name] += 1
                push(new_done, "spec_release", f"{spec_site}")
                push(new_done, "finish", f"{name}@{version[name]}")

        def start(job: Job, t: float, gate: str | None) -> None:
            """Acquire a slot at ``t`` and run the job's full bracket."""
            site_busy[job.site] += 1
            transfer_in = model.transfer_s(0, job.site, job.input_bytes)
            transfer_out = model.transfer_s(job.site, 0, job.output_bytes)
            rep.transfer_s += transfer_in + transfer_out
            dt, attempts = self._attempt(job, results, rep, done)
            rep.retries += attempts - 1
            # the schedule sees the site-speed-scaled duration; job_times
            # and compute_s keep the measured baseline
            sim_dt = model.site_compute_s(job.site, dt)
            samples.append(sim_dt)
            samples_base.append(dt)
            t_done = t + transfer_in + sim_dt + transfer_out
            pred[job.name] = gate
            split[job.name] = (transfer_in + transfer_out, sim_dt)
            running[job.name] = {
                "t_start": t,
                "transfer_in": transfer_in,
                "transfer_out": transfer_out,
                "dt": sim_dt,
                "t_done": t_done,
                "spec": False,
            }
            version[job.name] = 0
            push(t_done, "finish", f"{job.name}@0")
            self._trace(t, "start", job.name, job.site, site_busy[job.site])
            maybe_speculate(t)

        for job in dag.jobs.values():  # insertion order = deterministic
            if job.status != "done" and pending[job.name] == 0:
                submit(job.name, t0)

        def busy_until() -> dict[int, list[float]]:
            """Known slot-release times per site — what the matchmaker
            may legitimately see (finish times of jobs whose compute is
            already in flight on the simulated clock)."""
            out: dict[int, list[float]] = {}
            for rname, r in running.items():
                out.setdefault(dag.jobs[rname].site, []).append(r["t_done"])
            return out

        def pop_queue(site: int, t: float, releaser: str | None) -> None:
            q = site_queue.get(site)
            if q and site_busy[site] < workers:
                # the slot release, not the dependency, gated this job
                start(dag.jobs[q.popleft()], t, releaser)

        while heap:
            t, _, kind, name = heapq.heappop(heap)
            if kind == "finish":
                # payload is "<job>@<version>"; events superseded by a
                # speculative reschedule are lazily dropped — before the
                # clock update, or the phantom original would stretch the
                # wall past the duplicate's win
                name, _, ver = name.rpartition("@")
                if int(ver) != version[name]:
                    continue
            clock = max(clock, t)
            if kind == "spec_release":
                site = int(name)
                site_busy[site] -= 1
                self._trace(t, "spec_release", "", site, site_busy[site])
                pop_queue(site, t, None)
                maybe_speculate(t)  # the freed slot may admit a duplicate
                continue
            if kind == "arrive":
                # matchmaking completes: the policy assigns the site from
                # the queue-state snapshot at this instant (fixed echoes
                # the pre-assigned job.site)
                job = dag.jobs[name]
                job.site = policy.place(
                    self._request(
                        job,
                        t,
                        sites,
                        workers,
                        site_busy,
                        {s: len(q) for s, q in site_queue.items()},
                        busy_until(),
                        samples,
                    )
                )
                rep.placements[name] = job.site
                if site_busy[job.site] < workers:
                    start(job, t, pred.get(name))  # gated by latest dep
                else:
                    site_queue.setdefault(job.site, deque()).append(name)
                    self._trace(t, "queue", name, job.site, site_busy[job.site])
                continue
            # kind == "finish"
            job = dag.jobs[name]
            del running[name]
            site_busy[job.site] -= 1
            self._trace(t, "finish", name, job.site, site_busy[job.site])
            finish_t[name] = t
            done.add(name)
            self._save_rescue(done)
            for dep in dag.jobs.values():
                if dep.status != "done" and name in dep.deps:
                    pending[dep.name] -= 1
                    if pending[dep.name] == 0:
                        pred[dep.name] = name  # eligibility gated by this job
                        submit(dep.name, t)
            pop_queue(job.site, t, name)
            maybe_speculate(t)  # the freed slot may admit a duplicate

        if not dag.done():
            failed = dag.failed()
            raise RuntimeError(f"workflow stuck; failed jobs: {[j.name for j in failed]}")

        rep.wall_s = clock
        self._credit_critical_path(finish_t, pred, split, rep)

    def _spec_site(self, site: int, site_busy: dict[int, int], workers: int) -> int | None:
        """Pick the slot for a speculative duplicate: the least-loaded OTHER
        site (lowest id on ties), falling back to this site's spare slot;
        None when every slot in the grid is busy (no speculation)."""
        candidates = sorted(
            (busy, s) for s, busy in site_busy.items() if s != site and busy < workers
        )
        if candidates:
            return candidates[0][1]
        if site_busy.get(site, 0) < workers:
            return site
        return None

    def _credit_critical_path(
        self,
        finish_t: dict[str, float],
        pred: dict[str, str | None],
        split: dict[str, tuple[float, float]],
        rep: RunReport,
    ) -> None:
        """Walk the gating chain back from the last job to finish, summing
        its staging vs compute; submit latencies and waits between links are
        the remainder of the wall clock, i.e. pure overhead."""
        if not finish_t:
            return
        cur: str | None = max(finish_t, key=lambda n: (finish_t[n], n))
        while cur is not None:
            tr, dt = split[cur]
            rep.critical_transfer_s += tr
            rep.critical_compute_s += dt
            cur = pred.get(cur)

    # -- one job --------------------------------------------------------------

    def _attempt(self, job: Job, results: dict, rep: RunReport, done: set[str]) -> tuple[float, int]:
        """Execute one job with DAGMan retries; returns (measured compute
        seconds, attempts).  Injected failures cost no simulated time (the
        retry is immediate); exhaustion saves the rescue frontier and
        raises."""
        attempts = 0
        while True:
            attempts += 1
            job.attempts = attempts
            job.status = "running"
            if self.faults.should_fail(job.name, attempts):
                if attempts > job.retries:
                    job.status = "failed"
                    self._save_rescue(done)
                    raise RuntimeError(f"job {job.name} exhausted retries ({job.retries})")
                continue  # DAGMan retry
            t0 = time.perf_counter()
            args = [results[d] for d in job.deps]
            # the execution backend decides HOW fn runs (inline dispatch,
            # fused batch, multihost process group); scheduling semantics around it
            # — faults, retries, rescue, the simulated clock — are ours
            raw = self._backend.call(job, args)
            if isinstance(raw, TimedResult):
                # the job measured its own device compute (SiteJob.timed);
                # the grid clock is calibrated by real kernels, not by our
                # host-side bracket around fn()
                job.result = raw.value
                dt = raw.compute_s + job.sim_compute_s
            else:
                if self._partition is not None and job.name not in self._partition.owned:
                    # owner-only timing invariant: a job that executed on
                    # another process MUST arrive as an owner-measured
                    # TimedResult — bracketing the collective wait here
                    # would feed a process-local (and divergent) time into
                    # the globally-consistent clock/ledger
                    raise RuntimeError(
                        f"job {job.name!r} is owned by process "
                        f"{self._partition.owner_of.get(job.name)} but its shipped "
                        f"result carries no owner-measured TimedResult"
                    )
                job.result = raw
                dt = time.perf_counter() - t0 + job.sim_compute_s
            results[job.name] = job.result
            job.status = "done"
            rep.compute_s += dt
            rep.job_times[job.name] = dt
            return dt, attempts

    def _execute(
        self, job: Job, results: dict, rep: RunReport, done: set[str]
    ) -> tuple[float, float, int]:
        """Staged-mode wrapper: charge both staging legs and run the
        attempts loop; returns (transfer, compute, attempts)."""
        transfer = self.model.transfer_s(0, job.site, job.input_bytes) + self.model.transfer_s(
            job.site, 0, job.output_bytes
        )
        rep.transfer_s += transfer
        dt, attempts = self._attempt(job, results, rep, done)
        return transfer, dt, attempts
