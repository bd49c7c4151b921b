"""DAG job model — the Condor/DAGMan analogue the paper evaluates against.

A Job is a Python callable plus metadata (inputs/outputs in bytes, the
site it runs on).  The DAG enforces ordering; the engine (engine.py)
executes it with a simulated grid clock, fault injection and rescue
semantics.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any, NamedTuple


class TimedResult(NamedTuple):
    """A job result carrying its own device-measured compute time.

    When a job's ``fn`` returns one of these, the engine advances the
    simulated grid clock by ``compute_s`` (the caller's measurement — e.g.
    wall time around the work and ``torch.cuda.synchronize()``) instead of its own
    perf_counter bracket, and dependents receive the unwrapped ``value``.
    This is how the runtime layer calibrates the paper's overhead model
    with real kernel timings.
    """

    value: Any
    compute_s: float


@dataclass
class Job:
    name: str
    fn: Callable[..., Any]
    deps: list[str] = field(default_factory=list)
    site: int = 0  # grid site executing this job (overhead model: link matrix)
    input_bytes: int = 0  # data staged in from the submit node
    output_bytes: int = 0  # data staged back
    retries: int = 2  # DAGMan-style automatic retry budget
    sim_compute_s: float = 0.0  # simulated compute (paper-scale what-if
    # studies); added to the simulated clock WITHOUT real sleeping
    # execution-backend batching hooks (workflow.executor.BatchedBackend):
    # jobs sharing a batch_key form one shape-identical fan-out group;
    # batched_fn(names, batch_args, argss) executes the whole group in
    # one fused call; batch_arg is this job's member payload (site index)
    batch_key: str | None = None
    batched_fn: Callable[..., Any] | None = None
    batch_arg: Any = None

    # filled by the engine
    status: str = "pending"  # pending | running | done | failed
    attempts: int = 0
    result: Any = None
    t_submit: float = 0.0
    t_start: float = 0.0
    t_end: float = 0.0


class DAG:
    def __init__(self, name: str = "dag"):
        self.name = name
        self.jobs: dict[str, Job] = {}

    def add(self, job: Job) -> Job:
        if job.name in self.jobs:
            raise ValueError(
                f"duplicate job {job.name!r} in DAG {self.name!r}: job names must be unique"
            )
        if job.name in job.deps:
            raise ValueError(f"job {job.name!r} depends on itself (cycle: {job.name} -> {job.name})")
        for d in job.deps:
            if d not in self.jobs:
                raise ValueError(
                    f"job {job.name!r} depends on unknown {d!r} "
                    f"(jobs must be added in topological order)"
                )
        self.jobs[job.name] = job
        return job

    def job(self, name: str, fn: Callable, deps: list[str] | None = None, **kw) -> Job:
        return self.add(Job(name=name, fn=fn, deps=deps or [], **kw))

    def ready(self) -> list[Job]:
        out = []
        for j in self.jobs.values():
            if j.status == "pending" and all(self.jobs[d].status == "done" for d in j.deps):
                out.append(j)
        return out

    def done(self) -> bool:
        return all(j.status == "done" for j in self.jobs.values())

    def failed(self) -> list[Job]:
        return [j for j in self.jobs.values() if j.status == "failed"]

    def validate_acyclic(self) -> None:
        """Reject cyclic dependency graphs with the offending cycle
        spelled out (``cycle: a -> b -> a``), and unknown dependency
        names with the job that references them.  Iterative DFS — a
        10k-job chain must not hit the recursion limit."""
        seen: dict[str, int] = {}  # 0/absent = white, 1 = on path, 2 = done
        for root in self.jobs:
            if seen.get(root) == 2:
                continue
            path: list[str] = []
            stack: list[tuple[str, bool]] = [(root, False)]
            while stack:
                n, leaving = stack.pop()
                if leaving:
                    seen[n] = 2
                    path.pop()
                    continue
                st = seen.get(n, 0)
                if st == 2:
                    continue
                if st == 1:
                    cycle = path[path.index(n):] + [n]
                    raise ValueError(f"dependency cycle in DAG {self.name!r}: {' -> '.join(cycle)}")
                seen[n] = 1
                path.append(n)
                stack.append((n, True))
                for d in self.jobs[n].deps:
                    if d not in self.jobs:
                        raise ValueError(f"job {n!r} depends on unknown {d!r}")
                    if seen.get(d, 0) != 2:
                        stack.append((d, False))
