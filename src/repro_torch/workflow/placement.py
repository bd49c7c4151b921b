"""Placement policies — the matchmaking step of the paper's Condor setup.

The paper's deployment never pins a job to a site a priori: Condor
matchmaking assigns each job to a resource *when it becomes eligible*,
and that decision is where most of the grid-overhead variance the paper
measures comes from.  A ``PlacementPolicy`` makes that decision for the
workflow engine: at eligibility time (async mode: when the job's
matchmaking completes; staged mode: when its stage forms) the scheduler
hands the policy a :class:`PlacementRequest` snapshot of the grid —
candidate sites, per-site busy slots and FIFO queue depths, known
slot-release times, the link matrix and per-site speed factors — and the
policy returns the site the job will run on.

Policies:

  * ``fixed`` — honor the pre-assigned ``job.site`` (the engine's
    behavior before placement existed; bit-for-bit identical numbers);
  * ``round_robin`` — cycle through the candidate sites in index order,
    one step per placement decision;
  * ``random`` — uniform over the candidate sites from a seeded RNG
    (deterministic across runs with the same seed);
  * ``greedy_eta`` — pick the site minimizing estimated completion:
    queue wait (from current busy slots, FIFO depth, and known
    slot-release times) + stage-in/out from the link matrix + expected
    compute scaled by the site's speed factor (arXiv:1903.03008 shows
    partition-to-resource assignment dominates distributed-Apriori
    runtime on heterogeneous links; arXiv:1412.2673 motivates the skewed
    per-site speed/queue scenarios).

All policies are deterministic given the same DAG, model, and measured
times — ``reset()`` is called at the start of every engine run, so a
reused policy (or engine) replays identically.
"""

from __future__ import annotations

import random
from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (overhead -> placement)
    from repro_torch.workflow.overhead import GridModel, JobSpec

POLICIES = ("fixed", "round_robin", "random", "greedy_eta")


@dataclass
class PlacementRequest:
    """What a policy sees at decision time: one job's staging profile and
    a snapshot of the grid.  ``busy_until`` holds the known simulated
    finish times of jobs currently occupying slots (async mode; staged
    mode leaves it empty and models contention through ``site_busy``
    alone).  ``service_est_s`` is the scheduler's running estimate of one
    job's service time (median of observed scheduled compute), used to
    price queue positions with unknown occupants."""

    name: str
    fixed_site: int
    input_bytes: int
    output_bytes: int
    expected_compute_s: float
    now: float
    model: "GridModel"
    sites: Sequence[int]
    workers: int
    site_busy: dict = field(default_factory=dict)
    queue_depth: dict = field(default_factory=dict)
    busy_until: dict = field(default_factory=dict)
    service_est_s: float = 0.0

    def queue_wait_s(self, site: int) -> float:
        """Estimated wait for a free slot at ``site``: zero while slots
        remain; otherwise the earliest known release (falling back to one
        service-time estimate) plus one estimate per job already ahead in
        line beyond that first release."""
        busy = self.site_busy.get(site, 0)
        queued = self.queue_depth.get(site, 0)
        if busy + queued < self.workers:
            return 0.0
        frees = self.busy_until.get(site, ())
        first = min(frees) - self.now if frees else self.service_est_s
        ahead = busy + queued - self.workers  # beyond the first release
        return max(0.0, first) + ahead * self.service_est_s

    def eta_s(self, site: int) -> float:
        """Estimated completion if the job ran at ``site``: queue wait +
        stage-in + speed-scaled compute + stage-out."""
        m = self.model
        return (
            self.queue_wait_s(site)
            + m.transfer_s(0, site, self.input_bytes)
            + m.site_compute_s(site, self.expected_compute_s)
            + m.transfer_s(site, 0, self.output_bytes)
        )


class PlacementPolicy:
    """Site chooser for one engine run.  Subclasses override ``place``;
    stateful policies also override ``reset`` (called once per run)."""

    name = "?"

    def reset(self) -> None:  # per-run state, nothing by default
        return None

    def candidate_sites(self, fixed_sites: Sequence[int], model: "GridModel") -> list[int]:
        """The site universe for this run.  Adaptive policies match over
        every site the model knows; ``fixed`` keeps exactly the
        pre-assigned sites (preserving the pre-placement engine's slot
        universe, and with it speculation's slot choices, bit-for-bit)."""
        return list(range(model.n_sites))

    def place(self, req: PlacementRequest) -> int:
        raise NotImplementedError


class FixedPlacement(PlacementPolicy):
    """Honor the DAG's pre-assigned sites — the engine's original
    behavior, kept as the baseline every adaptive policy is gated
    against."""

    name = "fixed"

    def candidate_sites(self, fixed_sites: Sequence[int], model: "GridModel") -> list[int]:
        return list(dict.fromkeys(fixed_sites))

    def place(self, req: PlacementRequest) -> int:
        return req.fixed_site


class RoundRobinPlacement(PlacementPolicy):
    """Cycle through the candidate sites in index order, advancing one
    step per placement decision (decision order is the engine's
    deterministic event order)."""

    name = "round_robin"

    def __init__(self) -> None:
        self._next = 0

    def reset(self) -> None:
        self._next = 0

    def place(self, req: PlacementRequest) -> int:
        sites = sorted(req.sites)
        site = sites[self._next % len(sites)]
        self._next += 1
        return site


class RandomPlacement(PlacementPolicy):
    """Uniform over the candidate sites from a seeded RNG.  The seed is
    part of the policy, so identical runs replay identical placements."""

    name = "random"

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self._rng = random.Random(seed)

    def reset(self) -> None:
        self._rng = random.Random(self.seed)

    def place(self, req: PlacementRequest) -> int:
        sites = sorted(req.sites)
        return sites[self._rng.randrange(len(sites))]


class GreedyEtaPlacement(PlacementPolicy):
    """Minimize estimated completion time over the candidate sites —
    the matchmaking rank expression of the paper's Condor deployment.
    Ties break toward the lowest site index (deterministic)."""

    name = "greedy_eta"

    def place(self, req: PlacementRequest) -> int:
        return min(sorted(req.sites), key=lambda s: (req.eta_s(s), s))


_FACTORIES = {
    "fixed": FixedPlacement,
    "round_robin": RoundRobinPlacement,
    "random": RandomPlacement,
    "greedy_eta": GreedyEtaPlacement,
}


def resolve_placement(placement: "str | PlacementPolicy | None") -> PlacementPolicy:
    """Resolve a policy name (or pass through an instance) to a policy.
    Unknown names raise with the valid set, mirroring the engine's
    schedule validation."""
    if placement is None:
        return FixedPlacement()
    if isinstance(placement, PlacementPolicy):
        return placement
    try:
        return _FACTORIES[placement]()
    except KeyError:
        raise ValueError(
            f"unknown placement {placement!r}; expected one of {POLICIES} or a PlacementPolicy"
        ) from None


def plan_specs(
    specs: "list[JobSpec]", model: "GridModel", placement: "str | PlacementPolicy | None"
) -> "list[JobSpec]":
    """Statically re-site a spec list the way ``placement`` would on an
    idle grid — the contention-free planning step behind the
    placement-aware analytical bounds (``overhead.estimate_dag`` /
    ``estimate_stages_from_specs``).  Decisions are made in spec order
    with every slot free, so the result is a lower-bound assignment, not
    a replay of the engine's queue-state-dependent choices (use
    ``RunReport.placements`` to bound an actual run)."""
    policy = resolve_placement(placement)
    policy.reset()
    sites = policy.candidate_sites([sp.site for sp in specs], model)
    out = []
    for sp in specs:
        req = PlacementRequest(
            name=sp.name,
            fixed_site=sp.site,
            input_bytes=sp.input_bytes,
            output_bytes=sp.output_bytes,
            expected_compute_s=sp.compute_s,
            now=0.0,
            model=model,
            sites=sites,
            workers=max(1, model.workers_per_site),
        )
        out.append(sp._replace(site=policy.place(req)))
    return out
