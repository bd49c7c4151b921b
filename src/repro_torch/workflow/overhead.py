"""Analytical overhead model — the paper's §5.2.2.

estimated_time(workflow) = Σ over stages of max over parallel jobs of
(compute + transfer), with transfer times from a measured link matrix.
The paper compares this "ideal" bound against grid execution and finds
98% overhead for the cheap clustering workflow (Table 3); the engine
reproduces the measured side with its simulated job-prep latencies.

Two estimators:
  * ``estimate_stages`` — the paper's stage-barrier formula (matches the
    engine's ``schedule="staged"`` mode);
  * ``estimate_dag`` — the per-job critical-path bound (matches
    ``schedule="async"``, where a job starts the moment its dependencies
    complete; the paper's "partly overlapped by computations in the DAG").

``GridModel`` reproduces the paper's Table 2 (Mb/s - ms) exactly with
``links="grid5000"``; ``links="lan"`` models every pair as the local
cluster link (the overhead-free comparison point); ``links="skewed"``
degrades the Table 2 matrix per-site (the heterogeneous-WAN scenario of
arXiv:1412.2673's grid-workload study, where adaptive placement pays
off); ``bw_scale`` / ``lat_scale`` degrade or improve the matrix
uniformly for sweeps.  ``site_speed`` adds per-site compute speed
factors (None = homogeneous, preserving pre-placement numbers exactly).

Both estimators accept ``placement=`` to bound a workflow under a
placement policy: the specs are statically re-sited by
``placement.plan_specs`` (contention-free matchmaking) before the bound
is evaluated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

# Table 2: average bandwidths (Mb/s) and latencies (ms) among the sites.
# Order: Orsay, Toulouse, Rennes, Nancy, Sophia.  None on the diagonal.
SITES = ["Orsay", "Toulouse", "Rennes", "Nancy", "Sophia"]
BW_MBPS = [
    [None, 16.15, 57.73, 90.77, 17.63],
    [38.97, None, 26.08, 28.89, 35.74],
    [66.33, 12.71, None, 44.63, 26.96],
    [106.63, 14.13, 44.54, None, 30.01],
    [21.45, 17.41, 26.93, 30.14, None],
]
LAT_MS = [
    [None, 15, 8, 5, 28],
    [15, None, 19, 17, 14],
    [8, 19, None, 11, 19],
    [5, 17, 11, None, 17],
    [28, 14, 19, 17, None],
]
LOCAL_BW_MBPS = 941.0
LOCAL_LAT_MS = 0.07

# links="skewed": per-site degradation of the Table 2 matrix — a link
# divides its bandwidth by (and multiplies its latency by) the product of
# its endpoints' factors.  Sites 1 (Toulouse) and 4 (Sophia) get
# congested-WAN treatment, site 3 (Nancy) an upgraded backbone — the
# heterogeneous-link regime of arXiv:1412.2673 where matchmaking
# placement dominates the schedule.
SKEW_LINK_FACTOR = (1.0, 6.0, 1.0, 0.5, 10.0)
# the matching per-site compute heterogeneity (GridModel.skewed()):
# speed >1 = faster site; 1.0 keeps the site at the homogeneous baseline
SKEW_SITE_SPEED = (1.0, 0.5, 1.0, 1.5, 0.25)
LINKS = ("grid5000", "lan", "skewed")

# §5.3: measured Condor/DAGMan workflow preparation latency (a 2-job DAG
# on a laptop) — "about 295 seconds ... the interval between the workflow
# launching and the first job submission".
DAGMAN_PREP_S = 295.0


@dataclass(frozen=True)
class GridModel:
    prep_latency_s: float = DAGMAN_PREP_S
    submit_latency_s: float = 3.0  # per-job scheduling/matchmaking cost
    n_sites: int = 5
    # per-site worker slots for the async scheduler's contention model
    # (a speculative duplicate needs a second free slot somewhere)
    workers_per_site: int = 2
    # link matrix: "grid5000" = the paper's Table 2; "lan" = every pair at
    # local-cluster quality (the no-WAN comparison point for sweeps);
    # "skewed" = Table 2 degraded per-site by SKEW_LINK_FACTOR
    links: str = "grid5000"
    bw_scale: float = 1.0  # uniform bandwidth multiplier (>1 = faster)
    lat_scale: float = 1.0  # uniform latency multiplier (<1 = faster)
    # per-site compute speed factors (>1 = faster site); None models the
    # homogeneous grid the pre-placement engine assumed — site_compute_s
    # is then the identity, so old numbers reproduce bit-for-bit
    site_speed: tuple | None = None

    def __post_init__(self):
        if self.links not in LINKS:
            raise ValueError(f"unknown links {self.links!r}; expected one of {LINKS}")
        if self.site_speed is not None:
            speeds = tuple(float(s) for s in self.site_speed)
            if not speeds or any(s <= 0 for s in speeds):
                raise ValueError(f"site_speed factors must be positive, got {self.site_speed!r}")
            object.__setattr__(self, "site_speed", speeds)  # frozen dataclass

    @classmethod
    def skewed(cls, **kw) -> "GridModel":
        """The canonical heterogeneous grid: skewed links AND skewed
        per-site compute speeds — the sweep point where adaptive
        placement is gated against fixed."""
        kw.setdefault("links", "skewed")
        kw.setdefault("site_speed", SKEW_SITE_SPEED)
        return cls(**kw)

    def speed(self, site: int) -> float:
        """Compute speed factor of ``site`` (1.0 on the homogeneous
        grid); out-of-range indices wrap like the link matrix."""
        if self.site_speed is None:
            return 1.0
        return self.site_speed[site % len(self.site_speed)]

    def site_compute_s(self, site: int, compute_s: float) -> float:
        """Scheduled duration of ``compute_s`` worth of baseline compute
        at ``site``.  Identity when the grid is homogeneous (site_speed
        None) — not merely "divide by 1.0" — so pre-placement numbers
        reproduce exactly."""
        if self.site_speed is None:
            return compute_s
        return compute_s / self.speed(site)

    def transfer_s(self, src: int, dst: int, nbytes: int) -> float:
        """Transfer time for nbytes between sites (Table 2 units)."""
        if nbytes <= 0:
            return 0.0
        if src == dst or self.links == "lan":
            bw, lat = LOCAL_BW_MBPS, LOCAL_LAT_MS
        else:
            i, j = src % len(SITES), dst % len(SITES)
            bw = BW_MBPS[i][j] or LOCAL_BW_MBPS
            lat = LAT_MS[i][j] or LOCAL_LAT_MS
            if self.links == "skewed":
                factor = SKEW_LINK_FACTOR[i] * SKEW_LINK_FACTOR[j]
                bw /= factor
                lat *= factor
        bw *= self.bw_scale
        lat *= self.lat_scale
        return lat / 1e3 + (nbytes * 8) / (bw * 1e6)

    def worst_transfer_s(self, nbytes: int) -> float:
        worst = 0.0
        for i in range(len(SITES)):
            for j in range(len(SITES)):
                if i != j:
                    worst = max(worst, self.transfer_s(i, j, nbytes))
        return worst


def estimate_stages(stages: list[list[tuple[float, int, int, int]]], model: GridModel) -> float:
    """Ideal (analytical) execution time of a staged workflow.

    stages: list of stages; each stage is a list of parallel jobs
    (compute_s, input_bytes, output_bytes, site).  Per the paper: overall
    time = Σ_stage max_job (transfer_in + compute + transfer_out),
    transfers measured against the submit site (site 0) and compute
    scaled by the site's speed factor.
    """
    total = 0.0
    for stage in stages:
        worst = 0.0
        for compute_s, in_b, out_b, site in stage:
            t = (
                model.transfer_s(0, site, in_b)
                + model.site_compute_s(site, compute_s)
                + model.transfer_s(site, 0, out_b)
            )
            worst = max(worst, t)
        total += worst
    return total


class JobSpec(NamedTuple):
    """One job of an analytical workflow estimate: the metadata the ideal
    bound needs and nothing else (no callable, no status)."""

    name: str
    deps: tuple[str, ...] = ()
    compute_s: float = 0.0
    input_bytes: int = 0
    output_bytes: int = 0
    site: int = 0


def _topo_fold(specs: list[JobSpec], fold) -> dict:
    """Resolve every spec after its dependencies (iterative DFS — specs
    from the SiteJob factories are topological, but don't rely on it) and
    reduce with ``fold(spec, dep_values) -> value``."""
    by_name = {s.name: s for s in specs}
    out: dict = {}
    for s in specs:
        stack = [s.name]
        while stack:
            n = stack[-1]
            if n in out:
                stack.pop()
                continue
            spec = by_name[n]
            pending = [d for d in spec.deps if d not in out]
            if pending:
                stack.extend(pending)
                continue
            out[n] = fold(spec, [out[d] for d in spec.deps])
            stack.pop()
    return out


def _place_specs(specs: list[JobSpec], model: GridModel, placement) -> list[JobSpec]:
    """Re-site specs under a placement policy (contention-free static
    matchmaking); ``None`` keeps the pre-assigned sites untouched."""
    if placement is None:
        return specs
    from repro_torch.workflow.placement import plan_specs  # import cycle guard

    return plan_specs(specs, model, placement)


def estimate_dag(specs: list[JobSpec], model: GridModel, placement=None) -> float:
    """Ideal (analytical) execution time of a DAG workflow under per-job
    overlap — the async counterpart of ``estimate_stages``.

    Each job costs transfer_in + compute + transfer_out (transfers against
    the submit site, as in the paper; compute scaled by the site's speed
    factor) and starts the instant its last dependency finishes; no
    preparation, submission or slot-contention cost.  The result is the
    critical-path length — a lower bound on any schedule, and the
    baseline against which async-mode recovered overhead is measured.
    With ``placement`` the specs are first re-sited by the policy's
    contention-free plan (placement-aware bound).
    """
    specs = _place_specs(specs, model, placement)

    def finish(spec: JobSpec, dep_finishes: list[float]) -> float:
        ideal = (
            model.transfer_s(0, spec.site, spec.input_bytes)
            + model.site_compute_s(spec.site, spec.compute_s)
            + model.transfer_s(spec.site, 0, spec.output_bytes)
        )
        return max(dep_finishes, default=0.0) + ideal

    return max(_topo_fold(specs, finish).values(), default=0.0)


def estimate_stages_from_specs(specs: list[JobSpec], model: GridModel, placement=None) -> float:
    """The paper's stage-barrier estimate applied to a DAG: jobs are
    grouped into topological waves (longest-path depth) and each wave is a
    stage of ``estimate_stages``.  This is the analytical counterpart of
    the engine's ``schedule="staged"`` mode; the gap to ``estimate_dag``
    is the overhead the barrier itself adds."""
    specs = _place_specs(specs, model, placement)
    depth = _topo_fold(specs, lambda spec, dep_depths: 1 + max(dep_depths, default=-1))
    waves: dict[int, list[tuple[float, int, int, int]]] = {}
    for s in specs:
        waves.setdefault(depth[s.name], []).append(
            (s.compute_s, s.input_bytes, s.output_bytes, s.site)
        )
    return estimate_stages([waves[w] for w in sorted(waves)], model)


def overhead_pct(measured_s: float, estimated_s: float) -> float:
    """Table 3's 'Estimated overhead' column."""
    if measured_s <= 0:
        return 0.0
    return 100.0 * (measured_s - estimated_s) / measured_s
