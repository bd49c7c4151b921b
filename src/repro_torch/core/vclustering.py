"""Variance-based distributed clustering — the paper's Algorithm 1.

Pipeline (per the paper):
  1. Each site i clusters its local data into k_i sub-clusters (K-Means).
  2. Sites ship ONLY sufficient statistics (N, center, SSE) — KB-scale.
  3. "Logical merge": greedily merge the sub-cluster pair with the smallest
     variance increase s(i,j) while the merged variance stays below a
     threshold (experiments: 2x the largest individual sub-cluster SSE).
     The merge is deterministic given the gathered stats, so EVERY site can
     run it redundantly and obtain the identical global labeling.
  4. Border perturbation: each global cluster contributes b border
     candidates; a candidate moves to the closest other global cluster when
     the move lowers the global SSE.  Done site-locally on each site's own
     points (paper: "no additional communications are required").

``vcluster_pooled`` runs the four steps on a (S, n, D) stack of site
datasets in one process; ``vcluster_site_jobs`` decomposes them into the
SiteJob DAG that ``GridRuntime.run("vclustering")`` schedules.  Every
per-site step has a site-batched form, and a site gets the same bits alone
and in a batch (see ``core.kmeans``).  The JAX package's ``shard_map``
path (a multi-host piece) is not ported yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.kmeans import kmeans, kmeans_sites
from repro_torch.core.stats import SuffStats, merge_cost, merge_stats, stack_site_stats, stats_bytes
from repro_torch.kernels.ref import dot_last


class VClusterConfig(NamedTuple):
    k_local: int = 20  # sub-clusters per site (paper experiments: 20)
    kmeans_iters: int = 25
    threshold_factor: float = 2.0  # tau = factor * max individual SSE
    # The paper's line 10 ("while var(C_i,C_j) < tau") is ambiguous between
    # the merged cluster's total variance and the *increase* s(i,j) ("s(i,j)
    # represents the increase in the variance while merging").  The
    # "increase" reading recovers planted structure (tests) and is the
    # default; "merged_var" is kept for the literal reading.
    criterion: str = "increase"  # "increase" (default) | "merged_var"
    border_candidates: int = 8  # b, per global cluster
    # the CUDA assignment kernel (True) or the matmul form and argmin
    # (False).  None: under GridRuntime, the runtime's ``use_kernel``
    # decides; called directly, the kernel.
    use_kernel: bool | None = None


def _use_kernel(cfg: VClusterConfig) -> bool:
    return cfg.use_kernel is not False


class MergeResult(NamedTuple):
    labels: torch.Tensor  # (M,) int32 — root slot id per sub-cluster slot
    stats: SuffStats  # merged stats in root slots (dead slots size 0)
    n_merges: int
    n_global: int  # number of live global clusters


# ---------------------------------------------------------------------------
# Phase 2/3: logical merge over gathered sufficient statistics
# ---------------------------------------------------------------------------


def merge_subclusters(
    stats: SuffStats,
    threshold: torch.Tensor | float,
    criterion: str = "merged_var",
) -> MergeResult:
    """Greedy variance-constrained agglomeration over M sub-cluster slots.

    criterion "merged_var": merge while  sse_i + sse_j + s(i,j) < threshold
      (the paper's ``var(C_i, C_j) < tau``, tau = 2 x max individual SSE).
    criterion "increase":   merge while  s(i,j) < threshold.

    Each iteration computes the (M, M) score once, takes the first flat
    argmin (as ``jnp.argmin`` does), and reads one boolean back to the
    host: whether that minimum is under the threshold.  The merge itself
    stays on the device.
    """
    if criterion not in ("increase", "merged_var"):
        raise ValueError(f"unknown merge criterion {criterion!r}")
    m = stats.n_slots
    dev = stats.sizes.device
    st = SuffStats(stats.sizes.clone(), stats.centers.clone(), stats.sse.clone())
    labels = torch.arange(m, dtype=torch.int32, device=dev)
    tau = torch.as_tensor(threshold, dtype=torch.float32, device=dev)
    n_merges = 0
    while True:
        sc = merge_cost(st)
        if criterion == "merged_var":
            sc = torch.where(torch.isfinite(sc), sc + (st.sse[:, None] + st.sse[None, :]), torch.inf)
        flat = torch.argmin(sc.reshape(-1)).reshape(1)
        if not bool(sc.reshape(-1).index_select(0, flat)[0] < tau):
            break
        i, j = flat // m, flat % m
        merge_stats(st, i, j)  # j into i, in place
        labels = torch.where(labels == labels.index_select(0, j), labels.index_select(0, i), labels)
        n_merges += 1
    n_global = int((st.sizes > 0).sum())
    return MergeResult(labels=labels, stats=st, n_merges=n_merges, n_global=n_global)


def paper_threshold(stats: SuffStats, factor: float) -> torch.Tensor:
    """tau = factor * max individual sub-cluster SSE (paper's setting)."""
    return factor * torch.where(stats.sizes > 0, stats.sse, -torch.inf).max()


def merge_gathered(per_site: SuffStats, cfg: VClusterConfig) -> MergeResult:
    """Logical merge over gathered per-site stats (s, k, ...) — the single
    deterministic computation every site runs redundantly after the one
    gather."""
    flat = stack_site_stats(per_site)
    tau = paper_threshold(flat, cfg.threshold_factor)
    return merge_subclusters(flat, tau, criterion=cfg.criterion)


# ---------------------------------------------------------------------------
# Phase 4: border perturbation (site-local, zero extra communication)
# ---------------------------------------------------------------------------


def _border_candidates(own_d2: torch.Tensor, glabel: torch.Tensor, b: int):
    """Each site's top-b farthest points of every global cluster, in the
    order the JAX package's scan visits them: slot ascending, then rank
    (``lax.top_k``: larger distance first, equal distances to the lower
    point index).  Returns (points (S, T), valid (S, T)), T the largest
    candidate count of any site."""
    s, n = own_d2.shape
    by_dist = torch.sort(own_d2, dim=1, descending=True, stable=True).indices
    by_slot = torch.sort(glabel.gather(1, by_dist), dim=1, stable=True).indices
    order = by_dist.gather(1, by_slot)  # (slot asc, distance desc, index asc)
    slots = glabel.gather(1, order).contiguous()
    start = torch.searchsorted(slots, slots)  # first position of each point's slot
    rank = torch.arange(n, device=own_d2.device) - start
    cand = rank < b
    n_cand = cand.sum(dim=1)
    t = int(n_cand.max()) if s else 0
    first = torch.sort((~cand).to(torch.int8), dim=1, stable=True).indices[:, :t]
    valid = torch.arange(t, device=own_d2.device)[None, :] < n_cand[:, None]
    return order.gather(1, first), valid


def perturb_sites(
    xs: torch.Tensor,  # (S, n, D) site-local points
    point_slots: torch.Tensor,  # (S, n) int — sub-cluster SLOT id per point
    merged: MergeResult,
    b: int,
) -> tuple[torch.Tensor, SuffStats]:
    """Paper lines 13-24 on every site at once: move border candidates
    between global clusters when the global variance decreases.  Each site
    works on its own points against its own copy of the (replicated)
    global statistics; returns per-point global slot labels (S, n) int32
    and each site's locally updated copy of the global stats (S, M, ...).

    Candidate selection: within each live global cluster, the b points of
    the site farthest from the global center ("find_border").  Move test
    for a single point x from cluster g to cluster j (treating {x} as a
    singleton merge, per the s(i,j) formula):
        gain_remove = N_g/(N_g-1) * d(c_g, x)^2
        cost_add    = N_j/(N_j+1) * d(c_j, x)^2
    Move iff cost_add < gain_remove (strict SSE decrease).

    No (n, M) or (M, n) tensor is formed: each point's distance is taken to
    its own global center only, and the candidates come from a stable
    sort.  The walk visits only the valid candidates (the JAX scan's other
    M*b - valid positions are no-ops), all sites stepping together.
    """
    s, n, d = xs.shape
    st = merged.stats
    dev = xs.device
    rows = torch.arange(s, device=dev)
    glabel = merged.labels.long()[point_slots.long()]  # (S, n)

    # own_d2 as the JAX package takes it from pairwise_sq_dists: expanded, clamped
    c = st.centers
    dot = xs[..., 0] * c[:, 0][glabel]
    for k in range(1, d):
        dot = dot + xs[..., k] * c[:, k][glabel]
    own_d2 = ((dot_last(xs, xs) + dot_last(c, c)[glabel]) - 2.0 * dot).clamp(min=0.0)
    points, valid = _border_candidates(own_d2, glabel, b)

    alive = st.sizes > 0
    sizes = st.sizes[None].repeat(s, 1)
    centers = st.centers[None].repeat(s, 1, 1)
    sse = st.sse[None].repeat(s, 1)
    for t in range(points.shape[1]):
        idx, ok = points[:, t], valid[:, t]
        xi = xs[rows, idx]  # (S, D)
        g = glabel[rows, idx]
        cg = centers[rows, g]
        dg2 = dot_last(xi - cg, xi - cg)
        # closest OTHER live global cluster
        diff = xi[:, None, :] - centers
        d2 = torch.where(alive[None] & (sizes > 0), dot_last(diff, diff), torch.inf)
        d2[rows, g] = torch.inf
        j = torch.argmin(d2, dim=1)
        dj2 = d2[rows, j]
        ng, nj = sizes[rows, g], sizes[rows, j]
        cj = centers[rows, j]
        gain_remove = torch.where(ng > 1, ng / (ng - 1.0).clamp(min=1e-30) * dg2, 0.0)
        cost_add = nj / (nj + 1.0) * dj2
        do = ok & (ng > 1) & torch.isfinite(dj2) & (cost_add < gain_remove)
        cg_new = torch.where((ng > 1)[:, None], (ng[:, None] * cg - xi) / (ng - 1.0).clamp(min=1e-30)[:, None], cg)
        cj_new = (nj[:, None] * cj + xi) / (nj + 1.0)[:, None]
        # a site that does not move writes back what it read (g == j only then)
        sizes[rows, g] = torch.where(do, ng - 1.0, ng)
        sizes[rows, j] = torch.where(do, nj + 1.0, sizes[rows, j])
        centers[rows, g] = torch.where(do[:, None], cg_new, cg)
        centers[rows, j] = torch.where(do[:, None], cj_new, centers[rows, j])
        sse_g = sse[rows, g]
        sse[rows, g] = torch.where(do, sse_g - gain_remove, sse_g)
        sse[rows, j] = torch.where(do, sse[rows, j] + cost_add, sse[rows, j])
        glabel[rows, idx] = torch.where(do, j, g)
    return glabel.to(torch.int32), SuffStats(sizes=sizes, centers=centers, sse=sse)


def perturb_site(
    x: torch.Tensor, point_slot: torch.Tensor, merged: MergeResult, b: int
) -> tuple[torch.Tensor, SuffStats]:
    """One site's border perturbation: x (n, D), point_slot (n,) ->
    (labels (n,) int32, this site's updated copy of the global stats)."""
    labels, st = perturb_sites(x[None], point_slot[None], merged, b)
    return labels[0], SuffStats(sizes=st.sizes[0], centers=st.centers[0], sse=st.sse[0])


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------


class VClusterResult(NamedTuple):
    labels: torch.Tensor  # (s, n) global slot label per point
    merged: MergeResult
    site_stats: SuffStats  # (s, k, ...) pre-merge sub-cluster stats
    comm_bytes: int  # bytes of statistics exchanged (the ONLY comm)


def _stats_nbytes(cfg: VClusterConfig, d: int) -> int:
    return cfg.k_local * (d + 2) * 4  # (N, center, SSE) triples, f32


def vcluster_pooled(
    xs: torch.Tensor,
    cfg: VClusterConfig = VClusterConfig(),
    seed: int = 0,
    init_centers: torch.Tensor | None = None,
) -> VClusterResult:
    """The whole algorithm in one call: xs is (s, n, D) — s sites' datasets stacked, all
    steps in their site-batched forms.  ``init_centers`` (s, k_local, D)
    replaces the k-means++ seeding."""
    s = xs.shape[0]
    k = cfg.k_local
    km = kmeans_sites(xs, k, iters=cfg.kmeans_iters, use_kernel=_use_kernel(cfg),
                      init_centers=init_centers, seed=seed)
    merged = merge_gathered(km.stats, cfg)
    slots = km.assign + (torch.arange(s, device=xs.device, dtype=torch.int32) * k)[:, None]
    labels, _ = perturb_sites(xs, slots, merged, cfg.border_candidates)
    return VClusterResult(labels=labels, merged=merged, site_stats=km.stats,
                          comm_bytes=stats_bytes(stack_site_stats(km.stats)))


# ---------------------------------------------------------------------------
# SiteJob decomposition (the grid-workflow view of Algorithm 1)
# ---------------------------------------------------------------------------


def _stack(stats: list[SuffStats]) -> SuffStats:
    return SuffStats(
        sizes=torch.stack([st.sizes for st in stats]),
        centers=torch.stack([st.centers for st in stats]),
        sse=torch.stack([st.sse for st in stats]),
    )


def vcluster_site_jobs(
    xs: torch.Tensor,
    cfg: VClusterConfig = VClusterConfig(),
    *,
    seed: int = 0,
    init_centers: torch.Tensor | None = None,
    sync=None,
    measured: dict | None = None,
) -> list:
    """Decompose Algorithm 1 into ``workflow.sitejob.SiteJob``s.

    Stage 1: per-site K-Means sub-clustering (``cluster_i``; the CUDA
    assignment kernel unless ``cfg.use_kernel`` is False).  Stage 2: the single
    synchronization (``merge``) — ``sync(per_site_stats) -> MergeResult``,
    by default the in-process pooled merge.  Stage 3: per-site border
    perturbation (``perturb_i`` — no inter-site communication; the final
    point labels are staged back to the submit node, ``output_bytes``).
    The terminal ``collect`` job's result is a ``VClusterResult``.

    Site i seeds k-means++ from ``(seed, i)``, or starts from
    ``init_centers[i]``.  All jobs return TimedResults measured up to a
    CUDA synchronize on a CUDA ``xs``; ``measured`` (if given) receives the
    same numbers.  The per-site fan-outs (``cluster_i``, ``perturb_i``)
    carry ``batch_key``/``batched_fn`` hooks: under the ``batched``
    execution backend each whole fan-out runs as ONE site-batched call.
    """
    from repro_torch.workflow.sitejob import SiteJob, timed, timed_batch

    s, n, d = xs.shape
    k = cfg.k_local
    dev = xs.device
    stats_nbytes = _stats_nbytes(cfg, d)
    if init_centers is not None and tuple(init_centers.shape) != (s, k, d):
        raise ValueError(f"want init_centers of shape {(s, k, d)}, got {tuple(init_centers.shape)}")
    if sync is None:
        sync = functools.partial(merge_gathered, cfg=cfg)
    jobs: list[SiteJob] = []

    def of_sites(t: torch.Tensor, idx: list[int]) -> torch.Tensor:
        return t if idx == list(range(s)) else t[torch.tensor(idx, device=t.device)]

    def cluster_fn(i):
        def fn():
            res = kmeans(xs[i], k, iters=cfg.kmeans_iters, use_kernel=_use_kernel(cfg),
                         init_centers=None if init_centers is None else init_centers[i], seed=seed, site=i)
            return res.assign, res.stats

        return fn

    def cluster_batched(bargs, argss):
        res = kmeans_sites(
            of_sites(xs, bargs), k, iters=cfg.kmeans_iters, use_kernel=_use_kernel(cfg),
            init_centers=None if init_centers is None else of_sites(init_centers, bargs),
            seed=seed, sites=bargs,
        )
        st = res.stats
        return [
            (res.assign[j], SuffStats(sizes=st.sizes[j], centers=st.centers[j], sse=st.sse[j]))
            for j in range(len(bargs))
        ]

    for i in range(s):
        jobs.append(
            SiteJob(
                name=f"cluster_{i}",
                fn=timed(cluster_fn(i), measured, f"cluster_{i}", dev),
                site=i,  # GridModel.transfer_s normalizes to its link matrix
                input_bytes=n * d * 4,
                output_bytes=stats_nbytes,
                batch_key="cluster",
                batched_fn=timed_batch(cluster_batched, measured, dev),
                batch_arg=i,
            )
        )

    def merge_fn(*site_out):
        return sync(_stack([st for _, st in site_out]))

    jobs.append(
        SiteJob(
            name="merge",
            fn=timed(merge_fn, measured, "merge", dev),
            deps=[f"cluster_{i}" for i in range(s)],
            input_bytes=s * stats_nbytes,  # the all_gather payload
        )
    )

    def perturb_fn(i):
        def fn(site_out, merged):
            assign, _ = site_out
            labels, _ = perturb_site(xs[i], assign + i * k, merged, cfg.border_candidates)
            return labels

        return fn

    def perturb_batched(bargs, argss):
        mergeds = [m for _, m in argss]
        if any(m is not mergeds[0] for m in mergeds):
            raise NotImplementedError(
                "a fused perturbation wave over several merge results (the mining "
                "service's cross-request fusion) is not ported yet (slice 4 of ROADMAP.md)"
            )
        assigns = torch.stack([site_out[0] for site_out, _ in argss])
        offs = torch.tensor(bargs, dtype=torch.int32, device=assigns.device) * k
        labels, _ = perturb_sites(of_sites(xs, bargs), assigns + offs[:, None], mergeds[0],
                                  cfg.border_candidates)
        return [labels[j] for j in range(len(bargs))]

    for i in range(s):
        jobs.append(
            SiteJob(
                name=f"perturb_{i}",
                fn=timed(perturb_fn(i), measured, f"perturb_{i}", dev),
                deps=[f"cluster_{i}", "merge"],
                site=i,  # GridModel.transfer_s normalizes to its link matrix
                output_bytes=n * 4,  # int32 point labels staged back
                batch_key="perturb",
                batched_fn=timed_batch(perturb_batched, measured, dev),
                batch_arg=i,
            )
        )

    def collect_fn(merged, *rest):
        labels = torch.stack(list(rest[:s]))
        per_site = _stack([st for _, st in rest[s:]])
        return VClusterResult(labels=labels, merged=merged, site_stats=per_site,
                             comm_bytes=stats_bytes(stack_site_stats(per_site)))

    jobs.append(
        SiteJob(
            name="collect",
            fn=timed(collect_fn, measured, "collect", dev),
            deps=["merge", *[f"perturb_{i}" for i in range(s)], *[f"cluster_{i}" for i in range(s)]],
        )
    )
    return jobs
