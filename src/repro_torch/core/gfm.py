"""GFM — Grid-based Frequent-itemset Mining (the paper's Algorithm 2).

Protocol (faithful to §3.2):
  Phase 1 (fully local, zero communication): every site runs Apriori with
    LOCAL pruning only, producing its locally frequent itemsets of sizes
    1..k and caching every support it counted along the way.
  Phase 2 (the single synchronization):
    pass 1 — sites exchange their locally frequent itemsets WITH their
      local counts (one message per site: the union pool U is now known
      everywhere, partially counted);
    pass 2 — every site counts the pool entries it had NOT already counted
      locally ("remote support counts ... requested from other sites") and
      replies; global counts are now exact.
  Top-down search: itemsets failing the global test have their subsets
    examined top-down.  Under uniform local/global support ratios the
    standard lemma (globally frequent ⇒ locally frequent at ≥1 site)
    guarantees every candidate subset is already in U, so the descent adds
    ZERO extra communication rounds — which is exactly why the paper
    observes 2 passes (vs FDM's k).  With non-uniform thresholds the lemma
    breaks and the descent runs further (counted) rounds; we support both
    and report the realized round count.

Communication accounting mirrors the paper's evaluation: we report rounds
(synchronization passes) and bytes (itemset ids + 4-byte counts, broadcast
to the s-1 peers).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.apriori import (
    Itemset,
    LocalMineResult,
    TransactionDB,
    batched_local_apriori,
    count_supports,
    fused_count_sites,
    local_apriori,
    subsets_of,
)


@dataclass
class CommLog:
    """Synchronization/communication ledger (what the paper measures)."""

    rounds: int = 0
    bytes_sent: int = 0
    messages: int = 0
    count_calls: int = 0  # device support-count invocations
    per_round_bytes: list = field(default_factory=list)

    def add_round(self, payload_items: int, item_bytes: int, n_sites: int) -> None:
        # every site broadcasts to its s-1 peers (paper: iterative
        # peer-to-peer requests; we ledger the all-to-all equivalent)
        b = payload_items * item_bytes * (n_sites - 1)
        self.rounds += 1
        self.bytes_sent += b
        self.messages += n_sites * (n_sites - 1)
        self.per_round_bytes.append(b)


@dataclass
class GFMResult:
    frequent: dict[Itemset, int]  # globally frequent -> exact global count
    comm: CommLog
    local: list[LocalMineResult]
    pool_sizes: list[int]  # candidates exchanged per round
    n_total_tx: int


def _itemset_bytes(k: int) -> int:
    return 4 * k + 4  # item ids (4B each) + count


# ---------------------------------------------------------------------------
# Protocol phases — shared by the in-process run (gfm_mine) and the
# SiteJob decomposition (gfm_site_jobs / runtime.GridRuntime)
# ---------------------------------------------------------------------------


def build_pool(local: list[LocalMineResult], k: int) -> tuple[list[Itemset], int]:
    """Phase 2 pass 1: the union pool of locally frequent itemsets and the
    exchanged payload size (itemset count announced across all sites)."""
    pool: set[Itemset] = set()
    payload = 0
    for lm in local:
        for lv in range(1, k + 1):
            pool.update(lm.frequent[lv])
            payload += len(lm.frequent[lv])
    return sorted(pool, key=lambda t: (len(t), t)), payload


def fill_missing(
    db: TransactionDB, lm: LocalMineResult, pool: list[Itemset], backend: str = "torch"
) -> int:
    """Phase 2 pass 2, one site's share: count the pool entries this site
    had NOT already counted locally.  Mutates ``lm.counts`` (idempotent —
    re-running counts nothing) and returns the number counted."""
    missing = [its for its in pool if its not in lm.counts]
    if missing:
        sup = count_supports(db, missing, backend=backend)
        for its, c in zip(missing, sup):
            lm.counts[its] = int(c)
    return len(missing)


def aggregate_counts(pool: list[Itemset], local: list[LocalMineResult]) -> dict[Itemset, int]:
    """Exact global counts once every site has filled its missing supports."""
    return {its: sum(lm.counts[its] for lm in local) for its in pool}


def topdown_search(
    sites: list[TransactionDB],
    local: list[LocalMineResult],
    decided: dict[Itemset, tuple[int, bool]],
    g_min: int,
    comm: CommLog,
    k: int,
    backend: str,
    pool_sizes: list[int],
) -> None:
    """Top-down descent over subsets of globally-failed itemsets.

    Under uniform thresholds every candidate subset is already decided
    (the 2-pass lemma) and this adds ZERO extra rounds; with non-uniform
    thresholds it runs further counted rounds.  Mutates ``decided``,
    ``comm`` and ``pool_sizes``.
    """
    frontier: set[Itemset] = set()
    for its, (_, ok) in list(decided.items()):
        if not ok:
            for sub in subsets_of(its):
                if len(sub) >= 1 and sub not in decided:
                    frontier.add(sub)
    while frontier:
        batch = sorted(frontier, key=lambda t: (len(t), t))
        pool_sizes.append(len(batch))
        counts = np.zeros(len(batch), dtype=np.int64)
        for db, lm in zip(sites, local):
            missing = [its for its in batch if its not in lm.counts]
            if missing:
                sup = count_supports(db, missing, backend=backend)
                comm.count_calls += 1
                for its, c in zip(missing, sup):
                    lm.counts[its] = int(c)
            counts += np.array([lm.counts[its] for its in batch], dtype=np.int64)
        comm.add_round(len(batch) * len(sites), _itemset_bytes(k), len(sites))
        frontier = set()
        for its, c in zip(batch, counts):
            ok = int(c) >= g_min
            decided[its] = (int(c), ok)
            if not ok:
                for sub in subsets_of(its):
                    if len(sub) >= 1 and sub not in decided:
                        frontier.add(sub)


def gfm_mine(
    sites: list[TransactionDB],
    k: int,
    minsup: float,
    backend: str = "torch",
    local_minsup: float | None = None,
) -> GFMResult:
    """Run the GFM protocol over ``sites``.

    minsup: global relative support threshold.
    local_minsup: per-site relative threshold for phase 1 (defaults to
      ``minsup`` — the uniform setting under which the 2-pass bound holds).
    """
    s = len(sites)
    n_total = sum(db.n_tx for db in sites)
    g_min = int(np.ceil(minsup * n_total))
    l_ratio = minsup if local_minsup is None else local_minsup
    comm = CommLog()

    # ---- Phase 1: independent local Apriori (no communication) ----
    local: list[LocalMineResult] = []
    for db in sites:
        lm = local_apriori(db, k, int(np.ceil(l_ratio * db.n_tx)), backend=backend)
        comm.count_calls += lm.count_calls
        local.append(lm)

    # ---- Phase 2 pass 1: exchange locally frequent itemsets + counts ----
    pool_sorted, payload = build_pool(local, k)
    comm.add_round(payload, _itemset_bytes(k), s)
    pool_sizes = [len(pool_sorted)]

    # ---- Phase 2 pass 2: fill in missing remote supports ----
    reply_payload = 0
    for db, lm in zip(sites, local):
        n_missing = fill_missing(db, lm, pool_sorted, backend=backend)
        if n_missing:
            comm.count_calls += 1
        reply_payload += n_missing
    comm.add_round(reply_payload, _itemset_bytes(k), s)

    global_counts = aggregate_counts(pool_sorted, local)
    decided: dict[Itemset, tuple[int, bool]] = {
        its: (c, c >= g_min) for its, c in global_counts.items()
    }

    # ---- Top-down search over subsets of failures ----
    # Under uniform thresholds every globally frequent subset is already in
    # the pool (lemma), so the descent adds no further rounds.
    topdown_search(sites, local, decided, g_min, comm, k, backend, pool_sizes)

    frequent = {its: c for its, (c, ok) in decided.items() if ok}
    return GFMResult(
        frequent=frequent,
        comm=comm,
        local=local,
        pool_sizes=pool_sizes,
        n_total_tx=n_total,
    )


# ---------------------------------------------------------------------------
# SiteJob decomposition (the grid-workflow view of Algorithm 2)
# ---------------------------------------------------------------------------


def gfm_site_jobs(
    sites: list[TransactionDB],
    k: int,
    minsup: float,
    backend: str = "torch",
    local_minsup: float | None = None,
    measured: dict | None = None,
) -> list:
    """Decompose the GFM protocol into ``workflow.sitejob.SiteJob``s.

    ``apriori_i`` are the fully-local phase-1 jobs (the CUDA support-count
    kernels when ``backend="kernel"``); ``pool`` and ``decide`` bracket the single
    two-pass synchronization, with the ``recount_i`` jobs doing each site's
    missing-support counting in between.  The terminal ``decide`` job's
    result is a ``GFMResult`` with the same CommLog semantics as
    ``gfm_mine`` — exactly 2 rounds under uniform thresholds.

    The jobs share one CommLog, so run them without fault injection
    (a retried ``pool`` would ledger its round twice).  Both engine
    schedulers are safe: under ``schedule="async"`` the dependency edges
    alone order every CommLog mutation (pool after all aprioris, decide
    after all recounts), and speculation never re-executes a job's fn.

    The per-site fan-outs (``apriori_i``, ``recount_i``) also carry
    ``batch_key``/``batched_fn`` hooks: under the ``batched`` execution
    backend phase 1 runs as lockstep level rounds with one fused
    site-axis count dispatch per level (``batched_local_apriori``), and
    the missing-support recounts as one fused dispatch total
    (``fused_count_sites``) — result- and ledger-identical to the
    per-site loop.
    """
    from repro_torch.workflow.sitejob import SiteJob, timed, timed_batch

    s = len(sites)
    n_total = sum(db.n_tx for db in sites)
    g_min = int(np.ceil(minsup * n_total))
    l_ratio = minsup if local_minsup is None else local_minsup
    device = sites[0].packed.device if sites else None
    comm = CommLog()
    pool_sizes: list[int] = []
    jobs: list[SiteJob] = []

    def apriori_fn(i):
        db = sites[i]

        def fn():
            return local_apriori(db, k, int(np.ceil(l_ratio * db.n_tx)), backend=backend)

        return fn

    def apriori_batched(bargs, argss):
        # bargs carry (site, local_min_count): one fused call runs every
        # member, each against its own site's threshold
        dbs = [sites[i] for i, _ in bargs]
        mins = [m for _, m in bargs]
        return batched_local_apriori(dbs, k, mins, backend=backend)

    for i in range(s):
        jobs.append(
            SiteJob(
                name=f"apriori_{i}",
                fn=timed(apriori_fn(i), measured, f"apriori_{i}", device),
                site=i,  # GridModel.transfer_s normalizes to its link matrix
                input_bytes=sites[i].packed.numel() * 4,  # no host copy
                batch_key="apriori",
                batched_fn=timed_batch(apriori_batched, measured, device),
                batch_arg=(i, int(np.ceil(l_ratio * sites[i].n_tx))),
            )
        )

    def pool_fn(*local):
        for lm in local:
            comm.count_calls += lm.count_calls
        pool, payload = build_pool(list(local), k)
        comm.add_round(payload, _itemset_bytes(k), s)
        pool_sizes.append(len(pool))
        return pool

    jobs.append(
        SiteJob(
            name="pool",
            fn=timed(pool_fn, measured, "pool", device),
            deps=[f"apriori_{i}" for i in range(s)],
        )
    )

    # The per-site recount jobs are CLOSURE-PURE: everything they know
    # flows in through their dependency results and out through their own
    # result.  Their device-count-call contribution to the shared CommLog
    # is ledgered by the downstream sync job (``decide``) from the returned
    # ``n_missing`` values, as in the JAX package.
    def recount_fn(i):
        db = sites[i]

        def fn(lm, pool):
            n_missing = fill_missing(db, lm, pool, backend=backend)
            return lm, n_missing

        return fn

    def recount_batched(bargs, argss):
        # each member brings its own site's LocalMineResult and the pool
        # from its own dependency results
        missing_by = [[its for its in pool if its not in lm.counts] for lm, pool in argss]
        sups = fused_count_sites([sites[i] for i in bargs], missing_by, backend=backend)
        outs = []
        for (lm, _pool), missing, sup in zip(argss, missing_by, sups):
            if missing:
                for its, c in zip(missing, sup):
                    lm.counts[its] = int(c)
            outs.append((lm, len(missing)))
        return outs

    for i in range(s):
        jobs.append(
            SiteJob(
                name=f"recount_{i}",
                fn=timed(recount_fn(i), measured, f"recount_{i}", device),
                deps=[f"apriori_{i}", "pool"],
                site=i,  # GridModel.transfer_s normalizes to its link matrix
                batch_key="recount",
                batched_fn=timed_batch(recount_batched, measured, device),
                batch_arg=i,
            )
        )

    def decide_fn(pool, *recounts):
        local = [lm for lm, _ in recounts]
        # each site that actually had missing pool entries made one device
        # count call during its recount — ledgered HERE, from the recount
        # results, exactly as gfm_mine counts it
        comm.count_calls += sum(1 for _, nm in recounts if nm)
        comm.add_round(sum(nm for _, nm in recounts), _itemset_bytes(k), s)
        counts = aggregate_counts(pool, local)
        decided = {its: (c, c >= g_min) for its, c in counts.items()}
        topdown_search(sites, local, decided, g_min, comm, k, backend, pool_sizes)
        frequent = {its: c for its, (c, ok) in decided.items() if ok}
        return GFMResult(
            frequent=frequent, comm=comm, local=local, pool_sizes=pool_sizes, n_total_tx=n_total
        )

    jobs.append(
        SiteJob(
            name="decide",
            fn=timed(decide_fn, measured, "decide", device),
            deps=["pool", *[f"recount_{i}" for i in range(s)]],
        )
    )
    return jobs
