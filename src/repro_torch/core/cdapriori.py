"""Count-distribution Apriori — the classic distributed Apriori variant
from the companion performance study ("Performance Study of Distributed
Apriori-like Frequent Itemsets Mining", arXiv:1903.03008; originally
Agrawal & Shafer's Count Distribution).

Protocol, level-synchronous like FDM but deliberately simpler: at every
level l = 1..k

  1. ONE candidate set is generated from the globally frequent (l-1)-sets
     — identical on every site, no per-site pruning and therefore no
     remote-support phase at all (the step FDM pays ~13% of its compute
     for);
  2. every site counts ALL candidates over its local shard;
  3. one exchange sums the per-site count vectors — the globally frequent
     l-sets fall out of the totals directly.

⇒ k communication rounds like FDM, but each round moves the full count
vector (|C_l| counts per site) instead of FDM's pruned announcements:
count distribution trades bandwidth for zero redundant counting and a
trivially balanced computation.  Counting runs on the same backends as
GFM/FDM (``count_supports`` / the CUDA support-count kernels), so
the three protocols differ only in what they communicate.

The per-site local passes are served through :class:`DeltaApriori`
(seeded from the site shard via ``from_db``): each level's candidates go
through ``counts_for``/``fold_exact``, so anything the site has already
measured — the singleton seed pass, or any earlier query against the
same state — is served from the cumulative cache instead of re-counted.

This module is registered through the workload plugin registry
(``workflow.registry``) ONLY — nothing hand-wires it into the runtime,
which is the point: it is the proof that the registry seam carries a
whole new mining app.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.apriori import (
    DeltaApriori,
    Itemset,
    TransactionDB,
    apriori_join,
    fused_count_sites,
)
from repro_torch.core.gfm import CommLog, _itemset_bytes


@dataclass
class CDAprioriResult:
    frequent: dict[Itemset, int]  # globally frequent -> exact global count
    comm: CommLog
    per_level_candidates: list[int]
    n_total_tx: int


def _level_candidates(level: int, n_items: int, prev_global: list[Itemset]) -> list[Itemset]:
    """The ONE candidate set of level ``level`` — a pure function of the
    globally frequent (l-1)-sets, so every site derives it identically."""
    if level == 1:
        return [(i,) for i in range(n_items)]
    return apriori_join(prev_global)


def cd_mine(
    sites: list[TransactionDB],
    k: int,
    minsup: float,
    backend: str = "torch",
) -> CDAprioriResult:
    """In-process count-distribution run — the oracle the SiteJob
    decomposition must match bit-for-bit (same frequents, counts, and
    CommLog)."""
    s = len(sites)
    n_total = sum(db.n_tx for db in sites)
    g_min = int(np.ceil(minsup * n_total))
    comm = CommLog()
    frequent: dict[Itemset, int] = {}
    per_level: list[int] = []
    states = [DeltaApriori.from_db(db, backend=backend) for db in sites]
    comm.count_calls += s  # the singleton seed pass, one per site

    prev_global: list[Itemset] = []
    for level in range(1, k + 1):
        cands = _level_candidates(level, sites[0].n_items, prev_global)
        per_level.append(len(cands))
        if not cands:
            break
        totals: dict[Itemset, int] = dict.fromkeys(cands, 0)
        for st in states:
            fresh = st.uncached(cands)
            cnt = st.counts_for(cands)
            if fresh:
                comm.count_calls += 1
            for its in cands:
                totals[its] += cnt[its]
        # the round: every site broadcasts its FULL count vector
        comm.add_round(len(cands) * s, _itemset_bytes(level), s)
        glob = [(its, c) for its, c in totals.items() if c >= g_min]
        frequent.update(dict(glob))
        prev_global = [its for its, _ in glob]
        if not prev_global:
            break

    return CDAprioriResult(
        frequent=frequent,
        comm=comm,
        per_level_candidates=per_level,
        n_total_tx=n_total,
    )


# ---------------------------------------------------------------------------
# SiteJob decomposition (level-synchronous CD through the one scheduler)
# ---------------------------------------------------------------------------


def cd_site_jobs(
    sites: list[TransactionDB],
    k: int,
    minsup: float,
    backend: str = "torch",
    measured: dict | None = None,
) -> list:
    """Decompose count-distribution Apriori into
    ``workflow.sitejob.SiteJob``s: per level l, ``count_l_i`` (every site
    counts the whole candidate set) -> ``reduce_l`` (one global sum +
    threshold, one ledgered round).  All k levels are laid out
    statically; levels past exhaustion no-op.  The terminal ``collect``
    job's result is a ``CDAprioriResult`` equal to ``cd_mine``'s.

    Same multihost discipline as ``fdm_site_jobs``: per-site jobs are
    closure-pure toward the SHARED ledger (their device-pass flags and
    timings travel in their results; only the sync jobs fold into the
    CommLog).  Each site's per-level ``DeltaApriori`` state is mutated
    only by that site's own count jobs, which the ownership map pins to
    one process for the whole run.  Run without fault injection (a
    retried sync job would ledger twice).

    The ``count_l_*`` fan-out carries ``batch_key``/``batched_fn``: under
    the ``batched`` backend each level's never-seen candidates count as
    ONE fused site-axis dispatch (``fused_count_sites`` folded back via
    ``DeltaApriori.fold_exact``) — result- and ledger-identical to the
    per-site loop.
    """
    from repro_torch.workflow.sitejob import SiteJob, timed, timed_batch

    s = len(sites)
    n_items = sites[0].n_items
    n_total = sum(db.n_tx for db in sites)
    g_min = int(np.ceil(minsup * n_total))
    device = sites[0].packed.device if sites else None
    comm = CommLog()
    per_level: list[int] = []
    jobs: list[SiteJob] = []
    # per-site local-pass state, created by that site's level-1 count job
    # (on its OWNING process under multihost) and reused every level
    states: list[DeltaApriori | None] = [None] * s

    def _state(i: int) -> DeltaApriori:
        if states[i] is None:
            states[i] = DeltaApriori.from_db(sites[i], backend=backend)
        return states[i]

    def count_fn(level, i):
        def fn(prev=None):
            if level > 1 and (prev is None or not prev["global"]):
                return None  # search exhausted at an earlier level
            cands = _level_candidates(level, n_items, prev["global"] if prev else [])
            t0 = time.perf_counter()
            st = _state(i)
            # passes: device invocations this level, as cd_mine ledgers
            # them — the level-1 singleton seed, or one pass over the
            # never-seen candidates
            passes = 1 if level == 1 else (1 if st.uncached(cands) else 0)
            cnt = st.counts_for(cands)
            return {"cands": cands, "cnt": cnt, "t": time.perf_counter() - t0,
                    "passes": passes}

        return fn

    def count_batched(level):
        def fused(bargs, argss):
            # bargs carry (site, state_accessor): each member's
            # DeltaApriori belongs to ITS OWN request's build closure —
            # in a cross-request merged wave (``GridRuntime.run_many``) serving one
            # request's counts from another's cumulative cache would
            # corrupt the ledgered pass counts.  Candidates and
            # exhaustion are per member too (each member's prev dep is
            # its own request's reduce, and requests with different
            # minsup exhaust at different levels); within one engine run
            # all members share one reduce dep, which degenerates to the
            # old all-or-nothing early-out exactly.
            prevs = [args[0] if args else None for args in argss]
            live = [
                j for j in range(len(bargs))
                if level == 1 or (prevs[j] is not None and prevs[j]["global"])
            ]
            outs: list[dict | None] = [None] * len(bargs)
            if not live:
                return outs
            t0 = time.perf_counter()
            cands_by = [
                _level_candidates(level, n_items, prevs[j]["global"] if prevs[j] else [])
                for j in live
            ]
            sts = [bargs[j][1](bargs[j][0]) for j in live]
            missing_by = [st.uncached(cands) for st, cands in zip(sts, cands_by)]
            if any(missing_by):
                sups = fused_count_sites(
                    [st.stream() for st in sts], missing_by, backend=backend
                )
                for st, missing, sup in zip(sts, missing_by, sups):
                    st.fold_exact(missing, sup)
            share = (time.perf_counter() - t0) / max(len(live), 1)
            for j, st, cands, missing in zip(live, sts, cands_by, missing_by):
                passes = 1 if level == 1 else (1 if missing else 0)
                outs[j] = {"cands": cands, "cnt": st.counts_for(cands),
                           "t": share, "passes": passes}
            return outs

        return fused

    def reduce_fn(level):
        def fn(*outs):
            if any(o is None for o in outs):
                return None  # search exhausted (all-or-nothing per level)
            cands = outs[0]["cands"]
            per_level.append(len(cands))
            if not cands:
                return None
            comm.count_calls += sum(o["passes"] for o in outs)
            comm.add_round(len(cands) * s, _itemset_bytes(level), s)
            totals = {its: sum(o["cnt"][its] for o in outs) for its in cands}
            glob = [(its, c) for its, c in totals.items() if c >= g_min]
            return {"global": [its for its, _ in glob], "frequent": dict(glob)}

        return fn

    for level in range(1, k + 1):
        prev_dep = [f"reduce_{level - 1}"] if level > 1 else []
        count_batched_fn = timed_batch(count_batched(level), measured, device)
        for i in range(s):
            jobs.append(
                SiteJob(
                    name=f"count_{level}_{i}",
                    fn=timed(count_fn(level, i), measured, f"count_{level}_{i}", device),
                    deps=list(prev_dep),
                    site=i,
                    batch_key=f"count_{level}",
                    batched_fn=count_batched_fn,
                    batch_arg=(i, _state),
                )
            )
        jobs.append(
            SiteJob(
                name=f"reduce_{level}",
                fn=timed(reduce_fn(level), measured, f"reduce_{level}", device),
                deps=[f"count_{level}_{i}" for i in range(s)],
            )
        )

    def collect_fn(*decisions):
        frequent: dict[Itemset, int] = {}
        for dec in decisions:
            if dec is not None:
                frequent.update(dec["frequent"])
        return CDAprioriResult(
            frequent=frequent,
            comm=comm,
            per_level_candidates=per_level,
            n_total_tx=n_total,
        )

    jobs.append(
        SiteJob(
            name="collect",
            fn=timed(collect_fn, measured, "collect", device),
            deps=[f"reduce_{level}" for level in range(1, k + 1)],
        )
    )
    return jobs
