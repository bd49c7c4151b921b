"""FDM baseline — Fast Distributed Mining of association rules (Cheung et
al., PDIS'96), the comparison algorithm the paper implements.

Level-synchronous protocol: at every level l = 1..k
  1. every site generates candidates from the GLOBALLY frequent (l-1)-sets
     (global pruning — the thing GFM deliberately drops),
  2. counts them locally; locally frequent candidates are announced,
  3. remote support counts are computed on request for candidates announced
     by OTHER sites (FDM's "remote support computation" — the paper
     measures it at ~13% of FDM's total compute time),
  4. a synchronization produces the globally frequent l-sets.

⇒ k communication/synchronization rounds (the paper's "4 instead of 2"),
each a barrier.  Counting uses the same backend as GFM so the comparison
isolates the PROTOCOL difference, exactly as in the paper.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.apriori import (
    Itemset,
    TransactionDB,
    apriori_join,
    count_supports,
    fused_count_sites,
    item_supports,
)
from repro_torch.core.gfm import CommLog, _itemset_bytes


@dataclass
class FDMResult:
    frequent: dict[Itemset, int]
    comm: CommLog
    remote_count_time: float  # seconds spent serving remote support requests
    total_count_time: float  # seconds in all support counting
    per_level_candidates: list[int]


def site_candidates(
    level: int, db: TransactionDB, prev_global: list[Itemset], prev_local_i: set[Itemset]
) -> list[Itemset]:
    """FDM per-site candidate generation: GL(l-1) restricted to the sets
    ALSO locally frequent at this site (local pruning), prefix-joined.
    Level 1 seeds with every singleton."""
    if level == 1:
        return [(i,) for i in range(db.n_items)]
    return apriori_join([its for its in prev_global if its in prev_local_i])


def fdm_mine(
    sites: list[TransactionDB],
    k: int,
    minsup: float,
    backend: str = "torch",
) -> FDMResult:
    s = len(sites)
    n_total = sum(db.n_tx for db in sites)
    g_min = int(np.ceil(minsup * n_total))
    comm = CommLog()
    frequent: dict[Itemset, int] = {}
    per_level: list[int] = []
    remote_t = 0.0
    total_t = 0.0

    l_min = [int(np.ceil(minsup * db.n_tx)) for db in sites]
    prev_global: list[Itemset] = []
    prev_local: list[set[Itemset]] = [set() for _ in sites]
    for level in range(1, k + 1):
        # -- per-site candidate generation: FDM joins GL(l-1) restricted to
        #    the sets ALSO locally frequent at this site (its local pruning;
        #    this is what shrinks per-site candidate sets vs plain Apriori
        #    but forces remote support requests later) --
        cands_by: list[list[Itemset]] = [
            site_candidates(level, sites[i], prev_global, prev_local[i]) for i in range(s)
        ]
        union_cands = sorted(set().union(*map(set, cands_by)), key=lambda t: (len(t), t))
        per_level.append(len(union_cands))
        if not union_cands:
            break

        # -- local counting + per-site announcement of locally frequents --
        local_counts: list[dict[Itemset, int]] = []
        announced_by: list[set[Itemset]] = []
        payload = 0
        for i, db in enumerate(sites):
            t0 = time.perf_counter()
            if level == 1:
                sup = item_supports(db)
            else:
                sup = count_supports(db, cands_by[i], backend=backend)
            total_t += time.perf_counter() - t0
            if level == 1 or cands_by[i]:
                comm.count_calls += 1  # only real device invocations
            cnt = {its: int(c) for its, c in zip(cands_by[i], np.asarray(sup))}
            local_counts.append(cnt)
            ann = {its for its in cands_by[i] if cnt[its] >= l_min[i]}
            announced_by.append(ann)
            payload += len(ann)

        announced = sorted(set().union(*announced_by), key=lambda t: (len(t), t))

        # -- remote support computation: each site serves requests for
        #    announced candidates it did NOT count locally (its pruning
        #    dropped them).  This is real extra compute — the step the paper
        #    measures at ~13% of FDM's total compute time. --
        for i, db in enumerate(sites):
            remote = [its for its in announced if its not in local_counts[i]]
            if remote:
                t0 = time.perf_counter()
                sup = count_supports(db, remote, backend=backend)
                dt = time.perf_counter() - t0
                remote_t += dt
                total_t += dt
                comm.count_calls += 1
                for its, c in zip(remote, np.asarray(sup)):
                    local_counts[i][its] = int(c)
            payload += len(remote)

        comm.add_round(payload, _itemset_bytes(level), s)

        # -- global decision --
        glob = []
        for its in announced:
            c = sum(lc[its] for lc in local_counts)
            if c >= g_min:
                glob.append((its, c))
        prev_global = [its for its, _ in glob]
        prev_local = [
            {its for its in prev_global if local_counts[i].get(its, 0) >= l_min[i]}
            for i in range(s)
        ]
        frequent.update(dict(glob))
        if not prev_global:
            break

    return FDMResult(
        frequent=frequent,
        comm=comm,
        remote_count_time=remote_t,
        total_count_time=total_t,
        per_level_candidates=per_level,
    )


# ---------------------------------------------------------------------------
# SiteJob decomposition (level-synchronous FDM through the one scheduler)
# ---------------------------------------------------------------------------


def fdm_site_jobs(
    sites: list[TransactionDB],
    k: int,
    minsup: float,
    backend: str = "torch",
    measured: dict | None = None,
) -> list:
    """Decompose FDM into ``workflow.sitejob.SiteJob``s: per level l,
    ``count_l_i`` (local counting) -> ``announce_l`` (locally-frequent
    exchange) -> ``remote_l_i`` (remote support computation) ->
    ``decide_l`` (global synchronization, one ledgered round).  All k
    levels are laid out statically; levels past exhaustion no-op.  The
    terminal ``collect`` job's result is an ``FDMResult`` equal to
    ``fdm_mine``'s.  The per-site jobs are closure-pure (ledger flags and
    timings travel in their results; only the sync jobs touch the shared
    CommLog), so the DAG partitions cleanly over multihost site ownership.
    Run without fault injection (a retried sync job would ledger twice).
    Safe under both engine schedulers: each level's ledger mutations are
    ordered by the dependency chain (count -> announce -> remote ->
    decide), which ``schedule="async"`` preserves.

    The per-level fan-outs (``count_l_i``, ``remote_l_i``) carry
    ``batch_key``/``batched_fn`` hooks: under the ``batched`` execution
    backend each level's counting runs as ONE fused site-axis dispatch
    (``fused_count_sites``) — result- and ledger-identical to the
    per-site loop.
    """
    from repro_torch.workflow.sitejob import SiteJob, timed, timed_batch

    s = len(sites)
    n_total = sum(db.n_tx for db in sites)
    g_min = int(np.ceil(minsup * n_total))
    l_min = [int(np.ceil(minsup * db.n_tx)) for db in sites]
    device = sites[0].packed.device if sites else None
    comm = CommLog()
    per_level: list[int] = []
    jobs: list[SiteJob] = []

    # The per-site jobs (count_l_i, remote_l_i) are CLOSURE-PURE: their
    # CommLog contribution ("counted" device-invocation flags) and their
    # measured counting time ("t") travel IN their results, and the sync
    # jobs (decide_l, collect) — which always co-locate with the shared
    # ledger under the multihost backend's site ownership — fold them into
    # ``comm`` and the FDMResult timings.  A closure mutation inside a
    # per-site job would be stranded on its owning process.

    def count_fn(level, i):
        db = sites[i]

        def fn(prev=None):
            if level > 1 and (prev is None or not prev["global"]):
                return None  # search exhausted at an earlier level
            prev_global = prev["global"] if prev else []
            prev_local_i = prev["local"][i] if prev else set()
            cands = site_candidates(level, db, prev_global, prev_local_i)
            t0 = time.perf_counter()
            sup = item_supports(db) if level == 1 else count_supports(db, cands, backend=backend)
            dt = time.perf_counter() - t0
            # counted: a real device invocation, as fdm_mine ledgers it
            counted = level == 1 or bool(cands)
            cnt = {its: int(c) for its, c in zip(cands, np.asarray(sup))}
            ann = {its for its in cands if cnt[its] >= l_min[i]}
            return {"cnt": cnt, "ann": ann, "t": dt, "counted": counted}

        return fn

    def count_batched(level):
        def fused(bargs, argss):
            # ``bargs`` carry ``(site, l_min_site)``: in a cross-request
            # merged wave (``GridRuntime.run_many`` — same shapes, different minsup)
            # the FIRST member's closure executes the whole group, so each
            # member's request-specific local threshold must travel in its
            # batch arg, not the closure.  Exhaustion is per MEMBER: each
            # member's prev dep is its own request's decide, so requests
            # may exhaust at different levels (within one request all
            # members share one decide dep, which degenerates to the old
            # all-or-nothing early-out exactly).
            prevs = [args[0] if args else None for args in argss]
            live = [
                j for j in range(len(bargs))
                if level == 1 or (prevs[j] is not None and prevs[j]["global"])
            ]
            outs: list[dict | None] = [None] * len(bargs)
            if not live:
                return outs
            cands_by = [
                site_candidates(
                    level,
                    sites[bargs[j][0]],
                    prevs[j]["global"] if prevs[j] else [],
                    prevs[j]["local"][bargs[j][0]] if prevs[j] else set(),
                )
                for j in live
            ]
            t0 = time.perf_counter()
            if level == 1:
                sups = [item_supports(sites[bargs[j][0]]) for j in live]
            else:
                sups = fused_count_sites(
                    [sites[bargs[j][0]] for j in live], cands_by, backend=backend
                )
            share = (time.perf_counter() - t0) / max(len(live), 1)
            for j, cands, sup in zip(live, cands_by, sups):
                _i, lmin = bargs[j]
                cnt = {its: int(c) for its, c in zip(cands, np.asarray(sup))}
                outs[j] = {
                    "cnt": cnt,
                    "ann": {its for its in cands if cnt[its] >= lmin},
                    "t": share,
                    "counted": level == 1 or bool(cands),
                }
            return outs

        return fused

    def announce_fn(level):
        def fn(*outs):
            if any(o is None for o in outs):
                return None  # search exhausted (all-or-nothing per level)
            union_cands = set()
            announced = set()
            payload = 0
            for o in outs:
                union_cands.update(o["cnt"].keys())
                announced.update(o["ann"])
                payload += len(o["ann"])
            per_level.append(len(union_cands))
            if not union_cands:
                return None
            return {
                "announced": sorted(announced, key=lambda t: (len(t), t)),
                "payload": payload,
            }

        return fn

    def remote_fn(level, i):
        db = sites[i]

        def fn(cout, ann):
            if cout is None or ann is None:
                return None
            remote = [its for its in ann["announced"] if its not in cout["cnt"]]
            dt = 0.0
            if remote:
                t0 = time.perf_counter()
                sup = count_supports(db, remote, backend=backend)
                dt = time.perf_counter() - t0
                for its, c in zip(remote, np.asarray(sup)):
                    cout["cnt"][its] = int(c)
            # carry this site's count-phase ledger entries forward — the
            # downstream decide job folds them into the shared CommLog
            return {
                "cnt": cout["cnt"],
                "n_remote": len(remote),
                "count_t": cout["t"],
                "count_counted": cout["counted"],
                "remote_t": dt,
            }

        return fn

    def remote_batched(level):
        def fused(bargs, argss):
            # each member brings its own request's count + announce deps;
            # exhausted members (cross-request fusion: another request's
            # search may have ended earlier) pass through as None while
            # the live members share one fused dispatch
            live = [
                j for j in range(len(bargs))
                if argss[j][0] is not None and argss[j][1] is not None
            ]
            outs: list[dict | None] = [None] * len(bargs)
            if not live:
                return outs
            remote_by = [
                [its for its in argss[j][1]["announced"] if its not in argss[j][0]["cnt"]]
                for j in live
            ]
            t0 = time.perf_counter()
            sups = fused_count_sites([sites[bargs[j]] for j in live], remote_by, backend=backend)
            dt = time.perf_counter() - t0 if any(remote_by) else 0.0
            share = dt / max(sum(1 for r in remote_by if r), 1)
            for j, remote, sup in zip(live, remote_by, sups):
                cout = argss[j][0]
                if remote:
                    for its, c in zip(remote, np.asarray(sup)):
                        cout["cnt"][its] = int(c)
                outs[j] = {
                    "cnt": cout["cnt"],
                    "n_remote": len(remote),
                    "count_t": cout["t"],
                    "count_counted": cout["counted"],
                    "remote_t": share if remote else 0.0,
                }
            return outs

        return fused

    def decide_fn(level):
        def fn(ann, *remotes):
            if ann is None:
                return None
            # ann non-None implies every count (and hence remote) is live,
            # so remotes[i] is site i's counts — positional, no filtering.
            # The per-site device-invocation flags shipped with the remote
            # results are ledgered HERE (one +1 per real count call, as
            # fdm_mine counts them): counts first, then remote serves.
            comm.count_calls += sum(1 for r in remotes if r["count_counted"])
            comm.count_calls += sum(1 for r in remotes if r["n_remote"])
            comm.add_round(
                ann["payload"] + sum(r["n_remote"] for r in remotes), _itemset_bytes(level), s
            )
            glob = []
            for its in ann["announced"]:
                c = sum(r["cnt"].get(its, 0) for r in remotes)
                if c >= g_min:
                    glob.append((its, c))
            prev_global = [its for its, _ in glob]
            prev_local = [
                {its for its in prev_global if remotes[i]["cnt"].get(its, 0) >= l_min[i]}
                for i in range(s)
            ]
            return {
                "global": prev_global,
                "local": prev_local,
                "frequent": dict(glob),
                "count_t": sum(r["count_t"] for r in remotes),
                "remote_t": sum(r["remote_t"] for r in remotes),
            }

        return fn

    for level in range(1, k + 1):
        prev_dep = [f"decide_{level - 1}"] if level > 1 else []
        count_batched_fn = timed_batch(count_batched(level), measured, device)
        remote_batched_fn = timed_batch(remote_batched(level), measured, device)
        for i in range(s):
            jobs.append(
                SiteJob(
                    name=f"count_{level}_{i}",
                    fn=timed(count_fn(level, i), measured, f"count_{level}_{i}", device),
                    deps=list(prev_dep),
                    site=i,  # GridModel.transfer_s normalizes to its link matrix
                    batch_key=f"count_{level}",
                    batched_fn=count_batched_fn,
                    batch_arg=(i, l_min[i]),
                )
            )
        jobs.append(
            SiteJob(
                name=f"announce_{level}",
                fn=timed(announce_fn(level), measured, f"announce_{level}", device),
                deps=[f"count_{level}_{i}" for i in range(s)],
            )
        )
        for i in range(s):
            jobs.append(
                SiteJob(
                    name=f"remote_{level}_{i}",
                    fn=timed(remote_fn(level, i), measured, f"remote_{level}_{i}", device),
                    deps=[f"count_{level}_{i}", f"announce_{level}"],
                    site=i,  # GridModel.transfer_s normalizes to its link matrix
                    batch_key=f"remote_{level}",
                    batched_fn=remote_batched_fn,
                    batch_arg=i,
                )
            )
        jobs.append(
            SiteJob(
                name=f"decide_{level}",
                fn=timed(decide_fn(level), measured, f"decide_{level}", device),
                deps=[f"announce_{level}", *[f"remote_{level}_{i}" for i in range(s)]],
            )
        )

    def collect_fn(*decisions):
        frequent: dict[Itemset, int] = {}
        remote_t = 0.0
        total_t = 0.0
        for dec in decisions:
            if dec is not None:
                frequent.update(dec["frequent"])
                remote_t += dec["remote_t"]
                total_t += dec["count_t"] + dec["remote_t"]
        return FDMResult(
            frequent=frequent,
            comm=comm,
            remote_count_time=remote_t,
            total_count_time=total_t,
            per_level_candidates=per_level,
        )

    jobs.append(
        SiteJob(
            name="collect",
            fn=timed(collect_fn, measured, "collect", device),
            deps=[f"decide_{level}" for level in range(1, k + 1)],
        )
    )
    return jobs
