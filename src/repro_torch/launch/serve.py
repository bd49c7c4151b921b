"""Continuous mining service — a long-lived, multi-tenant serving layer
over the grid runtime, on the CUDA card.

Everything below ``launch`` runs ONE application's DAG and reports; real
grid load ("Mining the Workload of Real Grid Computing Systems",
arXiv:1412.2673) is a bursty stream of arrivals from many users.
:class:`MiningService` closes that gap in-process (no network):

  * **submit/poll/result** — tenants submit mining requests (app +
    dataset + params) and poll for completion; admission control rejects
    into bounded per-tenant queues (``workflow.requests.TenantQueues``),
    and a deterministic weighted round-robin picker keeps tenants fair.
  * **incremental per-dataset state** — appended transaction batches
    fold into a ``core.apriori.DeltaApriori`` (queries are bit-identical
    to from-scratch Apriori over the concatenation, at O(|delta|) device
    cost per append); k-means queries warm-start from the previous
    version's centroids (``core.kmeans.kmeans_warm``) on drifting data;
    the service keeps those centroids as a host copy.
  * **coalescing + batched dispatch** — concurrent identical requests
    (same dataset version, app, canonical params) become ONE execution,
    and every execution runs through the engine's execution backends
    (``batched`` by default: shape-identical fan-out jobs fuse into one
    kernel launch over the site axis; ``inline`` runs them one by one;
    ``multihost`` partitions sites across the processes of a gloo group).
  * **cross-request batching** — execution groups in the same wave whose
    workloads report a compatible batch signature
    (``WorkloadSpec.exec_batch_key``: same app, dataset, version, and
    signature tuple — e.g. two ``fdm`` queries differing only in minsup)
    run as ONE fused device dispatch (``GridRuntime.run_many`` merges
    their DAGs under shared ``batch_key``s), digest-identical to serial
    per-group execution, with measured device time apportioned per
    request; the ledger reports ``exec_groups`` / ``fused_requests`` /
    ``device_dispatches`` per wave.
  * **versioned result cache** — completed results are cached under
    ``(dataset, dataset_version, app, params)``
    (``runtime.cache.ResultCache``); any append bumps the version, so a
    stale result is unreachable by key construction.
  * **ledger** — per-request and per-tenant records (queue wait, compute
    share, cache hit, backend used) in the same spirit as the engine's
    ``RunReport``, JSON-serializable for the CI smoke's artifact.

Device and kernels: the service runs on the CUDA card unless the caller
passes ``device="cpu"``, and counts and assigns with the hand-written
kernels (``count_backend="kernel"``, ``use_kernel=True``), as
``GridRuntime`` does; the JAX package's service defaults to its plain
``jnp`` path.  The counts are exact and the K-Means kernel equals its
plain version bit for bit, so the defaults change no result.  Every
request's measured compute ends in a CUDA synchronize.

The CLI (a bursty synthetic multi-tenant trace; ``--check`` gates the
fairness bound, cache hits, coalescing and cross-request fusion)::

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 50 --tenants 3 \
        --backend batched --check --ledger-out service_ledger.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

import numpy as np

import torch

from repro_torch.core.apriori import DeltaApriori
from repro_torch.data.synthetic import gaussian_mixture, ibm_transactions
from repro_torch.runtime.cache import ResultCache, params_key
from repro_torch.runtime.gridruntime import GridRuntime
from repro_torch.workflow.registry import app_names, get_workload, workloads
from repro_torch.workflow.requests import (
    MiningRequest,
    QueueFullError,
    TenantQueues,
    coalesce,
    request_ids,
)
from repro_torch.workflow.sitejob import SiteJob, timed, timed_batch

# the ONE source of truth for the app family is the workload registry;
# this module adds no app knowledge of its own
APPS = app_names()


@dataclass
class _Dataset:
    """Per-dataset incremental state the service maintains across appends."""

    name: str
    kind: str  # "transactions" | "points"
    version: int = 0
    # transactions: the appended dense batches (host) plus the delta-Apriori
    # state (on the service's device)
    n_items: int | None = None
    delta: DeltaApriori | None = None
    tx_batches: list = field(default_factory=list)
    # points: appended (n, dim) host batches plus per-k warm-start centroids
    dim: int | None = None
    pt_batches: list = field(default_factory=list)
    warm_centers: dict = field(default_factory=dict)  # k -> np.ndarray (k, dim)

    def pooled_points(self) -> np.ndarray:
        return np.concatenate(self.pt_batches, axis=0)

    def pooled_dense(self) -> np.ndarray:
        return np.concatenate(self.tx_batches, axis=0)


class MiningService:
    """In-process multi-tenant mining service over :class:`GridRuntime`.

    One instance owns the datasets, the tenant queues, the result cache
    and the runtime; :meth:`step` is the scheduler tick — a fair pick of
    queued requests, coalesced by execution key, served from cache or
    executed through the engine's execution backend.

    ``device`` is where the data and the kernels live: None means the
    CUDA card (a host without one raises; pass ``device="cpu"`` for the
    plain PyTorch path there).  A given ``runtime`` brings its own device.
    """

    def __init__(
        self,
        runtime: GridRuntime | None = None,
        backend: str = "batched",
        n_sites: int = 4,
        max_depth: int = 64,
        weights: dict[str, float] | None = None,
        cache_capacity: int | None = 256,
        count_backend: str = "kernel",
        use_kernel: bool = True,
        clock=time.monotonic,
        fuse_requests: bool = True,
        failure_memo_capacity: int = 128,
        device: str | torch.device | None = None,
    ):
        if runtime is None:
            runtime = GridRuntime(
                backend=backend,
                sync="pooled",  # no served result depends on whether a process group is up
                use_kernel=use_kernel,
                count_backend=count_backend,
                device=device,
            )
        elif device is not None and torch.device(device) != runtime.device:
            raise ValueError(f"device {device!r} differs from the runtime's {runtime.device}")
        self.runtime = runtime
        self.device = runtime.device
        self.backend_name = runtime.engine.backend.name
        self.n_sites = int(n_sites)
        self.use_kernel = use_kernel
        self.count_backend = count_backend
        self.queues = TenantQueues(max_depth=max_depth, weights=weights)
        self.cache = ResultCache(cache_capacity)
        self._ids = request_ids()
        self._requests: dict[int, MiningRequest] = {}
        self._results: dict[int, Any] = {}
        self._datasets: dict[str, _Dataset] = {}
        self._clock = clock
        self.executions = 0  # execution groups actually run (fused or not)
        self.coalesced = 0  # requests served by another request's run
        self.invalid = 0  # submissions rejected by param validation
        self.rejected_full = 0  # submissions rejected by a full tenant queue
        # cross-request batching ledger: distinct execution groups that
        # reached the dispatch stage, requests served by a fused
        # multi-group dispatch, and engine invocations actually made
        # (fusion drives device_dispatches < executions)
        self.fuse_requests = bool(fuse_requests)
        self.exec_groups = 0
        self.fused_requests = 0
        self.device_dispatches = 0
        # failed-execution ledger: real failed attempts, plus the
        # short-circuits served from the failure memo — a bounded map
        # keyed by the full execution key (dataset VERSION included, so
        # any append invalidates the memo by key construction: TTL = the
        # dataset version)
        self.failures = 0
        self.failure_memo_hits = 0
        self._failure_memo: OrderedDict[tuple, str] = OrderedDict()
        self._failure_memo_cap = int(failure_memo_capacity)
        # tenant pick order, for the fairness audit (CI gates a prefix
        # bound on this while every tenant stays backlogged)
        self.pick_log: list[str] = []

    # -- datasets -------------------------------------------------------------

    def register_dataset(
        self, name: str, kind: str = "transactions", *, n_items: int | None = None,
        dim: int | None = None,
    ) -> None:
        if kind not in ("transactions", "points"):
            raise ValueError(f"unknown dataset kind {kind!r}")
        if name in self._datasets:
            raise ValueError(f"dataset {name!r} already registered")
        if kind == "transactions":
            if n_items is None:
                raise ValueError("transactions dataset needs n_items")
            ds = _Dataset(name=name, kind=kind, n_items=int(n_items),
                          delta=DeltaApriori(int(n_items), backend=self.count_backend,
                                             device=self.device))
        else:
            if dim is None:
                raise ValueError("points dataset needs dim")
            ds = _Dataset(name=name, kind=kind, dim=int(dim))
        self._datasets[name] = ds

    def _dataset(self, name: str) -> _Dataset:
        try:
            return self._datasets[name]
        except KeyError:
            raise KeyError(f"unknown dataset {name!r}; register_dataset first") from None

    def append_transactions(self, name: str, dense_batch: np.ndarray) -> int:
        """Append one dense bool (n_tx, n_items) batch; folds into the
        delta-Apriori state and bumps ``version``.  Returns the version."""
        ds = self._dataset(name)
        if ds.kind != "transactions":
            raise ValueError(f"dataset {name!r} holds points, not transactions")
        dense = np.asarray(dense_batch, dtype=bool)
        ds.delta.append(dense)
        ds.tx_batches.append(dense)
        ds.version = ds.delta.version
        return ds.version

    def append_points(self, name: str, points: np.ndarray) -> int:
        """Append one (n, dim) point batch; bumps ``version``.  Previous
        per-k centroids are KEPT — they seed the next warm-started fit."""
        ds = self._dataset(name)
        if ds.kind != "points":
            raise ValueError(f"dataset {name!r} holds transactions, not points")
        pts = np.asarray(points, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != ds.dim:
            raise ValueError(f"expected (n, {ds.dim}) points, got {pts.shape}")
        ds.pt_batches.append(pts)
        ds.version += 1
        return ds.version

    def dataset_version(self, name: str) -> int:
        return self._dataset(name).version

    # -- request lifecycle ----------------------------------------------------

    def submit(self, tenant: str, app: str, dataset: str, params: dict | None = None) -> int:
        """Admit one request; returns its id.  Raises ``QueueFullError``
        when the tenant's queue is at capacity (the rejected request stays
        in the ledger) and ``ValueError`` on app/dataset mismatch or
        malformed params.  App names, dataset-kind checks and param
        validation all derive from the workload registry — a malformed
        request (unknown param, non-finite float) becomes a LEDGERED
        rejection here, never a crash in the dispatch loop."""
        spec = get_workload(app)  # ValueError: unknown app
        ds = self._dataset(dataset)
        if ds.kind != spec.dataset_kind:
            raise ValueError(
                f"app {app!r} needs a {spec.dataset_kind} dataset; "
                f"{dataset!r} is {ds.kind}"
            )
        req = MiningRequest(
            request_id=next(self._ids),
            tenant=str(tenant),
            app=app,
            dataset=dataset,
            params=dict(params or {}),
            submitted_at=self._clock(),
        )
        try:
            req.params = spec.validate_submitted(params)
        except ValueError as e:
            req.status = "rejected"
            req.error = f"{type(e).__name__}: {e}"
            req.finished_at = self._clock()
            self._requests[req.request_id] = req
            self.invalid += 1
            raise
        self._requests[req.request_id] = req
        try:
            self.queues.push(req)  # marks req rejected on a full queue
        except QueueFullError as e:
            # unify with the param-rejection path: a queue-full rejection
            # is a LEDGERED terminal state too — reason and finish time
            # set, counted service-level (it would otherwise report
            # service_s == 0.0 with no error and no counter)
            req.error = f"{type(e).__name__}: {e}"
            req.finished_at = self._clock()
            self.rejected_full += 1
            raise
        return req.request_id

    def poll(self, request_id: int) -> str:
        return self._requests[request_id].status

    def result(self, request_id: int) -> Any:
        req = self._requests[request_id]
        if req.status == "done":
            return self._results[request_id]
        if req.status == "failed":
            raise RuntimeError(f"request {request_id} failed: {req.error}")
        raise RuntimeError(f"request {request_id} is {req.status}, not done")

    def request(self, request_id: int) -> MiningRequest:
        return self._requests[request_id]

    # -- the scheduler tick ---------------------------------------------------

    def _exec_key(self, req: MiningRequest) -> tuple:
        return (req.dataset, req.dataset_version, req.app, params_key(req.params))

    def step(self, max_requests: int = 8) -> list[int]:
        """One dispatch wave: fair-pick up to ``max_requests`` queued
        requests, coalesce identical ones, serve from cache (or the
        failure memo), then bucket the remaining execution groups by
        their workload's cross-request batch signature — same-signature
        groups run as ONE fused device dispatch, everything else runs
        serially per group.  Returns the ids completed (done or failed)
        this wave."""
        batch = self.queues.pick_batch(max_requests)
        now = self._clock()
        for req in batch:
            req.status = "running"
            req.started_at = now
            req.dataset_version = self._datasets[req.dataset].version
            self.pick_log.append(req.tenant)
        finished: list[int] = []
        pending: list[tuple[tuple, tuple, list[MiningRequest]]] = []
        for ekey, reqs in coalesce(batch, self._exec_key).items():
            rep = reqs[0]
            for other in reqs[1:]:
                other.coalesced_into = rep.request_id
            self.coalesced += len(reqs) - 1
            ckey = ResultCache.key(rep.dataset, rep.dataset_version, rep.app, rep.params)
            value = self.cache.get(ckey)
            if value is not None:
                self._finish(reqs, value, compute_s=0.0, backend="cache", cache_hit=True)
                finished.extend(r.request_id for r in reqs)
                continue
            memo_err = self._failure_memo.get(ekey)
            if memo_err is not None:
                # a deterministically-failing request resubmitted by a
                # polling tenant short-circuits here instead of paying a
                # full grid run every wave; the memo key includes the
                # dataset version, so any append retries for real
                self.failure_memo_hits += 1
                self._fail(reqs, memo_err, backend="failure-memo")
                finished.extend(r.request_id for r in reqs)
                continue
            pending.append((ekey, ckey, reqs))
        self.exec_groups += len(pending)
        for bucket in self._fuse_buckets(pending):
            finished.extend(self._run_bucket(bucket))
        return finished

    def drain(self, max_requests: int = 8, max_steps: int | None = None) -> list[int]:
        """Step until every queue is empty (or ``max_steps``); returns all
        ids completed."""
        done: list[int] = []
        steps = 0
        while self.queues.pending():
            done.extend(self.step(max_requests))
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return done

    def _finish(
        self, reqs, value, *, compute_s: float, backend: str, cache_hit: bool,
        fused: bool = False,
    ) -> None:
        tf = self._clock()
        share = compute_s / len(reqs)
        for req in reqs:
            req.status = "done"
            req.finished_at = tf
            req.cache_hit = cache_hit
            req.backend = backend
            req.compute_s = share
            req.fused = fused
            self._results[req.request_id] = value

    def _fail(
        self, reqs, err: str, *, backend: str | None = None, attempt_s: float = 0.0,
    ) -> None:
        """Terminal failure for one execution group — the attempt is
        LEDGERED like a completion: reason, finish time, the backend that
        ran (or "failure-memo" for short-circuits) and the attempt's wall
        time apportioned as the group's compute share."""
        tf = self._clock()
        share = attempt_s / max(len(reqs), 1)
        for req in reqs:
            req.status = "failed"
            req.error = err
            req.finished_at = tf
            if backend is not None:
                req.backend = backend
            req.compute_s = share

    def _memo_failure(self, ekey: tuple, err: str) -> None:
        self.failures += 1
        self._failure_memo[ekey] = err
        while len(self._failure_memo) > self._failure_memo_cap:
            self._failure_memo.popitem(last=False)

    # -- execution ------------------------------------------------------------

    def _fuse_signature(self, rep: MiningRequest):
        """The workload's cross-request batch signature for one execution
        group's representative, or None when the group must run solo
        (fusion disabled, no ``exec_batch_key`` hook, or the hook opted
        this param point out)."""
        if not self.fuse_requests:
            return None
        spec = get_workload(rep.app)
        if spec.exec_batch_key is None:
            return None
        p = spec.resolve(rep.params)
        if "n_sites" in p and p["n_sites"] is None:
            p = {**p, "n_sites": self.n_sites}
        return spec.exec_batch_key(self._datasets[rep.dataset], p)

    def _fuse_buckets(self, pending) -> list[list]:
        """Bucket the wave's pending execution groups: groups sharing
        (app, dataset, version, exec_batch_key signature) fuse into one
        dispatch; signature-None groups each get their own bucket.
        First-seen order — deterministic given the pick order."""
        buckets: OrderedDict[Any, list] = OrderedDict()
        for ekey, ckey, reqs in pending:
            rep = reqs[0]
            try:
                sig = self._fuse_signature(rep)
            except Exception:  # noqa: BLE001 — a bad signature hook must not kill the wave
                sig = None
            if sig is None:
                bkey = ("solo", rep.request_id)
            else:
                bkey = (rep.app, rep.dataset, rep.dataset_version, sig)
            buckets.setdefault(bkey, []).append((ekey, ckey, reqs))
        return list(buckets.values())

    def _run_bucket(self, bucket: list) -> list[int]:
        """Execute one bucket of same-signature execution groups: >= 2
        groups attempt ONE fused dispatch (falling back to serial
        per-group execution if the fused attempt throws — fusion is an
        optimization, never a correctness dependency); solo groups run
        the serial path directly."""
        if len(bucket) >= 2:
            try:
                return self._execute_fused(bucket)
            except Exception:  # noqa: BLE001 — fall back to per-group serial
                pass
        finished: list[int] = []
        for ekey, ckey, reqs in bucket:
            rep = reqs[0]
            if rep.status == "done":
                # a fused attempt that threw mid-completion (e.g. in a
                # finalize hook) may have finished earlier groups already
                finished.extend(r.request_id for r in reqs)
                continue
            t0 = self._clock()
            self.device_dispatches += 1
            try:
                value, compute_s, backend = self._execute(rep)
            except Exception as e:  # noqa: BLE001 — one bad request must not kill the service
                err = f"{type(e).__name__}: {e}"
                self._memo_failure(ekey, err)
                self._fail(reqs, err, backend=self.backend_name,
                           attempt_s=self._clock() - t0)
                finished.extend(r.request_id for r in reqs)
                continue
            self._complete_group(ckey, reqs, value, compute_s, backend, fused=False)
            finished.extend(r.request_id for r in reqs)
        return finished

    def _complete_group(
        self, ckey, reqs, value, compute_s: float, backend: str, *, fused: bool,
    ) -> None:
        rep = reqs[0]
        spec = get_workload(rep.app)
        if fused and spec.finalize is not None:
            # serial execution finalizes inside _execute; the fused path
            # folds state back here, per group in wave order
            spec.finalize(self._datasets[rep.dataset], spec.resolve(rep.params), value)
        self.cache.put(ckey, value)
        self.executions += 1
        if fused:
            self.fused_requests += len(reqs)
        self._finish(reqs, value, compute_s=compute_s, backend=backend,
                     cache_hit=False, fused=fused)

    def _execute_fused(self, bucket: list) -> list[int]:
        """ONE device dispatch for >= 2 same-signature execution groups.
        Grid workloads merge their SiteJob DAGs through
        ``GridRuntime.run_many`` (shared ``batch_key``s fuse the fan-outs
        across requests); local workloads run their per-group callables
        as one merged engine run.  Measured device time is apportioned
        per request exactly like ``timed_batch`` does per job."""
        reps = [reqs[0] for _, _, reqs in bucket]
        spec = get_workload(reps[0].app)
        ds = self._datasets[reps[0].dataset]
        self.device_dispatches += 1
        if spec.runner == "grid":
            datas, plists = [], []
            for rep in reps:
                p = spec.resolve(rep.params)
                datas.append(spec.site_split(ds, p, self))
                plists.append(spec.grid_params(p, self))
            runs = self.runtime.run_many(reps[0].app, datas, plists)
            values = [(r.result, r.compute_s, r.backend) for r in runs]
        else:
            values = self._run_many_local(reps, spec, ds)
        finished: list[int] = []
        for (_ekey, ckey, reqs), (value, compute_s, backend) in zip(bucket, values):
            self._complete_group(ckey, reqs, value, compute_s, backend, fused=True)
            finished.extend(r.request_id for r in reqs)
        return finished

    def _run_many_local(self, reps, spec, ds) -> list[tuple[Any, float, str]]:
        """Merged engine run for >= 2 local (delta-served) execution
        groups: one single-job DAG per group, all sharing a ``batch_key``
        so the batched backend serves the whole wave in one call (the
        fused fn just invokes each group's callable — the win is one
        engine invocation, and the delta state serves every member from
        one warm cache)."""
        measured: dict[str, float] = {}

        def fused(bargs, argss):
            return [fn() for fn in bargs]

        bfn = timed_batch(fused, measured, device=self.device)
        jobs = []
        for j, rep in enumerate(reps):
            p = spec.resolve(rep.params)
            fn = spec.local_fn(ds, p, self)
            name = f"r{j}/{rep.app}"
            jobs.append(SiteJob(name=name, fn=timed(fn, measured, name, device=self.device),
                                batch_key="local", batched_fn=bfn, batch_arg=fn))
        rep_, results = self.runtime.engine.run_site_jobs(
            jobs, name=f"serve-{reps[0].app}-fused{len(reps)}")
        return [
            (results[f"r{j}/{r.app}"], rep_.job_times.get(f"r{j}/{r.app}", 0.0),
             rep_.backend)
            for j, r in enumerate(reps)
        ]

    def _execute(self, req: MiningRequest) -> tuple[Any, float, str]:
        """Run one representative request; returns (result, measured
        device compute seconds, backend name).  Entirely table-driven off
        the workload registry: local (delta-served) workloads run their
        ``local_fn`` as a single ledgered job, grid workloads split the
        dataset with the spec's ``site_split`` and go through the generic
        ``GridRuntime.run`` — no per-app branches, so a registered app
        can NEVER reach an "unknown app" dead end here (submit already
        proved it is registered)."""
        spec = get_workload(req.app)
        ds = self._datasets[req.dataset]
        p = spec.resolve(req.params)
        if spec.runner == "local":
            fn = spec.local_fn(ds, p, self)
            value, compute_s, backend = self._run_single(req, fn)
            if spec.finalize is not None:
                spec.finalize(ds, p, value)
            return value, compute_s, backend
        data = spec.site_split(ds, p, self)
        run = self.runtime.run(req.app, data, spec.grid_params(p, self))
        return run.result, run.report.compute_s, run.backend

    def _run_single(self, req: MiningRequest, fn) -> tuple[Any, float, str]:
        """Execute a single-job DAG through the engine so the request is
        ledgered exactly like any grid run (RunReport, backend, measured
        compute feeding the simulated clock)."""
        name = f"{req.app}"
        measured: dict[str, float] = {}
        jobs = [SiteJob(name=name, fn=timed(fn, measured, name, device=self.device))]
        rep, results = self.runtime.engine.run_site_jobs(
            jobs, name=f"serve-{req.app}-{req.request_id}")
        return results[name], rep.compute_s, rep.backend

    # -- ledger ---------------------------------------------------------------

    def ledger(self) -> dict:
        """Service-level + per-request + per-tenant ledger, JSON-ready."""
        requests = [self._record(r) for r in sorted(self._requests.values(),
                                                    key=lambda r: r.request_id)]
        return {
            "backend": self.backend_name,
            "executions": self.executions,
            "coalesced": self.coalesced,
            "exec_groups": self.exec_groups,
            "fused_requests": self.fused_requests,
            "device_dispatches": self.device_dispatches,
            "failures": self.failures,
            "failure_memo_hits": self.failure_memo_hits,
            "rejected": self.queues.rejected + self.invalid,
            "rejected_full": self.rejected_full,
            "rejected_invalid": self.invalid,
            "cache": {
                "hits": self.cache.stats.hits,
                "misses": self.cache.stats.misses,
                "evictions": self.cache.stats.evictions,
                "hit_rate": self.cache.stats.hit_rate(),
                "entries": len(self.cache),
            },
            "per_tenant": self.tenant_ledger(),
            "requests": requests,
        }

    def tenant_ledger(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for req in self._requests.values():
            t = out.setdefault(req.tenant, {
                "submitted": 0, "done": 0, "failed": 0, "rejected": 0,
                "cache_hits": 0, "coalesced": 0, "fused": 0,
                "queue_wait_s": 0.0, "compute_s": 0.0, "service_s": 0.0,
            })
            t["submitted"] += 1
            if req.status in ("done", "failed", "rejected"):
                t[req.status] += 1
            if req.cache_hit:
                t["cache_hits"] += 1
            if req.coalesced_into is not None:
                t["coalesced"] += 1
            if req.fused:
                t["fused"] += 1
            t["queue_wait_s"] += req.queue_wait_s
            t["compute_s"] += req.compute_s
            t["service_s"] += req.service_s
        return out

    @staticmethod
    def _record(req: MiningRequest) -> dict:
        return {
            "request_id": req.request_id,
            "tenant": req.tenant,
            "app": req.app,
            "dataset": req.dataset,
            "dataset_version": req.dataset_version,
            "params": {str(k): v for k, v in req.params.items()},
            "status": req.status,
            "cache_hit": req.cache_hit,
            "coalesced_into": req.coalesced_into,
            "backend": req.backend,
            "fused": req.fused,
            "queue_wait_s": req.queue_wait_s,
            "compute_s": req.compute_s,
            "service_s": req.service_s,
            "error": req.error,
        }


# ---------------------------------------------------------------------------
# Fairness audit
# ---------------------------------------------------------------------------


def fairness_violations(pick_log: list[str], tenants: list[str], window: int) -> list[str]:
    """Audit the round-robin bound on a pick-log prefix during which every
    tenant was backlogged: with uniform weights, after any prefix of the
    first ``window`` picks the per-tenant pick counts differ by at most
    one.  Returns human-readable violations (empty = fair)."""
    counts = dict.fromkeys(tenants, 0)
    bad: list[str] = []
    for i, tenant in enumerate(pick_log[:window]):
        if tenant in counts:
            counts[tenant] += 1
        spread = max(counts.values()) - min(counts.values())
        if spread > 1:
            bad.append(f"after pick {i + 1}: per-tenant counts {counts} spread {spread} > 1")
    return bad


# ---------------------------------------------------------------------------
# The CLI: a bursty synthetic multi-tenant trace
# ---------------------------------------------------------------------------


def _build_service(args) -> MiningService:
    svc = MiningService(
        backend=args.backend,
        n_sites=args.n_sites,
        max_depth=args.max_depth,
        fuse_requests=not getattr(args, "no_fuse", False),
        device=args.device,
    )
    svc.register_dataset("tx", "transactions", n_items=args.n_items)
    svc.register_dataset("pts", "points", dim=2)
    svc.append_transactions("tx", ibm_transactions(args.seed, 240, args.n_items))
    pts, _ = gaussian_mixture(args.seed, 240, 2, 3)
    svc.append_points("pts", pts)
    return svc


def _trace_bursts(
    args, rng: np.random.Generator, pool: list[tuple[str, str, dict]] | None = None
) -> list[list[tuple[str, str, str, dict]]]:
    """A bursty multi-tenant trace: each burst opens with one request all
    tenants share (coalescing fodder) and — when the pool has one — a
    same-app different-params SIBLING of it (cross-request fusion
    fodder: the two land in the same dispatch wave with a shared batch
    signature), then per-tenant draws from a SMALL param pool, so
    repeats within a dataset version become cache hits.  The pool of
    (app, dataset, params) is by default the registry's smoke params —
    EVERY registered workload is in the trace for free."""
    tenants = [f"tenant{i}" for i in range(args.tenants)]
    if pool is None:
        pool = []
        for spec in workloads():
            dsname = "tx" if spec.dataset_kind == "transactions" else "pts"
            for smoke in spec.smoke_params:
                params = dict(smoke)
                if spec.runner == "grid":
                    params.setdefault("n_sites", args.n_sites)
                pool.append((spec.name, dsname, params))
    bursts: list[list[tuple[str, str, str, dict]]] = []
    remaining = args.requests
    while remaining > 0:
        burst: list[tuple[str, str, str, dict]] = []
        shared = pool[int(rng.integers(len(pool)))]
        for t in tenants:  # the burst's shared query — first in every queue
            burst.append((t, *shared))
        siblings = [e for e in pool if e[0] == shared[0] and e[2] != shared[2]]
        if siblings:
            sib = siblings[int(rng.integers(len(siblings)))]
            for t in tenants:  # same wave as the shared query → fuses
                burst.append((t, *sib))
        per_tenant = max(1, min(args.burst, remaining // max(len(tenants), 1)) - 1)
        for t in tenants:
            for _ in range(per_tenant):
                app, dataset, params = pool[int(rng.integers(len(pool)))]
                burst.append((t, app, dataset, params))
        bursts.append(burst)
        remaining -= len(burst)
    return bursts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=50, help="total requests in the trace")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--burst", type=int, default=4, help="max requests per tenant per burst")
    ap.add_argument("--backend", default="batched", choices=("inline", "batched", "multihost"))
    ap.add_argument("--n-sites", type=int, default=4)
    ap.add_argument("--n-items", type=int, default=12)
    ap.add_argument("--max-depth", type=int, default=64)
    ap.add_argument("--max-per-step", type=int, default=8)
    ap.add_argument("--append-every", type=int, default=2,
                    help="append fresh data every N bursts (version bump)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the service runs: the CUDA card by default; 'cpu' for the plain path")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable cross-request batching (the serial baseline)")
    ap.add_argument("--ledger-out", default=None, help="write the JSON ledger here")
    ap.add_argument("--check", action="store_true",
                    help="assert fairness bound, cache hits, coalescing and "
                         "cross-request fusion (CI gate)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    svc = _build_service(args)
    tenants = [f"tenant{i}" for i in range(args.tenants)]
    bursts = _trace_bursts(args, rng)

    fairness_ok = True
    fairness_detail: list[str] = []
    rejected = 0
    t0 = time.perf_counter()
    for b, burst in enumerate(bursts):
        for tenant, app, dataset, params in burst:
            try:
                svc.submit(tenant, app, dataset, params)
            except QueueFullError:
                rejected += 1
        # every tenant is backlogged right now: audit the fairness bound
        # over the picks that drain this burst's guaranteed backlog
        window = len(svc.pick_log) + min(svc.queues.depth(t) for t in tenants) * len(tenants)
        svc.drain(max_requests=args.max_per_step)
        viol = fairness_violations(svc.pick_log[:window], tenants, window)
        if viol:
            fairness_ok = False
            fairness_detail.extend(f"burst {b}: {v}" for v in viol[:3])
        if args.append_every and (b + 1) % args.append_every == 0:
            svc.append_transactions("tx", ibm_transactions(args.seed + b + 1, 60, args.n_items))
            pts, _ = gaussian_mixture(args.seed + b + 1, 60, 2, 3)
            svc.append_points("pts", pts)
    wall = time.perf_counter() - t0

    led = svc.ledger()
    done = [r for r in led["requests"] if r["status"] == "done"]
    failed = [r for r in led["requests"] if r["status"] == "failed"]
    lat = np.array([r["service_s"] for r in done]) if done else np.zeros(1)
    print(f"[serve] backend={led['backend']} requests={len(led['requests'])} "
          f"done={len(done)} failed={len(failed)} rejected={led['rejected']}")
    print(f"[serve] executions={led['executions']} coalesced={led['coalesced']} "
          f"cache hits={led['cache']['hits']} misses={led['cache']['misses']} "
          f"hit_rate={led['cache']['hit_rate']:.2f}")
    print(f"[serve] exec_groups={led['exec_groups']} "
          f"device_dispatches={led['device_dispatches']} "
          f"fused_requests={led['fused_requests']} "
          f"failures={led['failures']} memo_hits={led['failure_memo_hits']}")
    print(f"[serve] throughput={len(done) / max(wall, 1e-9):.1f} req/s "
          f"latency p50={np.percentile(lat, 50) * 1e3:.1f}ms "
          f"p95={np.percentile(lat, 95) * 1e3:.1f}ms")
    for tenant, t in sorted(led["per_tenant"].items()):
        print(f"[serve]   {tenant}: submitted={t['submitted']} done={t['done']} "
              f"cache_hits={t['cache_hits']} coalesced={t['coalesced']} "
              f"queue_wait={t['queue_wait_s']:.3f}s compute={t['compute_s']:.3f}s")
    print(f"[serve] fairness bound (round-robin, spread<=1): "
          f"{'OK' if fairness_ok else 'VIOLATED'}")

    if args.ledger_out:
        with open(args.ledger_out, "w") as f:
            json.dump(led, f, indent=2, default=float)
        print(f"[serve] ledger -> {args.ledger_out}")

    if args.check:
        problems: list[str] = []
        if failed:
            problems.append(f"{len(failed)} requests failed: {failed[0]['error']}")
        if led["cache"]["hits"] < 1:
            problems.append("expected cache hits on repeated queries, got 0")
        if led["coalesced"] < 1:
            problems.append("expected coalesced identical requests, got 0")
        if not fairness_ok:
            problems.append("fairness bound violated: " + "; ".join(fairness_detail))
        if not args.no_fuse and led["device_dispatches"] >= led["executions"]:
            problems.append(
                "expected cross-request fusion to drop device dispatches below "
                f"executions, got {led['device_dispatches']} >= {led['executions']}"
            )
        if problems:
            for p in problems:
                print(f"[serve] CHECK FAILED: {p}", file=sys.stderr)
            return 1
        print("[serve] checks passed: fairness bound, cache hits, coalescing, "
              "cross-request fusion")
    return 0


if __name__ == "__main__":
    sys.exit(main())
