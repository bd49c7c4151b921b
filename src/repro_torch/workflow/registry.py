"""Workload registry — the one seam through which ``GridRuntime.run`` and
the mining service (``launch.serve``) find a mining application.

Every workload registers one :class:`WorkloadSpec`:

  * identity — ``name``, ``dataset_kind`` ("transactions" | "points"),
    ``runner`` and ``description``;
  * **param schema** — ``Param`` entries with kind, default and docs;
    ``resolve`` installs the defaults, coerces the values and rejects
    unknown keys; ``validate_submitted`` is the service's submit-time
    check (unknown and internal keys and non-finite floats are rejected
    before a request is admitted);
  * **result schema** — ``result_fields`` plus a ``digest`` callable
    producing the canonical JSON-able form that runs are compared by,
    bit for bit — across execution backends, and against the JAX
    package's digest of the same run;
  * **how to run it** — grid workloads provide ``build_jobs`` (SiteJob DAG
    + sync mode, consumed by ``GridRuntime.run``) and the service-side
    ``site_split``/``grid_params`` adapters; local (delta-served)
    workloads provide ``local_fn`` (+ optional ``finalize``);
  * **smoke params** — the small param points the service's CLI trace
    and the tests exercise.

Registered, in the JAX package's order: ``apriori`` (local, the delta
path), ``gfm`` (the paper's Algorithm 2), ``fdm`` (its comparison point),
``cd_apriori`` (count distribution), ``topk`` (local, streaming top-k),
``kmeans`` (local, warm-started) and ``vclustering`` (Algorithm 1).  The
order matters: the service's CLI trace draws its pool from
``workloads()`` in registration order, so the same seed gives the same
trace in both packages.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import numpy as np

DATASET_KINDS = ("transactions", "points")
RUNNERS = ("grid", "local")
PARAM_KINDS = ("int", "float", "str", "bool", "any")


@dataclass(frozen=True)
class Param:
    """One entry of a workload's param schema.

    ``kind`` drives coercion (``int``/``float``/``str``/``bool``, or
    ``any`` for pass-through); ``default`` is installed by ``resolve``
    (None means "no value": the workload substitutes its own default,
    e.g. gfm's ``local_minsup`` falls back to ``minsup`` and the service
    substitutes its ``n_sites``); ``internal`` params carry non-JSON
    values (config objects, initial centres) from runtime callers to
    ``build_jobs`` and are REJECTED at service submit."""

    name: str
    kind: str = "any"
    default: Any = None
    doc: str = ""
    internal: bool = False

    def coerce(self, v: Any) -> Any:
        if v is None or self.kind == "any":
            return v
        try:
            if self.kind == "int":
                # bool is an int subclass; floats must be integral, not
                # truncated ("k": 2.5 is a mistake, not 2)
                if isinstance(v, float) and (not math.isfinite(v) or v != int(v)):
                    raise ValueError(f"expected an integer, got {v!r}")
                return int(v)
            if self.kind == "float":
                return float(v)
            if self.kind == "bool":
                return bool(v)
            return str(v)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"param {self.name!r} expects {self.kind}, got {v!r} ({e})"
            ) from None


def _reject_nonfinite(name: str, v: Any) -> None:
    """Recursively reject non-finite floats in a submitted param value —
    ``params_key`` is total over them (the backstop), but a request
    carrying an inf/nan minsup is malformed and must be a ledgered
    rejection, not a queued execution."""
    if isinstance(v, float) and not math.isfinite(v):
        raise ValueError(f"param {name!r} is non-finite ({v!r}); rejected at submit")
    if isinstance(v, dict):
        for k, x in v.items():
            _reject_nonfinite(f"{name}.{k}", x)
    elif isinstance(v, (list, tuple, set, frozenset)):
        for x in v:
            _reject_nonfinite(name, x)


@dataclass(frozen=True)
class RunContext:
    """What a ``build_jobs`` function may use from its host runtime:
    the measured-times dict the jobs feed, the support-count backend, the
    K-Means assignment kernel toggle, the device the site data lives on,
    and (clustering) the runtime's sync-strategy factory
    ``cluster_sync(n_sites, cfg) -> (sync_fn | None, mode)``."""

    measured: dict = field(default_factory=dict)
    count_backend: str = "kernel"
    use_kernel: bool = True
    device: Any = None
    cluster_sync: Callable | None = None


@dataclass(frozen=True)
class WorkloadSpec:
    """Everything the framework needs to know about one mining workload.

    Grid workloads (``runner="grid"``) run a SiteJob DAG through
    ``GridRuntime.run``: ``build_jobs(data, params, ctx)`` returns
    ``(jobs, sync_mode)`` and ``terminal`` names the job whose result is
    the run's result.  ``site_split(ds, params, svc)`` and
    ``grid_params(params, svc)`` adapt a service dataset + submitted
    params into that call.  Local workloads (``runner="local"``) are
    served in-process from per-dataset incremental state:
    ``local_fn(ds, params, svc)`` returns the zero-arg callable the
    service ledgers as a single-job DAG; ``finalize(ds, params, value)``
    optionally folds the result back into dataset state (k-means
    warm-start centroids).

    ``exec_batch_key(ds, params)`` is the cross-request batching opt-in:
    given the dataset state and the resolved params (``n_sites``
    substituted by the service), it returns a hashable signature — two
    execution groups in the same service wave whose workloads report the
    SAME signature (same app, dataset, version, and signature tuple) run
    as ONE fused dispatch (``GridRuntime.run_many`` for grid workloads,
    one merged engine run for local ones), with measured device time
    apportioned per request.  The signature pins every value that changes
    job shapes or DAG structure (``k`` levels, ``n_sites``/``split_seed``,
    ``k_local``/``iters``); only params the job factories accept per member
    (thresholds, seeds) may be left out.  ``None`` (the default, and a
    valid return value) means the workload never fuses across requests —
    e.g. ``kmeans``, whose warm-start ``finalize`` makes serial wave order
    observable."""

    name: str
    dataset_kind: str  # "transactions" | "points"
    runner: str  # "grid" | "local"
    description: str
    params: tuple[Param, ...]
    result_fields: tuple[str, ...]
    digest: Callable[[Any], dict]
    # grid runner pieces
    build_jobs: Callable | None = None
    terminal: str = "collect"
    site_split: Callable | None = None
    grid_params: Callable | None = None
    # local runner pieces
    local_fn: Callable | None = None
    finalize: Callable | None = None
    # cross-request batching opt-in: (ds, resolved_params) -> hashable
    # signature, or None to never fuse (see the class docstring)
    exec_batch_key: Callable | None = None
    smoke_params: tuple[dict, ...] = ()
    conformance: bool = False  # compared bit for bit across execution backends

    def schema(self) -> dict[str, Param]:
        return {p.name: p for p in self.params}

    def public_params(self) -> tuple[Param, ...]:
        return tuple(p for p in self.params if not p.internal)

    def resolve(self, params: dict | None) -> dict:
        """Defaults + coercion over the full schema (internal params
        allowed) — what ``build_jobs`` and the executors consume.  Unknown keys
        raise: a knob the workload does not read must not look as if it
        did something."""
        out = {p.name: p.default for p in self.params}
        sch = self.schema()
        for k, v in (params or {}).items():
            if k not in sch:
                raise ValueError(
                    f"app {self.name!r} has no param {k!r}; "
                    f"known params: {tuple(sch)}"
                )
            out[k] = sch[k].coerce(v)
        return out

    def validate_submitted(self, params: dict | None) -> dict:
        """Submit-time validation: the coerced copy of exactly the keys
        the tenant sent.  Rejects unknown keys, internal-only keys, and
        non-finite numerics — with a ValueError naming the offender."""
        sch = self.schema()
        out: dict = {}
        for k, v in (params or {}).items():
            p = sch.get(str(k))
            if p is None or p.internal:
                public = tuple(q.name for q in self.public_params())
                raise ValueError(
                    f"app {self.name!r} does not accept param {k!r}; "
                    f"accepted params: {public}"
                )
            _reject_nonfinite(p.name, v)
            out[p.name] = p.coerce(v)
        return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, WorkloadSpec] = {}


def register(spec: WorkloadSpec) -> WorkloadSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"workload {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def workloads() -> tuple[WorkloadSpec, ...]:
    """Every registered spec, in registration order."""
    return tuple(_REGISTRY.values())


def app_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def conformance_apps() -> tuple[str, ...]:
    """The grid workloads whose digests must be bit-identical across
    execution backends."""
    return tuple(s.name for s in _REGISTRY.values() if s.conformance)


def get_workload(name: str) -> WorkloadSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown app {name!r}; expected one of {app_names()}"
        ) from None


def validate_registry() -> list[str]:
    """Every registered workload must be fully specified.  Returns
    human-readable problems (empty = clean)."""
    problems: list[str] = []
    for spec in _REGISTRY.values():
        where = f"workload {spec.name!r}"
        if not spec.name:
            problems.append("workload with empty name")
        if spec.dataset_kind not in DATASET_KINDS:
            problems.append(f"{where}: bad dataset_kind {spec.dataset_kind!r}")
        if spec.runner not in RUNNERS:
            problems.append(f"{where}: bad runner {spec.runner!r}")
        if not spec.description:
            problems.append(f"{where}: missing description")
        if not spec.params:
            problems.append(f"{where}: declares no param schema")
        seen: set[str] = set()
        for p in spec.params:
            if p.kind not in PARAM_KINDS:
                problems.append(f"{where}: param {p.name!r} has bad kind {p.kind!r}")
            if not p.doc:
                problems.append(f"{where}: param {p.name!r} has no doc")
            if p.name in seen:
                problems.append(f"{where}: duplicate param {p.name!r}")
            seen.add(p.name)
        if not spec.result_fields:
            problems.append(f"{where}: declares no result schema (result_fields)")
        if not callable(spec.digest):
            problems.append(f"{where}: digest is not callable")
        if spec.runner == "grid":
            for attr in ("build_jobs", "site_split", "grid_params"):
                if not callable(getattr(spec, attr)):
                    problems.append(f"{where}: grid workload missing {attr}")
            if not spec.terminal:
                problems.append(f"{where}: grid workload missing terminal job name")
        elif not callable(spec.local_fn):
            problems.append(f"{where}: local workload missing local_fn")
        if spec.exec_batch_key is not None and not callable(spec.exec_batch_key):
            problems.append(f"{where}: exec_batch_key must be callable or None")
        if not spec.smoke_params:
            problems.append(f"{where}: declares no smoke_params")
        for sp in spec.smoke_params:
            try:
                spec.validate_submitted(sp)
            except ValueError as e:
                problems.append(f"{where}: smoke params {sp!r} invalid: {e}")
    return problems


def app_table_markdown() -> str:
    """The registry as a markdown table (app, data, runner, public params
    with their defaults, result fields)."""
    lines = [
        "| App | Data | Runner | Params | Result |",
        "|---|---|---|---|---|",
    ]
    for s in workloads():
        params = ", ".join(
            f"`{p.name}`" + (f"={p.default}" if p.default is not None else "")
            for p in s.public_params()
        )
        result = ", ".join(f"`{f}`" for f in s.result_fields)
        lines.append(f"| `{s.name}` | {s.dataset_kind} | {s.runner} | {params} | {result} |")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Shared digest helpers
# ---------------------------------------------------------------------------


def comm_digest(comm) -> dict:
    """CommLog in canonical JSON-able form (compared bit for bit across
    execution backends and against the JAX package)."""
    return {
        "rounds": int(comm.rounds),
        "bytes_sent": int(comm.bytes_sent),
        "messages": int(comm.messages),
        "count_calls": int(comm.count_calls),
        "per_round_bytes": [int(b) for b in comm.per_round_bytes],
    }


def _frequent_digest(frequent: dict) -> dict:
    return {",".join(map(str, its)): int(c) for its, c in sorted(frequent.items())}


# ---------------------------------------------------------------------------
# The built-in workload family, in the JAX package's order
# ---------------------------------------------------------------------------


def _sites_on_device(data, ctx: RunContext) -> list:
    """The sites' TransactionDBs on the runtime's device."""
    if ctx.device is not None:
        data = [db.to(ctx.device) for db in data]
    return data


def _tx_sites(ds, p, svc) -> list:
    """Service-side split of a transactions dataset into per-site DBs on
    the service's device."""
    from repro_torch.core.apriori import TransactionDB
    from repro_torch.data.synthetic import split_transactions

    n = p["n_sites"] if p["n_sites"] is not None else svc.n_sites
    return [
        TransactionDB.from_dense(s, device=svc.device)
        for s in split_transactions(ds.pooled_dense(), int(n), seed=p["split_seed"])
    ]


def _pt_sites(ds, p, svc):
    """Service-side split of a points dataset into (S, n, D) site points
    (host numpy; ``vclustering``'s ``build_jobs`` moves them to the device)."""
    from repro_torch.data.synthetic import split_sites

    n = p["n_sites"] if p["n_sites"] is not None else svc.n_sites
    return split_sites(ds.pooled_points(), int(n), seed=p["split_seed"])


_SPLIT_PARAMS = (
    Param("n_sites", "int", None, "sites to split the dataset across (service default)"),
    Param("split_seed", "int", 0, "seed for the site split"),
)
# the service's split; GridRuntime is handed sites already split
SPLIT_PARAM_NAMES = tuple(p.name for p in _SPLIT_PARAMS)

_MINE_PARAMS = (
    Param("k", "int", 3, "maximum itemset size"),
    Param("minsup", "float", 0.1, "global minimum support fraction"),
)


def _mine_grid_params(p, svc) -> dict:
    return {"k": p["k"], "minsup": p["minsup"]}


def _mine_exec_key(ds, p) -> tuple:
    """Threshold-only cross-request variation for the level-synchronous
    miners (fdm / gfm / cd_apriori): ``k`` pins the DAG depth and
    ``n_sites``/``split_seed`` pin the padded site shapes, so two groups
    sharing this signature differ only in support thresholds — which the
    job factories' fused fan-outs accept per member."""
    return (p["k"], p["n_sites"], p["split_seed"])


# -- apriori (local, delta-served) ------------------------------------------


def _apriori_local(ds, p, svc):
    if p["min_count"] is not None:
        mc = p["min_count"]
    else:
        mc = max(1, int(math.ceil(p["minsup"] * ds.delta.n_tx)))
    return lambda: ds.delta.query(p["k"], mc)


def _delta_exec_key(ds, p) -> tuple:
    """Delta-served local workloads (apriori / topk) fuse unconditionally:
    the fused local path invokes each group's callable in wave order
    inside one merged engine run — identical to the serial per-group
    path, with the shared delta state serving every member from one warm
    cache.  kmeans has NO hook: its warm-start finalize makes results
    depend on whether a sibling's centroids landed before the callable
    was built."""
    return ()


def _digest_localmine(r) -> dict:
    return {
        "counts": _frequent_digest(r.counts),
        "frequent": {
            str(lv): [",".join(map(str, its)) for its in sorted(r.frequent[lv])]
            for lv in sorted(r.frequent)
        },
    }


register(WorkloadSpec(
    name="apriori",
    dataset_kind="transactions",
    runner="local",
    description="incremental Apriori over the dataset's delta state "
                "(bit-identical to from-scratch mining of the stream)",
    params=(
        Param("k", "int", 3, "maximum itemset size"),
        Param("minsup", "float", 0.1, "minimum support fraction (ignored if min_count given)"),
        Param("min_count", "int", None, "absolute minimum count (overrides minsup)"),
    ),
    result_fields=("counts", "frequent", "count_calls", "candidates_counted"),
    digest=_digest_localmine,
    local_fn=_apriori_local,
    exec_batch_key=_delta_exec_key,
    smoke_params=({"k": 3, "minsup": 0.3}, {"k": 2, "minsup": 0.4}),
))


# -- gfm (grid) --------------------------------------------------------------


def _gfm_build(data, p, ctx: RunContext):
    from repro_torch.core.gfm import gfm_site_jobs

    jobs = gfm_site_jobs(
        _sites_on_device(data, ctx), p["k"], p["minsup"],
        backend=ctx.count_backend,
        local_minsup=p["local_minsup"],
        measured=ctx.measured,
    )
    return jobs, "host"


def _digest_gfm(r) -> dict:
    return {
        "frequent": _frequent_digest(r.frequent),
        "comm": comm_digest(r.comm),
        "pool_sizes": [int(x) for x in r.pool_sizes],
        "n_total_tx": int(r.n_total_tx),
    }


register(WorkloadSpec(
    name="gfm",
    dataset_kind="transactions",
    runner="grid",
    description="the paper's Grid Frequent-itemset Mining: per-site local "
                "Apriori, ONE 2-pass synchronization, top-down descent",
    params=_MINE_PARAMS + (
        Param("local_minsup", "float", None, "per-site local support (default: minsup)"),
    ) + _SPLIT_PARAMS,
    result_fields=("frequent", "comm", "local", "pool_sizes", "n_total_tx"),
    digest=_digest_gfm,
    build_jobs=_gfm_build,
    terminal="decide",
    site_split=_tx_sites,
    grid_params=_mine_grid_params,
    exec_batch_key=_mine_exec_key,
    smoke_params=({"k": 2, "minsup": 0.35}, {"k": 2, "minsup": 0.45}),
    conformance=True,
))


# -- fdm (grid) --------------------------------------------------------------


def _fdm_build(data, p, ctx: RunContext):
    from repro_torch.core.fdm import fdm_site_jobs

    jobs = fdm_site_jobs(
        _sites_on_device(data, ctx), p["k"], p["minsup"], backend=ctx.count_backend, measured=ctx.measured
    )
    return jobs, "host"


def _digest_fdm(r) -> dict:
    return {
        "frequent": _frequent_digest(r.frequent),
        "comm": comm_digest(r.comm),
        "per_level_candidates": [int(c) for c in r.per_level_candidates],
    }


register(WorkloadSpec(
    name="fdm",
    dataset_kind="transactions",
    runner="grid",
    description="FDM baseline: k level-synchronous candidate/announce/"
                "remote-support rounds (the paper's comparison point)",
    params=_MINE_PARAMS + _SPLIT_PARAMS,
    result_fields=("frequent", "comm", "remote_count_time",
                   "total_count_time", "per_level_candidates"),
    digest=_digest_fdm,
    build_jobs=_fdm_build,
    terminal="collect",
    site_split=_tx_sites,
    grid_params=_mine_grid_params,
    exec_batch_key=_mine_exec_key,
    smoke_params=({"k": 2, "minsup": 0.35}, {"k": 2, "minsup": 0.45}),
    conformance=True,
))


# -- cd_apriori (grid) -------------------------------------------------------


def _cd_build(data, p, ctx: RunContext):
    from repro_torch.core.cdapriori import cd_site_jobs

    jobs = cd_site_jobs(
        _sites_on_device(data, ctx), p["k"], p["minsup"], backend=ctx.count_backend, measured=ctx.measured
    )
    return jobs, "host"


def _digest_cd(r) -> dict:
    return {
        "frequent": _frequent_digest(r.frequent),
        "comm": comm_digest(r.comm),
        "per_level_candidates": [int(c) for c in r.per_level_candidates],
        "n_total_tx": int(r.n_total_tx),
    }


register(WorkloadSpec(
    name="cd_apriori",
    dataset_kind="transactions",
    runner="grid",
    description="count-distribution Apriori (arXiv:1903.03008): every site "
                "counts the one shared candidate set, one count-vector "
                "exchange per level",
    params=_MINE_PARAMS + _SPLIT_PARAMS,
    result_fields=("frequent", "comm", "per_level_candidates", "n_total_tx"),
    digest=_digest_cd,
    build_jobs=_cd_build,
    terminal="collect",
    site_split=_tx_sites,
    grid_params=_mine_grid_params,
    exec_batch_key=_mine_exec_key,
    smoke_params=({"k": 2, "minsup": 0.35}, {"k": 2, "minsup": 0.45}),
    conformance=True,
))


# -- topk (local, delta-served) ----------------------------------------------


def _topk_local(ds, p, svc):
    from repro_torch.core.apriori import topk_itemsets

    return lambda: topk_itemsets(ds.delta, p["k"], p["top"], floor=p["floor"])


def _digest_topk(r) -> dict:
    return {
        "items": [[",".join(map(str, its)), int(c)] for its, c in r.items],
        "threshold": int(r.threshold),
        "k_max": int(r.k_max),
    }


register(WorkloadSpec(
    name="topk",
    dataset_kind="transactions",
    runner="local",
    description="streaming top-k frequent itemsets over the delta path "
                "(threshold-halving search, counts served from the cache)",
    params=(
        Param("k", "int", 3, "maximum itemset size"),
        Param("top", "int", 10, "how many itemsets to return"),
        Param("floor", "int", 1, "smallest support threshold the search may reach"),
    ),
    result_fields=("items", "threshold", "k_max", "count_calls"),
    digest=_digest_topk,
    local_fn=_topk_local,
    exec_batch_key=_delta_exec_key,
    smoke_params=({"k": 2, "top": 5}, {"k": 2, "top": 3}),
))


# -- kmeans (local, warm-started) -------------------------------------------


def _kmeans_local(ds, p, svc):
    """The pooled points go to the service's device inside the callable,
    so the request's measured compute includes the copy.  A warm start
    (the centroids a previous version's fit left) wins over a cold one;
    a cold start seeds k-means++ from ``seed``, or starts from the
    internal ``init_centers``."""
    import torch

    from repro_torch.core.kmeans import kmeans, kmeans_warm

    k, iters, dev = p["k"], p["iters"], svc.device
    x = ds.pooled_points()
    warm = ds.warm_centers.get(k)
    if warm is not None:
        return lambda: kmeans_warm(
            torch.from_numpy(x).to(dev), torch.tensor(warm, device=dev), iters=iters, use_kernel=svc.use_kernel
        )
    init = p["init_centers"]
    if init is not None:
        init = torch.as_tensor(init, dtype=torch.float32, device=dev)
    return lambda: kmeans(
        torch.from_numpy(x).to(dev), k, iters=iters, use_kernel=svc.use_kernel, init_centers=init, seed=p["seed"]
    )


def _kmeans_finalize(ds, p, value) -> None:
    """A host copy of the fit's centroids: the cached result keeps its own
    tensor, and nothing later can change this one in place."""
    ds.warm_centers[p["k"]] = np.array(value.centers.cpu(), dtype=np.float32)


def _digest_kmeans(r) -> dict:
    """Assignments as a Python list: for the CPU tests' sizes.  At the
    paper's 5e7 points compare the tensors with ``torch.equal`` instead."""
    return {
        "assign": np.asarray(r.assign.cpu()).astype(int).tolist(),
        "inertia": float(r.inertia),
    }


register(WorkloadSpec(
    name="kmeans",
    dataset_kind="points",
    runner="local",
    description="pooled K-Means, warm-started from the previous version's "
                "centroids after each append",
    params=(
        Param("k", "int", 3, "number of clusters"),
        Param("iters", "int", 25, "Lloyd iterations"),
        Param("seed", "int", 0, "k-means++ seed for a cold start"),
        Param("init_centers", "any", None, "(k, D) initial centres in place of k-means++ (runtime callers)",
              internal=True),
    ),
    result_fields=("centers", "assign", "inertia", "stats"),
    digest=_digest_kmeans,
    local_fn=_kmeans_local,
    finalize=_kmeans_finalize,
    smoke_params=({"k": 3, "iters": 10}, {"k": 4, "iters": 10}),
))


# -- vclustering (grid) ------------------------------------------------------

# k_local and iters when no cfg is given (a cfg carries its own)
_VCLUSTER_DEFAULTS = {"k_local": 8, "iters": 15}


def _vcluster_build(data, p, ctx: RunContext):
    import torch

    from repro_torch.core.vclustering import VClusterConfig, vcluster_site_jobs

    xs = torch.as_tensor(data, dtype=torch.float32, device=ctx.device)
    if xs.dim() != 3:
        raise ValueError(f"vclustering wants site points (S, n, D), got shape {tuple(xs.shape)}")
    cfg = p["cfg"]
    if cfg is None:
        cfg = VClusterConfig(
            k_local=_VCLUSTER_DEFAULTS["k_local"] if p["k_local"] is None else p["k_local"],
            kmeans_iters=_VCLUSTER_DEFAULTS["iters"] if p["iters"] is None else p["iters"],
        )
    elif p["k_local"] is not None or p["iters"] is not None:
        raise ValueError("vclustering takes k_local and iters either as params or inside cfg, not both")
    # the runtime owns the kernel choice; a cfg may only restate it
    if cfg.use_kernel is None:
        cfg = cfg._replace(use_kernel=ctx.use_kernel)
    elif cfg.use_kernel != ctx.use_kernel:
        raise ValueError(
            f"cfg.use_kernel={cfg.use_kernel} disagrees with the runtime's use_kernel={ctx.use_kernel}; "
            "set it on GridRuntime and leave it None in cfg"
        )
    init = p["init_centers"]
    if init is not None:
        init = torch.as_tensor(init, dtype=torch.float32, device=xs.device)
    if ctx.cluster_sync is not None:
        sync, mode = ctx.cluster_sync(xs.shape[0], cfg)
    else:
        sync, mode = None, "pooled"
    jobs = vcluster_site_jobs(xs, cfg, seed=p["seed"], init_centers=init, sync=sync, measured=ctx.measured)
    return jobs, mode


def _vcluster_grid_params(p, svc) -> dict:
    """The params ``GridRuntime.run`` takes for one service request: the
    seed, and ``k_local``/``iters`` or a runtime caller's internal
    ``cfg``; internal ``init_centers`` pass through (the kernel choice is
    the service runtime's)."""
    out = {"seed": p["seed"], "init_centers": p["init_centers"]}
    if p["cfg"] is not None:
        return {**out, "cfg": p["cfg"]}
    return {**out, "k_local": p["k_local"], "iters": p["iters"]}


def _vcluster_exec_key(ds, p) -> tuple | None:
    """``k_local``/``iters`` fix the site jobs' shapes and
    ``n_sites``/``split_seed`` the sites, so only the k-means++ ``seed``
    may vary across fused members.  Runtime callers passing an internal
    ``cfg`` or ``init_centers`` never fuse."""
    if p["cfg"] is not None or p["init_centers"] is not None:
        return None
    k_local = _VCLUSTER_DEFAULTS["k_local"] if p["k_local"] is None else p["k_local"]
    iters = _VCLUSTER_DEFAULTS["iters"] if p["iters"] is None else p["iters"]
    return (k_local, iters, p["n_sites"], p["split_seed"])


def _digest_vclustering(r) -> dict:
    """Labels as a Python list: for the CPU tests' sizes.  At the paper's
    5e7 points compare label tensors with ``torch.equal`` instead."""
    return {
        "labels": np.asarray(r.labels.cpu()).astype(int).tolist(),
        "n_global": int(r.merged.n_global),
        "n_merges": int(r.merged.n_merges),
        "comm_bytes": int(r.comm_bytes),
    }


register(WorkloadSpec(
    name="vclustering",
    dataset_kind="points",
    runner="grid",
    description="the paper's Algorithm 1: per-site K-Means, gather + "
                "logical merge, border perturbation",
    params=(
        Param("k_local", "int", None, f"sub-clusters per site ({_VCLUSTER_DEFAULTS['k_local']} without cfg)"),
        Param("iters", "int", None, f"K-Means iterations per site ({_VCLUSTER_DEFAULTS['iters']} without cfg)"),
        Param("seed", "int", 0, "k-means++ seed (site i draws from (seed, i))"),
        Param("cfg", "any", None, "explicit VClusterConfig (runtime callers)", internal=True),
        Param("init_centers", "any", None,
              "per-site (S, k_local, D) initial centres, in place of k-means++ (runtime callers)", internal=True),
    ) + _SPLIT_PARAMS,
    result_fields=("labels", "merged", "site_stats", "comm_bytes"),
    digest=_digest_vclustering,
    build_jobs=_vcluster_build,
    terminal="collect",
    site_split=_pt_sites,
    grid_params=_vcluster_grid_params,
    exec_batch_key=_vcluster_exec_key,
    smoke_params=({"k_local": 4, "iters": 8}, {"k_local": 4, "iters": 8, "seed": 1}),
    conformance=True,
))
