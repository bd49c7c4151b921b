"""Workload registry — the one seam through which ``GridRuntime.run``
finds a mining application.

Every workload registers one :class:`WorkloadSpec`:

  * identity — ``name``, ``dataset_kind`` ("transactions" | "points"),
    ``runner`` and ``description``;
  * **param schema** — ``Param`` entries with kind, default and docs;
    ``resolve`` installs the defaults, coerces the values and rejects
    unknown keys;
  * **result schema** — ``result_fields`` plus a ``digest`` callable
    producing the canonical JSON-able form that runs are compared by,
    bit for bit — across execution backends, and against the JAX
    package's digest of the same run;
  * **how to run it** — ``build_jobs`` (SiteJob DAG + sync mode) and the
    ``terminal`` job whose result is the run's result.

Registered so far: ``gfm`` (the paper's Algorithm 2) and ``vclustering``
(Algorithm 1).  The other apps of the JAX package, and the mining
service's hooks, arrive with their own slices of the port (ROADMAP.md).
"""

from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import numpy as np

DATASET_KINDS = ("transactions", "points")
RUNNERS = ("grid",)  # in-process "local" workloads arrive with the service
PARAM_KINDS = ("int", "float", "str", "bool", "any")


@dataclass(frozen=True)
class Param:
    """One entry of a workload's param schema.

    ``kind`` drives coercion (``int``/``float``/``str``/``bool``, or
    ``any`` for pass-through); ``default`` is installed by ``resolve``
    (None means "no value": the workload substitutes its own default,
    e.g. gfm's ``local_minsup`` falls back to ``minsup``)."""

    name: str
    kind: str = "any"
    default: Any = None
    doc: str = ""

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


@dataclass(frozen=True)
class RunContext:
    """What a ``build_jobs`` function may use from its host runtime:
    the measured-times dict the jobs feed, the support-count backend, the
    K-Means assignment kernel toggle, and the device the site data lives
    on."""

    measured: dict = field(default_factory=dict)
    count_backend: str = "kernel"
    use_kernel: bool = True
    device: Any = None


@dataclass(frozen=True)
class WorkloadSpec:
    """Everything the framework needs to know about one mining workload.

    ``build_jobs(data, params, ctx)`` returns ``(jobs, sync_mode)`` — the
    SiteJob DAG ``GridRuntime.run`` schedules — and ``terminal`` names
    the job whose result is the run's result."""

    name: str
    dataset_kind: str  # "transactions" | "points"
    runner: str  # "grid"
    description: str
    params: tuple[Param, ...]
    result_fields: tuple[str, ...]
    digest: Callable[[Any], dict]
    build_jobs: Callable | None = None
    terminal: str = "collect"

    def schema(self) -> dict[str, Param]:
        return {p.name: p for p in self.params}

    def resolve(self, params: dict | None) -> dict:
        """Defaults + coercion over the schema — what ``build_jobs``
        consumes.  Unknown keys raise: a knob the workload does not read
        must not look as if it did something."""
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


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, WorkloadSpec] = {}


def register(spec: WorkloadSpec) -> WorkloadSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"workload {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def app_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


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
        if not callable(spec.build_jobs):
            problems.append(f"{where}: grid workload missing build_jobs")
        if not spec.terminal:
            problems.append(f"{where}: grid workload missing terminal job name")
    return problems


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
# gfm (grid)
# ---------------------------------------------------------------------------


def _gfm_build(data, p, ctx: RunContext):
    from repro_torch.core.gfm import gfm_site_jobs

    if ctx.device is not None:
        data = [db.to(ctx.device) for db in data]
    jobs = gfm_site_jobs(
        data, p["k"], p["minsup"],
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
    params=(
        Param("k", "int", 3, "maximum itemset size"),
        Param("minsup", "float", 0.1, "global minimum support fraction"),
        Param("local_minsup", "float", None, "per-site local support (default: minsup)"),
    ),
    result_fields=("frequent", "comm", "local", "pool_sizes", "n_total_tx"),
    digest=_digest_gfm,
    build_jobs=_gfm_build,
    terminal="decide",
))


# ---------------------------------------------------------------------------
# vclustering (grid)
# ---------------------------------------------------------------------------


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
    jobs = vcluster_site_jobs(xs, cfg, seed=p["seed"], init_centers=init, measured=ctx.measured)
    return jobs, "pooled"


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
        Param("cfg", "any", None, "explicit VClusterConfig (runtime callers)"),
        Param("init_centers", "any", None,
              "per-site (S, k_local, D) initial centres, in place of k-means++"),
    ),
    result_fields=("labels", "merged", "site_stats", "comm_bytes"),
    digest=_digest_vclustering,
    build_jobs=_vcluster_build,
    terminal="collect",
))
