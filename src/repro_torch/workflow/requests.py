"""Multi-tenant request stream primitives for the continuous mining
service — admission control and fair scheduling over per-tenant queues.

The paper's workflow engine runs ONE application's DAG; real grid load
("Mining the Workload of Real Grid Computing Systems", arXiv:1412.2673)
is a bursty stream of arrivals from many users.  This module is the
request-side half of that gap, deliberately kept in ``workflow`` next to
the scheduler whose per-site slot/queue machinery the service leans on:

  * :class:`MiningRequest` — one tenant's mining query (app + dataset +
    params), with the lifecycle timestamps the service's ledger reports;
  * :class:`TenantQueues` — bounded per-tenant FIFO queues (admission
    control: a full queue REJECTS instead of growing without bound) with
    a deterministic fair picker: round-robin across tenants with pending
    work, or weighted round-robin when tenants carry weights — a tenant
    is never starved while it has queued work, and with equal weights
    and saturated queues the per-pick counts across tenants differ by
    at most one per cycle (the fairness bound the CLI's ``--check`` gates).

Execution — coalescing identical requests, fused dispatch on the card,
the result cache — is the service's job (``launch.serve``).  Pure Python:
the port keeps its own copy of the JAX package's
``repro.workflow.requests``, with the same picking order.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any

REQUEST_STATES = ("queued", "running", "done", "failed", "rejected")

# Hard per-cycle burst ceiling for weighted round-robin.  Normalizing a
# fractional weight map by its smallest entry preserves ratios exactly,
# but an extreme map like ``{a: 1.0, b: 1e-6}`` would then grant tenant
# ``a`` a ~1e6-pick burst before the cursor ever reaches ``b`` — a
# starvation window no ratio is worth.  Grants are therefore clamped to
# this bound: ratios are honored exactly up to MAX_BURST:1 and saturate
# beyond it, so within any cycle every backlogged tenant is picked at
# least once per MAX_BURST picks of any other tenant.
MAX_BURST = 16


class QueueFullError(RuntimeError):
    """Admission control: the tenant's bounded queue is at capacity."""


@dataclass
class MiningRequest:
    """One mining query from one tenant, as the service tracks it.

    ``params`` are app-specific (e.g. ``{"k": 3, "minsup": 0.1}``); the
    service canonicalizes them (``runtime.cache.params_key``) for both
    coalescing and cache keying.  Timestamps are service-clock seconds
    (``submitted_at`` set at admission, ``started_at`` when the request
    leaves its queue for execution, ``finished_at`` at completion);
    ``queue_wait_s``/``service_s`` are derived for the ledger.
    """

    request_id: int
    tenant: str
    app: str
    dataset: str
    params: dict = field(default_factory=dict)
    status: str = "queued"
    submitted_at: float = 0.0
    started_at: float | None = None
    finished_at: float | None = None
    # filled at completion by the service's ledger:
    dataset_version: int | None = None
    cache_hit: bool = False
    coalesced_into: int | None = None  # request_id whose execution served this
    backend: str | None = None
    compute_s: float = 0.0  # this request's share of measured device compute
    fused: bool = False  # served by a cross-request fused dispatch
    error: str | None = None

    @property
    def queue_wait_s(self) -> float:
        if self.started_at is None:
            return 0.0
        return max(self.started_at - self.submitted_at, 0.0)

    @property
    def service_s(self) -> float:
        """Admission to completion — the tenant-visible latency."""
        if self.finished_at is None:
            return 0.0
        return max(self.finished_at - self.submitted_at, 0.0)


class TenantQueues:
    """Bounded per-tenant FIFO queues with deterministic weighted
    round-robin picking.

    ``max_depth`` bounds EACH tenant's queue (admission control);
    ``weights`` maps tenant -> positive share (unknown tenants get 1.0).
    The picker walks tenants in first-seen order from a persistent
    cursor; a tenant with weight w may be picked up to ``ceil(w)`` times
    per full cycle before the cursor moves on, so over any window in
    which every tenant stays backlogged, tenant i's share of picks
    converges to w_i / sum(w) — and with uniform weights the picks per
    cycle differ by at most one across tenants (the bound
    ``tests/test_torch_service.py`` and the CLI's ``--check`` assert).

    Burst grants are integer pick counts, so the ratio contract only
    holds when every weight is >= 1 (a weight of 0.5 would otherwise
    round up to the same one-pick-per-cycle as weight 1).  Fractional
    weight maps are therefore NORMALIZED at construction: when the
    smallest weight is below 1, every weight is divided by it, which
    preserves the ratios exactly — ``{a: 1, b: 0.5}`` grants the same
    2:1 shares as ``{a: 2, b: 1}``.  Tenants absent from the map keep
    weight 1.0, i.e. they share like the smallest-weighted tenant.

    Per-cycle grants are BOUNDED: the integer grant table derived from
    the (normalized) weights clamps every entry to ``[1, MAX_BURST]``,
    so an extreme map like ``{a: 1.0, b: 1e-6}`` grants ``a`` at most
    ``MAX_BURST`` consecutive picks instead of a ~1e6-pick starvation
    burst — ratios are preserved exactly up to ``MAX_BURST:1`` and
    saturate beyond it (``grant_table`` exposes the realized grants).
    """

    def __init__(self, max_depth: int = 64, weights: dict[str, float] | None = None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self.weights = dict(weights or {})
        for t, w in self.weights.items():
            if w <= 0:
                raise ValueError(f"tenant {t!r} weight must be > 0, got {w}")
        if self.weights:
            smallest = min(self.weights.values())
            if smallest < 1.0:
                self.weights = {t: w / smallest for t, w in self.weights.items()}
        self._queues: OrderedDict[str, deque[MiningRequest]] = OrderedDict()
        self._cursor = 0  # index into first-seen tenant order
        self._burst = 0  # picks granted to the cursor tenant this cycle
        self.rejected = 0

    # -- admission -----------------------------------------------------------

    def push(self, req: MiningRequest) -> None:
        """Admit one request, or reject it (``QueueFullError``, the
        request marked ``rejected``) when the tenant's queue is full."""
        q = self._queues.setdefault(req.tenant, deque())
        if len(q) >= self.max_depth:
            req.status = "rejected"
            self.rejected += 1
            raise QueueFullError(
                f"tenant {req.tenant!r} queue is full "
                f"({self.max_depth} pending requests); retry after a drain"
            )
        q.append(req)

    # -- introspection -------------------------------------------------------

    def depth(self, tenant: str) -> int:
        return len(self._queues.get(tenant, ()))

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def tenants(self) -> list[str]:
        return list(self._queues)

    # -- fair picking --------------------------------------------------------

    def _weight(self, tenant: str) -> float:
        return float(self.weights.get(tenant, 1.0))

    def _grant(self, tenant: str) -> int:
        """Integer picks-per-cycle grant: the tenant's (normalized)
        weight rounded to an integer and clamped to ``[1, MAX_BURST]`` —
        the bounded grant table that caps burst starvation under extreme
        fractional weights while preserving moderate ratios exactly."""
        return max(1, min(MAX_BURST, round(self._weight(tenant))))

    def grant_table(self) -> dict[str, int]:
        """The realized per-cycle grants for every weighted tenant
        (unlisted tenants get 1) — what the fairness property tests and
        the service ledger audit."""
        return {t: self._grant(t) for t in self.weights}

    def pick(self) -> MiningRequest | None:
        """Pop the next request under weighted round-robin, or None when
        every queue is empty.  Deterministic: depends only on push/pick
        history and the weights."""
        order = list(self._queues)
        if not order:
            return None
        for _ in range(2 * len(order) + 1):
            self._cursor %= len(order)
            tenant = order[self._cursor]
            q = self._queues[tenant]
            if q and self._burst < self._grant(tenant):
                self._burst += 1
                return q.popleft()
            self._cursor += 1
            self._burst = 0
        return None

    def pick_batch(self, max_requests: int) -> list[MiningRequest]:
        """Up to ``max_requests`` fair picks — one service dispatch wave."""
        out: list[MiningRequest] = []
        for _ in range(max_requests):
            req = self.pick()
            if req is None:
                break
            out.append(req)
        return out


def request_ids() -> itertools.count:
    """Monotonic request-id source (one per service instance)."""
    return itertools.count(1)


def coalesce(batch: list[MiningRequest], keyfn) -> "OrderedDict[Any, list[MiningRequest]]":
    """Group a picked batch by execution key (first-pick order): requests
    sharing ``keyfn(req)`` — same dataset version, app and canonical
    params — are one execution, with the first request as the
    representative and the rest marked ``coalesced_into`` it by the
    service after the run."""
    groups: OrderedDict[Any, list[MiningRequest]] = OrderedDict()
    for req in batch:
        groups.setdefault(keyfn(req), []).append(req)
    return groups
