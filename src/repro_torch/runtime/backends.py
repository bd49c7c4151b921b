"""Multi-host execution backend — true per-process site ownership over a
``torch.distributed`` process group (gloo).

:class:`MultiHostBackend` joins the process group
(``launch.mesh.init_multihost``), learns every process's local device
count (one gather at bring-up), derives an explicit ``site -> process``
ownership map from it (``launch.mesh.site_ownership``:
capacity-proportional over the processes; per-site load weights are the
seam for heterogeneous slots — the scalar ``GridModel.workers_per_site``
is uniform and therefore balance-neutral), and then:

  * each process executes ONLY the jobs of its owned sites — a 3-process
    run really does run each site's mining on exactly one process
    (``executed_log`` is the audit trail the conformance harness checks);
  * execution is WAVE-FUSED by default (``fuse_waves=True``): at the
    first ``call`` of each ready wave the backend takes the whole wave
    (``executor.ready_wave``), groups it by ``batch_key``
    (``executor.group_wave``), runs ONE fused launch per group over its
    owned members (the ``sitejob.timed_batch`` contract — the fused call
    is measured once and each member's share is its owner-measured
    time), and ships ALL of the wave's results in ONE ``allgather_bytes``
    round — so the collective count scales with ready WAVES, not jobs.
    ``fuse_waves=False`` ships once per executed job instead;
  * every shipment moves owner-measured ``TimedResult`` payloads
    (``compat.pack_payload`` stages every tensor through the host and
    pickles everything else, itemset dicts included), and the per-run
    counts are ledgered (``shipments`` / ``collective_rounds`` /
    ``shipped_results``, surfaced on ``RunReport``);
  * every process keeps scheduling the WHOLE DAG — placement, the
    simulated clock and the ledger are globally consistent because every
    process sees the same owner-measured times, so both engine schedulers
    replay the identical event order everywhere and the wave shipments
    are the only collectives.

Single-process fallback: without a coordinator the backend degrades to
inline execution — same results, no distributed state touched — so
``Engine(backend="multihost")`` is safe everywhere.

Determinism contract (why the shipments line up): both schedulers order
events only by (dag, model, placement seed, fault seed, measured times),
and the measured times are owner-authoritative everywhere, so every
process invokes ``call`` for the same jobs in the same order.  Keep
per-process state OUT of the scheduling inputs — e.g. a ``rescue_path``
resuming on one process only would desynchronize the collectives.

The serving layer (``launch.serve.MiningService``) treats this backend
as a drop-in execution strategy: a service built with
``backend="multihost"`` dispatches every execution through the same
ownership and shipping machinery, one run at a time.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import pack_payload, unpack_payload
from repro_torch.launch import mesh
from repro_torch.workflow.dag import DAG, Job, TimedResult
from repro_torch.workflow.executor import (
    ExecutionBackend,
    Partition,
    group_wave,
    ready_wave,
)


class _ShippedError:
    """Wire marker for an exception raised by an owned job's callable:
    the owner ships it instead of the result so every process raises the
    same failure AFTER the collective (raising before it would strand
    the peers inside ``all_gather`` until the group's timeout)."""

    def __init__(self, message: str):
        self.message = message


def _compute_device() -> torch.device:
    """What this process computes on: the card when there is one."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class MultiHostBackend(ExecutionBackend):
    """Site-partitioned DAG execution over a gloo process group.

    ``coordinator_address`` (``host:port`` of rank 0), ``num_processes``
    and ``process_id`` mirror ``torch.distributed.init_process_group``;
    all-None (the default) means "join an already-initialized group, or
    run single-process" — the backend never guesses a coordinator.
    Each process's capacity in the ownership map is its count of local
    cards (1 on a host without one).

    ``mesh`` is the grid-site mesh over every process
    (``launch.mesh.make_multihost_mesh``), built at bring-up.

    ``partition_sites=False`` restores the SPMD-redundant mode (every
    process executes every job; no shipping; the clustering merge's
    gather is a collective over the site mesh when ``GridRuntime`` has
    one); ``fuse_waves=False`` ships
    once per executed job — both kept for A/B measurements against the
    wave-fused default.  ``force_partition=True`` derives the ownership
    map even on a single process (everything owned locally, the
    collectives degenerate to identity) — the seam that lets unit tests
    exercise the partitioned shipping paths and their ledger without a
    process group.
    """

    name = "multihost"

    def __init__(
        self,
        coordinator_address: str | None = None,
        num_processes: int | None = None,
        process_id: int | None = None,
        partition_sites: bool = True,
        fuse_waves: bool = True,
        force_partition: bool = False,
        timeout: float = mesh.DEFAULT_TIMEOUT_S,
    ):
        self.coordinator_address = coordinator_address
        self.num_processes = num_processes
        self.process_id = process_id
        self.partition_sites = partition_sites
        self.fuse_waves = fuse_waves
        self.force_partition = force_partition
        self.timeout = timeout
        self._ready = False
        self.is_multiprocess = False
        self.mesh: mesh.SiteMesh | None = None
        # {process: local devices}, gathered once at bring-up
        self.capacity: dict[int, int] = {}
        self._partition: Partition | None = None
        self._dag: DAG | None = None
        self._results: dict | None = None
        # wave-fused shipping: results of the current ready wave, merged
        # from every process's shipment, consumed one ``call`` at a time
        self._wave_cache: dict[str, Any] = {}
        # audit trails for the conformance harness: which jobs' callables
        # ran in THIS process, and which arrived as shipped results
        self.executed_log: list[str] = []
        self.shipped_log: list[str] = []
        # per-run collective/shipment ledger (ExecutionBackend.ledger):
        # wave-fused shipping makes shipments O(waves); per-job O(jobs)
        self.shipments = 0
        self.collective_rounds = 0
        self.shipped_results = 0
        self.waves = 0
        if coordinator_address is not None or num_processes is not None:
            # explicit coordinator args = the caller WANTS a process
            # group: join it at construction, so a failed rendezvous
            # fails here rather than inside the first run
            self._ensure()

    def ensure_initialized(self) -> None:
        """Public bring-up (idempotent): the process group, the capacity
        map and the site mesh.  ``GridRuntime`` calls it before the engine
        partitions a run."""
        self._ensure()

    def _ensure(self) -> None:
        if self._ready:
            return
        self.is_multiprocess = mesh.init_multihost(
            coordinator_address=self.coordinator_address,
            num_processes=self.num_processes,
            process_id=self.process_id,
            timeout=self.timeout,
        )
        own = torch.cuda.device_count() if _compute_device().type == "cuda" else 1
        counts = mesh.allgather_payload(own) if self.is_multiprocess else [own]
        self.capacity = {p: int(c) for p, c in enumerate(counts)}
        self.mesh = mesh.make_multihost_mesh(device=_compute_device())
        self._ready = True

    def describe(self) -> dict:
        """Topology introspection: the process layout, each process's
        local devices, the site mesh over the processes and the device
        this process computes on."""
        self._ensure()
        dev = _compute_device()
        return {
            "is_multiprocess": self.is_multiprocess,
            "process_index": mesh.process_index(),
            "process_count": mesh.process_count(),
            "n_local_devices": self.capacity[mesh.process_index()],
            "capacity": {str(p): c for p, c in self.capacity.items()},
            "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "wire": dist.get_backend() if dist.is_initialized() else None,
            "mesh_shape": dict(self.mesh.shape) if self.mesh is not None else None,
        }

    def allgather_check(self, value: float) -> np.ndarray:
        """Cross-process collective smoke: gather one scalar per process
        (identity on a single process) — the same wire ``call`` ships
        per-site results over.  Returns (processes, 1) float32."""
        self._ensure()
        arr = torch.tensor([value], dtype=torch.float32)
        if not self.is_multiprocess:
            return arr[None].numpy()
        out = [torch.zeros(1, dtype=torch.float32) for _ in range(mesh.process_count())]
        dist.all_gather(out, arr)
        return torch.stack(out).numpy()

    # -- ownership ----------------------------------------------------------

    def begin_run(self, dag: DAG, results: dict) -> None:
        self._ensure()
        self._partition = None
        self._dag = dag
        self._results = results
        self._wave_cache.clear()
        self.executed_log.clear()
        self.shipped_log.clear()
        self.shipments = 0
        self.collective_rounds = 0
        self.shipped_results = 0
        self.waves = 0

    def ledger(self) -> dict:
        """The per-run collective/shipment counts (copied onto
        ``RunReport`` by the engine): ``shipments`` = result-shipment
        collectives performed, ``collective_rounds`` = underlying
        ``all_gather`` rounds (two per shipment: lengths, then padded
        payloads), ``shipped_results`` = job results that arrived from
        OTHER processes.  All zero on an unpartitioned run."""
        return {
            "shipments": self.shipments,
            "collective_rounds": self.collective_rounds,
            "shipped_results": self.shipped_results,
        }

    def partition(self, dag: DAG, model=None) -> Partition | None:
        """Derive the ``site -> process`` ownership map for this DAG from
        the capacity map (every process computes the identical map) and
        project it onto job names.  A single process — and
        ``partition_sites=False`` — returns None: everything runs locally.
        """
        self._ensure()
        if not (self.is_multiprocess or self.force_partition) or not self.partition_sites:
            return None
        sites = sorted({j.site for j in dag.jobs.values()})
        # capacity-proportional over the processes; the grid model's
        # workers_per_site is a UNIFORM per-site weight, which cancels out
        # of the balance — per-site heterogeneous weights are
        # site_ownership's seam when the model grows them
        owner_by_site = mesh.site_ownership(sites, capacity=self.capacity)
        me = mesh.process_index()
        owner_of = {j.name: owner_by_site[j.site] for j in dag.jobs.values()}
        self._partition = Partition(
            owned=frozenset(n for n, p in owner_of.items() if p == me),
            owner_of=owner_of,
            n_processes=mesh.process_count(),
            process_index=me,
            owned_sites=tuple(s for s, p in sorted(owner_by_site.items()) if p == me),
        )
        return self._partition

    # -- execution ----------------------------------------------------------

    def call(self, job: Job, args: list) -> Any:
        part = self._partition
        if part is None:
            # single process (or partitioning disabled): plain inline
            # execution — same results, no distributed state touched
            self.executed_log.append(job.name)
            return job.fn(*args)
        if self.fuse_waves and self._dag is not None:
            return self._call_wave(job, part)
        # per-job wire: also the path for direct call() usage outside a
        # begin_run bracket, where no DAG is available to wave over
        return self._call_per_job(job, args, part)

    def _call_per_job(self, job: Job, args: list, part: Partition) -> Any:
        if job.name in part.owned:
            # owner: execute for real, normalize to an owner-measured
            # TimedResult (untimed callables get the host bracket HERE, on
            # the one process that ran them), and ship it.  A raised
            # exception ships too — the peers are already committed to
            # joining this job's collective, so propagating it before the
            # shipment would leave them waiting in all_gather; instead
            # everyone receives it and fails the run together.
            t0 = time.perf_counter()
            try:
                raw = job.fn(*args)
                if not isinstance(raw, TimedResult):
                    raw = TimedResult(raw, time.perf_counter() - t0)
                payload = pack_payload(raw)
                # logged only once the result is actually shippable, so
                # the audit trail never claims an execution whose peers
                # received a serialization failure instead
                self.executed_log.append(job.name)
            except Exception as e:  # noqa: BLE001 - shipped, not swallowed
                payload = pack_payload(_ShippedError(f"{type(e).__name__}: {e}"))
        else:
            payload = b""
        # one shipment per executed job (allgather_bytes = two all_gather
        # rounds: lengths, then padded payloads); every process joins —
        # the schedulers' deterministic event order guarantees they arrive
        # in lockstep — and the owner's slot carries the result
        shipped = mesh.allgather_bytes(payload)
        self.shipments += 1
        self.collective_rounds += 2
        out = unpack_payload(shipped[part.owner_of[job.name]])
        if job.name not in part.owned and not isinstance(out, _ShippedError):
            self.shipped_results += 1
        return self._adopt(job.name, out, part)

    # -- wave-fused execution ------------------------------------------------

    def _call_wave(self, job: Job, part: Partition) -> Any:
        """Wave-fused shipping: a cache miss means ``job`` opens a new
        ready wave — execute this process's owned slice of the whole wave
        (one fused launch per batch group) and ship every result in ONE
        collective; hits consume the merged wave cache."""
        if job.name not in self._wave_cache:
            self._ship_wave(part)
        out = self._wave_cache.pop(job.name)
        return self._adopt(job.name, out, part)

    def _ship_wave(self, part: Partition) -> None:
        if self._dag is None or self._results is None:  # pragma: no cover - call() guards it
            raise RuntimeError("wave shipment outside a run")
        wave = ready_wave(self._dag, self._results, skip=self._wave_cache)
        local: dict[str, Any] = {}
        ran: list[str] = []  # logged executed only once actually shipped
        for group in group_wave(wave):
            owned = [j for j in group if j.name in part.owned]
            if not owned:
                continue
            if len(owned) >= 2 and owned[0].batched_fn is not None:
                self._run_owned_fused(owned, local, ran)
            else:
                # singleton slice (or unbatchable job): the plain owner
                # bracket — no fused-call overhead for one job
                for j in owned:
                    local[j.name] = self._run_owned_one(j, ran)
        try:
            blob = pack_payload(local)
            blob_ok = True
        except Exception as e:  # noqa: BLE001 - shipped, not swallowed
            # a result that cannot serialize must not strand the peers:
            # join the collective shipping errors for this process's
            # whole slice instead
            blob_ok = False
            blob = pack_payload(dict.fromkeys(local, _ShippedError(f"{type(e).__name__}: {e}")))
        shipped = [unpack_payload(b) for b in mesh.allgather_bytes(blob)]
        if blob_ok:
            self.executed_log.extend(ran)
        self.shipments += 1
        self.collective_rounds += 2
        self.waves += 1
        # merge: the per-process slices are disjoint (each job has one
        # owner) and their union covers the wave — every process adopts
        # the identical round-tripped cache
        for pid, slice_ in enumerate(shipped):
            if pid != part.process_index:
                self.shipped_results += sum(
                    1 for v in slice_.values() if not isinstance(v, _ShippedError)
                )
            self._wave_cache.update(slice_)
        missing = [j.name for j in wave if j.name not in self._wave_cache]
        if missing:  # pragma: no cover - ownership covers every job
            raise RuntimeError(f"wave shipment incomplete: no owner shipped {missing!r}")

    def _run_owned_fused(self, owned: list[Job], local: dict, ran: list[str]) -> None:
        """ONE fused launch over this process's owned slice of a batch
        group.  Only owned member names are passed to ``batched_fn``, so
        a ``timed_batch``-built group records measured shares for owned
        jobs ONLY — the owner-only timing invariant holds by
        construction.  An untimed fused fn gets the host bracket
        apportioned equally, mirroring ``timed_batch``."""
        names = [j.name for j in owned]
        t0 = time.perf_counter()
        try:
            argss = [[self._results[d] for d in j.deps] for j in owned]
            outs = owned[0].batched_fn(names, [j.batch_arg for j in owned], argss)
            if len(outs) != len(owned):
                raise RuntimeError(
                    f"batched_fn for {owned[0].batch_key!r} returned "
                    f"{len(outs)} results for {len(owned)} jobs"
                )
            share = (time.perf_counter() - t0) / max(len(owned), 1)
            for j, out in zip(owned, outs):
                local[j.name] = out if isinstance(out, TimedResult) else TimedResult(out, share)
            ran.extend(names)
        except Exception as e:  # noqa: BLE001 - shipped, not swallowed
            err = _ShippedError(f"{type(e).__name__}: {e}")
            for j in owned:
                local[j.name] = err

    def _run_owned_one(self, job: Job, ran: list[str]):
        """Execute one owned job for a wave shipment: owner-measured
        TimedResult (untimed callables get the host bracket HERE, on the
        one process that ran them) or a shipped error."""
        t0 = time.perf_counter()
        try:
            raw = job.fn(*[self._results[d] for d in job.deps])
            if not isinstance(raw, TimedResult):
                raw = TimedResult(raw, time.perf_counter() - t0)
            ran.append(job.name)
            return raw
        except Exception as e:  # noqa: BLE001 - shipped, not swallowed
            return _ShippedError(f"{type(e).__name__}: {e}")

    def _adopt(self, name: str, out: Any, part: Partition) -> TimedResult:
        """Normalize a shipped entry on every process: raise a shipped
        owner-side failure everywhere together, guard the wire contract,
        and adopt the round-tripped value (owner included) so the results
        dict is bit-identical on every process."""
        if isinstance(out, _ShippedError):
            raise RuntimeError(
                f"job {name!r} failed on its owning process "
                f"{part.owner_of[name]}: {out.message}"
            )
        if not isinstance(out, TimedResult):  # pragma: no cover - wire guard
            raise RuntimeError(
                f"shipped result for job {name!r} from process "
                f"{part.owner_of[name]} is not an owner-measured TimedResult"
            )
        if name not in part.owned:
            self.shipped_log.append(name)
        return out
