"""Multi-process bring-up, site ownership and the result-shipping wire
for the multi-host backend, on ``torch.distributed`` with gloo.

  * :func:`init_multihost` — join (or start) the gloo process group;
    idempotent, and a single process with no coordinator stays alone.
  * :func:`site_ownership` — the deterministic ``site -> process`` map
    (capacity-proportional greedy) that gives every grid site exactly
    one executing process under ``runtime.backends.MultiHostBackend``.
  * :func:`allgather_bytes` / :func:`allgather_payload` — the shipment
    wire: variable-length bytes (then packed results) gathered across
    processes; the ONLY cross-process traffic the multihost backend
    performs, wave-fused so collectives scale with ready waves.

Gloo moves host tensors, so every shipment stages through host memory,
whatever device the ranks compute on: several ranks may share one card,
where NCCL would want one rank per card.  Importing this module touches
no process group.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# a stranded peer fails its collectives after this long instead of hanging
DEFAULT_TIMEOUT_S = 60.0


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the gloo process group; returns True when this process is one
    of several afterwards.

    Idempotent: an initialized group is kept as it is, and a call with no
    coordinator and no process count reports a single process without
    touching any state.  ``coordinator_address`` is ``host:port`` (or a
    ``tcp://`` URL) of rank 0's rendezvous.  Every collective of the
    group fails after ``timeout`` seconds rather than waiting forever on a
    peer that died.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_multihost needs coordinator_address, num_processes and process_id together, got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}"
        )
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo",
        init_method=url,
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=timedelta(seconds=timeout),
    )
    return dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def site_ownership(
    sites,
    n_processes: int | None = None,
    capacity: dict[int, int] | None = None,
    site_weights: dict[int, float] | None = None,
) -> dict[int, int]:
    """Explicit ``site -> process`` ownership map for true multi-host
    execution: every grid site's jobs execute on exactly one process and
    only their RESULTS ship over the collective.

    Assignment is least-relative-load greedy over sorted site ids
    (deterministic; ties break to the lowest process id):

      * ``capacity`` given (``{process: local devices}``) — a process
        holding more devices owns proportionally more sites;
      * otherwise — ``n_processes`` unit-capacity processes (default: the
        process group's size).

    ``site_weights`` (site -> load units, e.g. per-site worker slots)
    skews the balance toward lighter owners for heavy sites; UNIFORM
    weights — such as the scalar ``GridModel.workers_per_site`` — cancel
    out and reduce to round-robin, so only genuinely per-site
    heterogeneity changes the map.

    Deterministic on every process by construction — all inputs are
    global state, so every process derives the identical map.
    """
    site_ids = sorted(set(int(s) for s in sites))
    if capacity is not None:
        capacity = {int(p): int(c) for p, c in capacity.items()}
    else:
        n_proc = int(n_processes if n_processes is not None else process_count())
        if n_proc < 1:
            raise ValueError(f"n_processes must be >= 1, got {n_proc}")
        capacity = dict.fromkeys(range(n_proc), 1)
    load = dict.fromkeys(capacity, 0.0)
    owner: dict[int, int] = {}
    for s in site_ids:
        w = float(site_weights.get(s, 1.0)) if site_weights else 1.0
        pid = min(capacity, key=lambda p: (load[p] / capacity[p], p))
        owner[s] = pid
        load[pid] += max(w, 1e-9)
    return owner


def allgather_bytes(data: bytes) -> list[bytes]:
    """Gather one variable-length bytes payload per process (identity on a
    single process) — the wire that ships owned-site results.

    Two ``all_gather`` rounds over host tensors: the int64 payload
    lengths first, then the max-length-padded uint8 buffers; each
    process's slice is returned in rank order.  This is the ONLY
    cross-process communication the multihost backend performs.
    """
    n = process_count()
    if n <= 1:
        return [data]
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([len(data)], dtype=torch.int64))
    sizes = [int(t.item()) for t in lens]
    cap = max(max(sizes), 1)
    buf = torch.zeros(cap, dtype=torch.uint8)
    if data:
        buf[: len(data)] = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())
    bufs = [torch.empty(cap, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(bufs, buf)
    return [bufs[p][: sizes[p]].numpy().tobytes() for p in range(n)]


def allgather_payload(obj) -> list:
    """One-object-per-process shipment over :func:`allgather_bytes`: pack
    an arbitrary result (``compat.pack_payload`` — tensors staged through
    the host, everything else pickled), gather every process's bytes in
    ONE ``allgather_bytes`` round, and unpack each slice.  This is the
    batched-shipment wire: the multihost backend ships a whole ready
    wave's result dict through one call instead of one ``allgather_bytes``
    per job, so the collective count scales with waves, not jobs."""
    from repro_torch.compat import pack_payload, unpack_payload

    return [unpack_payload(b) for b in allgather_bytes(pack_payload(obj))]
