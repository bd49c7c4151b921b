"""Multi-process bring-up, the per-site mesh, site ownership and the
result-shipping wire, on ``torch.distributed`` with gloo.

  * :func:`tuned_platform` — pin the platform a process computes on, the
    process-entry companion of the kernel autotuner;
  * :func:`init_multihost` — join (or start) the gloo process group;
    idempotent, and a single process with no coordinator stays alone.
  * :class:`SiteMesh`, :func:`make_site_mesh` / :func:`make_multihost_mesh`
    — the 1-D grid-site mesh, one process a paper "site", that the
    runtime's ``shard_map`` synchronization and ``vcluster_shard_map`` run
    on; None when the group has fewer processes than sites, and callers
    fall back to the bit-identical pooled merge.
  * :func:`allgather_stats` — the mesh's one collective: every site's
    (N, centre, SSE) triples gathered to every site, the paper's "only
    bookkeeping needed from the other sites"; :func:`allgather_shards`
    gathers equal-shaped per-site tensors (the point labels).
  * :func:`site_ownership` — the deterministic ``site -> process`` map
    (capacity-proportional greedy) that gives every grid site exactly
    one executing process under ``runtime.backends.MultiHostBackend``.
  * :func:`allgather_bytes` / :func:`allgather_payload` — the shipment
    wire: variable-length bytes (then packed results) gathered across
    processes; the ONLY cross-process traffic the multihost backend
    performs, wave-fused so collectives scale with ready waves.

Gloo moves host tensors, so every gather stages through host memory,
whatever device the ranks compute on: several ranks may share one card,
where NCCL would want one rank per card.  Importing this module touches
no process group.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.stats import SuffStats
from repro_torch.device import resolve_device
from repro_torch.sharding import MeshShape

# a stranded peer fails its collectives after this long instead of hanging
DEFAULT_TIMEOUT_S = 60.0


def tuned_platform(platform: str | None = None) -> str:
    """Pin the platform this process computes on and return its name:
    ``"cpu"``, or ``"cuda"`` (the card, an error without one); ``None``
    means the card, as ``device.resolve_device`` does.  Anything else
    raises.

    The reference's version (``repro/launch/mesh.py:50``) also sets XLA's
    GPU flags (Triton fusions, async collectives, the latency-hiding
    scheduler): they tune what XLA compiles around the Pallas kernels, and
    PyTorch runs eagerly with no such compiler, so none of them has a
    meaning here; the kernels' own launches are tuned by
    ``kernels.autotune``.  It sets nothing that changes a result: float32
    matrix products and cuDNN convolutions stay in full float32
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` False), the parity path's
    contract."""
    if platform not in (None, "cpu", "cuda"):
        raise ValueError(f"unknown platform {platform!r} (want 'cpu' or 'cuda')")
    if platform != "cpu":
        platform = resolve_device(None).type  # the card, or an error
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return platform


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


@dataclass(frozen=True)
class SiteMesh:
    """A 1-D grid-site mesh: site i is the process of global rank
    ``ranks[i]``.  ``shape`` is ``{axis: n_sites}``, read as a JAX mesh's
    is; ``group`` is the ``torch.distributed`` group the gathers run on
    (None for a one-site mesh, whose gather is the identity); ``device``
    is where this process computes and where gathered tensors land."""

    axis: str
    shape: dict
    ranks: tuple
    group: Any
    device: torch.device

    def coordinate(self) -> int:
        """This process's site index on the mesh."""
        return 0 if self.group is None else self.ranks.index(dist.get_rank())


def make_site_mesh(n_sites: int, axis: str = "sites", device=None) -> SiteMesh | None:
    """The grid-site mesh of ``n_sites`` processes, one a site, over the
    process group; None when there is no group (and ``n_sites > 1``) or
    the group has fewer processes than sites — callers fall back to the
    pooled merge.  ``n_sites == 1`` is a one-process mesh with no group.
    ``device`` is where this process computes: None means the card (an
    error without one).

    A group with more processes than sites is refused: a mesh over part
    of it needs ``dist.new_group``, which every process must enter, and a
    process outside the mesh would have no site to run.  Start one
    process a site, or use the pooled merge."""
    dev = resolve_device(device)
    if n_sites < 1:
        return None
    if n_sites == 1:
        return SiteMesh(axis, {axis: 1}, (process_index(),), None, dev)
    n = process_count()
    if n < n_sites:
        return None
    if n > n_sites:
        raise ValueError(
            f"a site mesh is one process a site: the process group has {n} processes for {n_sites} "
            "sites; start one process a site, or use sync='pooled'"
        )
    return SiteMesh(axis, {axis: n_sites}, tuple(range(n)), dist.group.WORLD, dev)


def make_multihost_mesh(n_sites: int | None = None, axis: str = "sites", device=None) -> SiteMesh | None:
    """The grid-site mesh over every process of the group
    (``init_multihost`` first); ``n_sites`` given, a mesh of that many
    sites, under :func:`make_site_mesh`'s contract (None when the group is
    smaller, refused when it is larger)."""
    return make_site_mesh(process_count() if n_sites is None else n_sites, axis, device)


def allgather_shards(t: torch.Tensor, mesh: SiteMesh) -> torch.Tensor:
    """Every site's ``t`` (equal shapes and dtypes), stacked in site order
    on ``mesh.device``: (n_sites, *t.shape).  One ``all_gather`` over
    host copies; the identity on a one-site mesh."""
    if mesh.group is None:
        return t[None].to(mesh.device)
    host = t.detach().contiguous().cpu()
    parts = [torch.empty_like(host) for _ in mesh.ranks]
    dist.all_gather(parts, host, group=mesh.group)
    return torch.stack(parts).to(mesh.device)


def allgather_stats(stats: SuffStats, mesh: SiteMesh) -> SuffStats:
    """The mesh's one synchronization: this site's sufficient statistics
    (sizes (k,), centers (k, D), sse (k,), float32) in, every site's
    stacked (n_sites, k, ...) on ``mesh.device`` out — bit for bit what
    each site contributed, since the floats only move."""
    k, d = stats.centers.shape
    if any(t.dtype != torch.float32 for t in stats):
        raise ValueError(f"allgather_stats ships float32 statistics, got {[t.dtype for t in stats]}")
    flat = torch.cat([stats.sizes.reshape(k), stats.centers.reshape(k * d), stats.sse.reshape(k)])
    g = allgather_shards(flat, mesh)
    return SuffStats(
        sizes=g[:, :k].contiguous(),
        centers=g[:, k : k + k * d].reshape(-1, k, d).contiguous(),
        sse=g[:, k + k * d :].contiguous(),
    )


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


# ---------------------------------------------------------------------------
# The production meshes, described without devices (the dry run's)
# ---------------------------------------------------------------------------


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips), as a
    ``sharding.MeshShape``: no devices, only the axes and their sizes.

    Axes: `pod` is the DCN-crossing grid-site axis (the paper's "site"),
    `data` is intra-pod DP/FSDP, `model` is TP/EP."""

    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_variant_mesh(name: str, *, multi_pod: bool = False):
    """Hillclimbing mesh variants (same chip counts as production).

    'moe2d': (data, expert, model) = (16, 8, 2) — factorises the 256-chip
    pod so coarse-expert MoEs (mixtral: 8 experts) get true expert
    parallelism instead of TP-within-expert."""

    if name == "moe2d":
        if multi_pod:
            return MeshShape(("pod", "data", "expert", "model"), (2, 16, 8, 2))
        return MeshShape(("data", "expert", "model"), (16, 8, 2))
    raise KeyError(name)


def make_device_mesh(mesh_shape, device_type: str = "cuda"):
    """A ``DeviceMesh`` over the default process group with the axes and
    sizes of ``mesh_shape`` (a ``sharding.MeshShape``), in mesh order, on
    ``device_type``: gloo on the CPU, NCCL on the cards, or the fake
    backend that the dry run counts a production mesh on
    (``init_fake_group``).  The group's size must be the mesh's; one
    process has one default group, so each kind of group takes a process
    of its own."""
    import math

    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh: no process group; init one first (init_multihost, "
                           "init_fake_group, or torch.distributed.init_process_group)")
    n = math.prod(mesh_shape.axis_sizes)
    if dist.get_world_size() != n:
        raise ValueError(f"a {mesh_shape.tag} mesh needs {n} ranks, the group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(mesh_shape.axis_sizes), mesh_dim_names=tuple(mesh_shape.axis_names))


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """The fake backend's default group of ``world_size`` ranks in this one
    process (``torch.testing._internal.distributed.fake_pg``): its
    collectives move nothing and return at once, so a step sharded over
    256 or 512 ranks runs, on fake tensors, as rank ``rank`` would, and
    ``roofline.op_costs`` counts what that rank does."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)


def make_test_mesh(n_data: int = 2, n_model: int = 2, n_pods: int = 0):
    """A small mesh for the tests, as a ``sharding.MeshShape``."""

    if n_pods:
        return MeshShape(("pod", "data", "model"), (n_pods, n_data, n_model))
    return MeshShape(("data", "model"), (n_data, n_model))


# The card's hardware model for the roofline analysis (per card), with the
# reference's keys.  These are NVIDIA's data sheet for the H100 SXM part at
# its 700 W power limit, not a measurement; a card's own limit is read with
# `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, and a
# card set below 700 W runs slower under load.
HW = {
    "peak_flops_bf16": 989e12,  # FLOP/s, dense bf16 on the tensor cores
    "hbm_bw": 3.35e12,  # B/s, HBM3
    "ici_bw": 450e9,  # B/s, NVLink 4, one direction
    "chips_per_pod": 8,  # one HGX node's NVLink domain
    "dcn_bw": 50e9,  # B/s, one 400 Gb/s NIC; used for pod-crossing notes
}
