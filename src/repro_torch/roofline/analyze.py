"""Roofline terms of a counted step: the port of ``repro.roofline.analyze``.

compute   = FLOPs            / (chips * peak_FLOP/s)
memory    = bytes            / (chips * HBM_bw)
collective= collective_bytes / (chips * link_bw)

FLOPs, bytes and collective bytes come from ``roofline.op_costs`` (the
ops an eager step dispatches), not from HLO text; the peaks from
``launch.mesh.HW``, the H100's data sheet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclass
class CollectiveStats:
    bytes_by_type: dict = field(default_factory=dict)
    count_by_type: dict = field(default_factory=dict)
    total_bytes: int = 0

    def as_dict(self):
        return {
            "bytes_by_type": self.bytes_by_type,
            "count_by_type": self.count_by_type,
            "total_bytes": self.total_bytes,
        }


def collective_stats(costs) -> CollectiveStats:
    """Sum the bytes of every collective op instance among the records of
    an ``OpCosts`` counted with ``record_ops`` (or a list of its
    ``OpRecord``s)."""
    st = CollectiveStats()
    for r in getattr(costs, "ops", costs):
        if not r.coll_type:
            continue
        st.bytes_by_type[r.coll_type] = st.bytes_by_type.get(r.coll_type, 0) + r.coll_bytes
        st.count_by_type[r.coll_type] = st.count_by_type.get(r.coll_type, 0) + 1
        st.total_bytes += r.coll_bytes
    return st


def roofline_terms(
    flops: float,
    hlo_bytes: float,
    coll_bytes: float,
    chips: int,
    hw: dict,
    per_device: bool = True,
) -> dict:
    """All three terms in SECONDS.  ``per_device=True`` means flops/bytes
    already describe one device's work (the one-card dry run's do);
    otherwise divide by chip count."""
    div = 1 if per_device else chips
    t_compute = (flops / div) / hw["peak_flops_bf16"]
    t_memory = (hlo_bytes / div) / hw["hbm_bw"]
    t_coll = (coll_bytes / div) / hw["ici_bw"]
    dom = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll), key=lambda kv: kv[1]
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dom,
        "bound_s": max(t_compute, t_memory, t_coll),
        # fraction of the roofline bound that is useful compute
        "roofline_fraction": t_compute / max(t_compute, t_memory, t_coll, 1e-30),
    }
