"""Per-op traffic/collective breakdown of a dry-run cell: the port of
``repro.roofline.breakdown``.  The reference ranks the instructions of a
compiled step's HLO; the port ranks the aten ops its eager step
dispatches, as ``roofline.op_costs`` records them on fake tensors.  Ops
of the same kind, result type, issuing line and autograd node are one
row (the counterpart of an HLO instruction and its multiplier); the row's
name is the innermost frame under ``repro_torch/`` that issued it (HLO
``op_name`` metadata), and its last column the autograd node that ran it
in the backward ("forward" otherwise).

    PYTHONPATH=src python -m repro_torch.roofline.breakdown --arch xlstm-1.3b --shape train_4k --device cpu
"""

from __future__ import annotations


def _rows(costs, value):
    agg: dict = {}
    for r in getattr(costs, "ops", costs):
        v = value(r)
        if not v:
            continue
        key = (r.op, r.type_str, r.where, r.node)
        t, m = agg.get(key, (0.0, 0))
        agg[key] = (t + v, m + 1)
    return agg


def top_traffic(costs, k: int = 30):
    """The ``k`` rows of most traffic: ``(bytes, count, op, result type,
    where, autograd node)``, from an ``OpCosts`` counted with
    ``record_ops`` (or its list of ``OpRecord``s)."""
    items = [(t, m, op, ts[:44], where[-72:], (node or "forward")[:28])
             for (op, ts, where, node), (t, m) in _rows(costs, lambda r: r.traffic_bytes).items()]
    items.sort(reverse=True)
    return items[:k]


def top_collectives(costs, k: int = 20):
    """The ``k`` collective rows of most bytes: ``(bytes, count, op,
    result type, where)``."""
    items = [(t, m, op, ts[:44], where[-72:])
             for (op, ts, where, node), (t, m) in _rows(costs, lambda r: r.coll_bytes).items()]
    items.sort(reverse=True)
    return items[:k]


def main(argv=None):
    import argparse

    import repro_torch.configs as configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.dryrun import _run_cell_once, cell_shape

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--gridlocal", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--global-batch", type=int, default=0, help="cut the shape's global batch (0: as published)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the fake tensors live (default: the card)")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    sh = cell_shape(args.shape, args.global_batch)
    rec = _run_cell_once(args.arch, sh, args.gridlocal, args.grad_accum, args.device, record_ops=True)
    costs = rec["_costs"]
    print(f"== top traffic ops ({args.arch} x {sh.name}, batch {sh.global_batch}, grad_accum {args.grad_accum}; "
          f"{costs.traffic_bytes:.3e} bytes, {costs.flops:.3e} flops, {costs.n_ops} ops) ==")
    for t, m, op, ts, name, node in top_traffic(costs, args.top):
        print(f"{t:10.3e}  x{m:6d} {op:28s} {ts:44s} {name}  [{node}]")
    print("\n== top collectives ==")
    for t, m, op, ts, name in top_collectives(costs, args.top):
        print(f"{t:10.3e}  x{m:6d} {op:28s} {ts:44s} {name}")


if __name__ == "__main__":
    main()
