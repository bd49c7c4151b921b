"""Print the one-card dry run's records (``experiments/dryrun_torch/``,
written by ``python -m repro_torch.launch.dryrun --all``) as a markdown
table, a row an arch and a column a shape: the counted FLOPs, the peak
estimate in GB at the grad_accum the step was counted at (``*``: it does
not fit the card), and the dominant roofline term with its bound in
seconds.  Records of cut batches or GridLocal follow, a row each.  Then
the mesh records (``--mesh 16x16`` / ``2x16x16``), a row each, with one
device's share: FLOPs and bytes per device, collective bytes by type
(cross-pod among them), the peak per device at its grad_accum, and the
roofline's dominant term.  The numbers are counts on fake tensors against
NVIDIA's data sheet (``launch.mesh.HW``), not times.

    PYTHONPATH=src python tools/dryrun_table.py [--dir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell(r: dict) -> str:
    if r["status"] == "SKIP":
        return "SKIP (full attention)"
    ro = r["roofline"]
    peak = r["memory"]["peak_est_bytes"] / 1e9
    return (f"{r['flops']:.3g}; {peak:,.1f}{'' if r['fits'] else '*'} GB (ga {r['grad_accum']}); "
            f"{ro['dominant']} {ro['bound_s']:.3g} s")


def mesh_row(name: str, r: dict) -> str:
    if r["status"] == "SKIP":
        return f"| {name} | SKIP | | | | |"
    c, ro = r["collectives"], r["roofline"]
    by_type = ", ".join(f"{k} {v:.3g}" for k, v in sorted(c["bytes_by_type"].items()))
    peak = r["memory"]["peak_est_bytes"] / 1e9
    return (f"| {name} | {r['hlo_flops_per_device']:.4g} | {r['hlo_bytes_per_device']:.4g} | {by_type} "
            f"(cross-pod {c['cross_pod_bytes']:.3g}) | {peak:,.2f}{'' if r['fits'] else '*'} GB (ga {r['grad_accum']}) "
            f"| {ro['dominant']} {ro['bound_s']:.3g} s |")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=str(ROOT / "experiments" / "dryrun_torch"))
    args = ap.parse_args()
    recs, extra, meshes = {}, [], []
    for path in sorted(Path(args.dir).glob("*.json")):
        arch, *rest = path.stem.split("__")
        r = json.loads(path.read_text())
        if "hlo_flops_per_device" in r or r.get("mesh", "1") != "1":
            meshes.append((path.stem.replace("__", " × "), r))
        elif len(rest) == 1 and rest[0] in SHAPES:
            recs.setdefault(arch, {})[rest[0]] = r
        else:
            extra.append((path.stem.replace("__", " × "), r))
    print("| Arch | " + " | ".join(SHAPES) + " |")
    print("|---|" + "---|" * len(SHAPES))
    for arch, row in recs.items():
        print(f"| {arch} | " + " | ".join(cell(row[s]) if s in row else "not run" for s in SHAPES) + " |")
    for name, r in extra:
        print(f"| {name} | {cell(r)} |" + " |" * (len(SHAPES) - 1))
    if meshes:
        print()
        print("| Cell × mesh | FLOPs/device | bytes/device | collective bytes/device by type | peak/device | roofline |")
        print("|---|---|---|---|---|---|")
        for name, r in meshes:
            print(mesh_row(name, r))


if __name__ == "__main__":
    main()
