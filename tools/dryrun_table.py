"""Print the one-card dry run's records (``experiments/dryrun_torch/``,
written by ``python -m repro_torch.launch.dryrun --all``) as a markdown
table, a row an arch and a column a shape: the counted FLOPs, the peak
estimate in GB at the grad_accum the step was counted at (``*``: it does
not fit the card), and the dominant roofline term with its bound in
seconds.  Records of cut batches or GridLocal follow, a row each.  The
numbers are counts on fake tensors against NVIDIA's data sheet
(``launch.mesh.HW``), not times.

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=str(ROOT / "experiments" / "dryrun_torch"))
    args = ap.parse_args()
    recs, extra = {}, []
    for path in sorted(Path(args.dir).glob("*.json")):
        arch, *rest = path.stem.split("__")
        r = json.loads(path.read_text())
        if len(rest) == 1 and rest[0] in SHAPES:
            recs.setdefault(arch, {})[rest[0]] = r
        else:
            extra.append((path.stem.replace("__", " × "), r))
    print("| Arch | " + " | ".join(SHAPES) + " |")
    print("|---|" + "---|" * len(SHAPES))
    for arch, row in recs.items():
        print(f"| {arch} | " + " | ".join(cell(row[s]) if s in row else "not run" for s in SHAPES) + " |")
    for name, r in extra:
        print(f"| {name} | {cell(r)} |" + " |" * (len(SHAPES) - 1))


if __name__ == "__main__":
    main()
