"""Print the sharded-count tests' cells as a markdown table: per-device
FLOPs of the port's step on a fake (pod 2, data 2, model 2) group
(``launch.dryrun.count_cell``) against ``analyze_hlo`` of the JAX
package's sharded compile on 8 host devices, their ratio, and the
collective bytes per device by type on each side (not gated: the two
partitioners choose differently).  The cells are those of
``tests/test_torch_sharded_counts_*.py``; both sides are counted in
processes of their own (``tests/torch_sharded_cells.py``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/sharded_counts_table.py
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from torch_sharded_cells import count_both  # noqa: E402

ARCHS = ["phi-3-vision-4.2b", "phi3-mini-3.8b", "granite-20b", "stablelm-1.6b", "gemma2-2b", "zamba2-1.2b",
         "mixtral-8x22b", "deepseek-moe-16b", "xlstm-1.3b", "seamless-m4t-large-v2"]
CELLS = ([[a, "train", False] for a in ARCHS]
         + [[a, "train", True] for a in ("stablelm-1.6b", "mixtral-8x22b", "xlstm-1.3b", "zamba2-1.2b")]
         + [[a, k, False] for a in ("gemma2-2b", "xlstm-1.3b", "seamless-m4t-large-v2") for k in ("prefill", "decode")])


def _coll(c: dict) -> str:
    short = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS", "all-to-all": "A2A",
             "collective-permute": "CP"}
    return ", ".join(f"{short.get(k, k)} {v:,.0f}" for k, v in sorted(c.items()))


def main() -> None:
    ref, port = {}, {}
    for i in range(0, len(CELLS), 4):  # a few cells a pair of processes
        r, p = count_both(CELLS[i:i + 4], timeout=900)
        ref.update(r)
        port.update(p)
    print("| Cell | Port FLOPs/device | Reference FLOPs/device | Ratio | Port collective B/device | Reference collective B/device |")
    print("|---|---|---|---|---|---|")
    for a, k, gl in CELLS:
        key = (a, k, gl)
        name = f"{a} {k}{' GridLocal' if gl else ''}"
        print(f"| {name} | {port[key]['flops']:.4e} | {ref[key]['flops']:.4e} | {port[key]['flops'] / ref[key]['flops']:.4f} "
              f"| {_coll(port[key]['coll'])} | {_coll(ref[key]['coll'])} |", flush=True)


if __name__ == "__main__":
    main()
