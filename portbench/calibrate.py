#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size, many seeds in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 21,22,23] [--faults half,altered --fault-seeds 31,32,33]

For each ``--seeds`` seed the program as the cell runs it (set-up, and for
an entry that judges calls of its window, the mix's ``calibrate_calls``
calls) against the float32 reference: the lower readings.  For each
``--control-seeds`` seed the reference in fp8 in the program's place: the
control, the upper readings.  ``--faults`` plants ``portbench.faults``
under the program.  One JSON line a reading on standard output.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def leaf_details(got: dict, want: dict, k: int = 8) -> dict:
    """A training cell's ``k`` leaves of widest gap in ``grad1`` and in
    ``change``, as ``Entry.numbers`` compares them: [name, gap, the
    program's norm, the reference's norm, the reference's median leaf
    norm, the reference's step-1 gradient norm]."""
    import statistics

    from portbench.entries.train import STILL

    moving = statistics.median(want["grad1_raw"].values())
    keep = [n for n, g in want["grad1_raw"].items() if g >= STILL * moving]
    out = {}
    for key in ("grad1", "change"):
        mid = statistics.median(want[key][n] for n in keep)
        rows = [[n, abs(got[key][n] - want[key][n]) / max(want[key][n], mid, 1e-30), got[key][n], want[key][n],
                 mid, want["grad1_raw"][n]] for n in keep]
        out[key] = sorted(rows, key=lambda r: -r[1])[:k]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--control-precision", default="fp8", help="fp8, or bfloat16 as a witness")
    ap.add_argument("--details", action="store_true", help="a training cell's worst leaves")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.run import cache_env

    cache_env(ROOT)
    import torch

    from portbench import faults, manifest

    cell = manifest.resolve(ROOT, manifest.load(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("calibrate.py reads the card: no CUDA card", file=sys.stderr)
        return 2
    mod = manifest.entry_module(cell.entry)
    card = torch.cuda.get_device_name(0)
    calls = int(cell.mix.get("calibrate_calls", 0))

    def program(seed: int, fault: str | None):
        entry = mod.Entry(cell, seed, "cuda")
        if fault:
            faults.plant(entry, fault)
        entry.setup()
        for _ in range(calls):
            entry.call()
        torch.cuda.synchronize()
        entry.close()
        gc.collect()
        torch.cuda.empty_cache()
        return entry, entry.program()

    jobs = [("program", s, None) for s in seeds(args.seeds)]
    jobs += [("control", s, None) for s in seeds(args.control_seeds)]
    jobs += [("fault", s, f) for f in args.faults.split(",") if f for s in seeds(args.fault_seeds)]
    for kind, seed, fault in jobs:
        t0 = time.perf_counter()
        if kind == "control":
            entry = mod.Entry(cell, seed, "cuda")
            if calls:
                entry.judge_without_calls(calls)
            got = entry.reference(args.control_precision)
        else:
            entry, got = program(seed, fault)
        want = entry.reference("float32")
        line = {"cell": cell.name, "kind": kind + (f".{args.control_precision}" if kind == "control" else ""),
                "fault": fault, "seed": seed, "numbers": entry.numbers(got, want)}
        if args.details and cell.entry == "train":
            line["leaves"] = leaf_details(got, want)
        del got, want, entry
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({**line, "s": time.perf_counter() - t0, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
