"""Run chip_smoke.py's phases 25 (deepseek-moe-16b, mixtral-8x22b), 26
(zamba2-1.2b), 27 (seamless-m4t-large-v2, phi-3-vision-4.2b) and 28-33
(the train step, GridLocal over two pods, the training entry, the dry run
of the train step's cell; stablelm-1.6b; the sharded step; gemma2-2b and
zamba2-1.2b trained) alone: build the kernels, then each arch at its
published widths (the depth of ``chip_smoke.LM_RUNS``) through
``chip_smoke.run_lm``, and phases 28-33 through ``chip_smoke.run_train``
(the train child, a process of its own), with every check of the phase.

    PYTHONPATH=src python tools/lm_phases.py [--phases 27,29] [--archs deepseek-moe-16b,zamba2-1.2b]

``--phases`` picks the archs of those phases (``chip_smoke.LM_PHASE``) and
any of 28-33 (the train child runs only those of 28-30 and 33, and 28 with
31, which reads its measured step; 32 runs its own child after it; run
from here, 28 also measures what its determinism costs), ``--archs`` names
archs; with neither, every arch of ``LM_RUNS`` runs, then phases 28-33.

Prints the phases' report lines, then one JSON line with the flash
kernel's row for each arch, the train child's report, and the card's name
and power limit.  Needs the card; exits 1 without one, or when a check
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default="", help="comma-separated archs of chip_smoke.LM_RUNS (default: all)")
    ap.add_argument("--phases", default="", help="comma-separated phases of chip_smoke.LM_PHASE, e.g. 27")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: these phases run the models on the card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref

    phases = {int(p) for p in args.phases.split(",") if p}
    archs = [a for a in args.archs.split(",") if a] + [a for a in cs.LM_RUNS if cs.LM_PHASE[a] in phases]
    train = sorted(phases & set(cs.TR_PHASES)) or (list(cs.TR_PHASES) if not (phases or archs) else [])
    if not (phases or archs):
        archs = list(cs.LM_RUNS)
    unknown = [a for a in archs if a not in cs.LM_RUNS]
    if unknown:
        sys.exit(f"not in chip_smoke.LM_RUNS: {unknown}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown card"
    t0 = time.perf_counter()
    reports = _build.build_all()
    cs.log(f"build_s: {time.perf_counter() - t0:.3f} ({', '.join(reports) or 'cached'})")
    rows = {}
    for arch in archs:
        t0 = time.perf_counter()
        rows[arch] = cs.run_lm(torch.device("cuda"), card, ops, ref, arch)
        cs.log(f"phase {cs.LM_PHASE[arch]}, {arch}: {time.perf_counter() - t0:.1f} s")
    cs.TR_COSTS = 28 in train  # alone, phase 28 also measures what its determinism costs
    trained = cs.run_train(torch.device("cuda"), card, train) if train else None
    print(json.dumps({"flash_attention": rows, "train": trained, "card": card}), flush=True)


if __name__ == "__main__":
    main()
