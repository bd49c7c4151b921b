"""The clustering main path's labels under this checkout and another, on the same data.

    PYTHONPATH=src python tools/clustering_labels_ab.py --other DIR

DIR is another checkout of the repo (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
It starts one process per checkout, other then this, each with
``PYTHONPATH`` set to that checkout's ``src``; each runs ``chip_smoke.py``'s
phase-6 configuration once (this checkout's ``chip_smoke.clustering_points``
and ``CL_PARAMS``: 5e7 points of D 8 over 200 sites, k_local 20, 20
iterations, seed 0; ``GridRuntime`` defaults: batched, staged, kernel) and
gives a SHA-256 of its labels, n_global, n_merges and its host wall.
Prints one JSON line with the card and whether the two checkouts' labels
are the same bits; exits 1 if they are not.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def worker(tree: str) -> dict:
    """The clustering main path of ``tree``'s ``repro_torch`` on
    chip_smoke's phase-6 data."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.runtime import GridRuntime

    here = os.path.realpath(sys.modules["repro_torch"].__file__)
    if not here.startswith(os.path.realpath(tree) + os.sep):
        raise RuntimeError(f"imported {here}, not the repro_torch of {tree}")
    dev = torch.device("cuda")
    xs_np = chip_smoke.clustering_points()[0]
    xs = torch.from_numpy(xs_np).to(dev)
    del xs_np
    t0 = time.perf_counter()
    res = GridRuntime(device=dev).run("vclustering", xs, chip_smoke.CL_PARAMS).result
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"labels_sha256": hashlib.sha256(res.labels.cpu().numpy().tobytes()).hexdigest(),
            "n_global": res.merged.n_global, "n_merges": res.merged.n_merges, "wall_s": wall}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card: the path runs on the card")
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return
    if not args.other:
        ap.error("--other is required")
    other = os.path.realpath(args.other)
    if not os.path.isfile(os.path.join(other, "src", "repro_torch", "core", "vclustering.py")):
        ap.error(f"{other} is not a checkout of this repo")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    runs = {}
    for name, tree in (("other", other), ("this", ROOT)):
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree], env=env,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} ({tree}) failed:\n{proc.stdout}\n{proc.stderr}")
        runs[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    same = runs["other"] == {**runs["this"], "wall_s": runs["other"]["wall_s"]}
    print(json.dumps({"clustering_labels_ab": {"card": card, "other": other, "same_bits": same, "runs": runs}}),
          flush=True)
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
