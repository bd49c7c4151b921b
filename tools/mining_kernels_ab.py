"""The mining kernels of this checkout beside those of another, timed alike.

    PYTHONPATH=src python tools/mining_kernels_ab.py --other DIR [--rounds 2]

DIR is another checkout of the repo (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
On a CUDA card this script records the inputs of every support-count
launch of one GFM main-path run (``chip_smoke.py``'s data: T10I4D100K over
4 sites, k 4, minsup 0.01; levels 2-4 through ``support_count_prune_sites``
and the recount through ``support_count_sites``) and saves them under
``build/mining_kernels_ab/``.  Then it starts one process per checkout, in
the order other, this, this, other (``--rounds`` times), each with
``PYTHONPATH`` set to that checkout's ``src``.  Each process builds that
checkout's kernels, holds every launch against that checkout's plain
versions (``kernels/ref.py``), and times it with this checkout's
``chip_smoke.median_ms`` (median of 30).  It does the same for
``kmeans_assign_sites`` at the clustering path's launch shape (S 200,
N 250,000, K 20, D 8) on seeded points and centres made on the card.
Prints one JSON line: the card, each process's times, and the median of
each time per checkout.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
KMEANS_SHAPE = (200, 250_000, 20, 8)  # S, N, K, D


def record(path: str) -> None:
    """Save the inputs of every site-form support-count launch of one GFM
    main-path run of this checkout."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels import ops
    from repro_torch.runtime import GridRuntime

    dev = torch.device("cuda")
    _, sites = chip_smoke.gfm_sites(dev)
    params = {"k": chip_smoke.K, "minsup": chip_smoke.MINSUP}
    calls = chip_smoke.record_launch_inputs(ops, lambda: GridRuntime(device=dev).run("gfm", sites, params))
    torch.save({name: [tuple(t.cpu() for t in args) for args in launches] for name, launches in calls.items()}, path)


def worker(tree: str, path: str) -> dict:
    """Times of the kernels that ``repro_torch`` (imported from ``tree``)
    builds, on the saved inputs; each launch held against that checkout's
    plain versions first."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels import ops, ref

    here = os.path.realpath(ops.__file__)
    if not here.startswith(os.path.realpath(tree) + os.sep):
        raise RuntimeError(f"imported {here}, not the kernels of {tree}")
    dev = torch.device("cuda")
    calls = torch.load(path)
    out = {"support_count_prune_ms": [], "support_count_ms": []}
    for tx, masks, mc in calls["support_count_prune_sites"]:
        tx, masks, mc = tx.to(dev), masks.to(dev), mc.to(dev)
        got, want = ops.support_count_prune_sites(tx, masks, mc), ref.support_count_prune_sites_ref(tx, masks, mc)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{tree}: support_count_prune_sites differs from the plain version")
        out["support_count_prune_ms"].append(
            chip_smoke.median_ms(lambda: ops.support_count_prune_sites(tx, masks, mc), reps=30))
    for tx, masks in calls["support_count_sites"]:
        tx, masks = tx.to(dev), masks.to(dev)
        if not torch.equal(ops.support_count_sites(tx, masks), ref.support_count_sites_ref(tx, masks)):
            raise AssertionError(f"{tree}: support_count_sites differs from the plain version")
        out["support_count_ms"].append(chip_smoke.median_ms(lambda: ops.support_count_sites(tx, masks), reps=30))
    s, n, k, d = KMEANS_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = torch.randn((s, n, d), generator=gen, device=dev) * 5
    cs = torch.randn((s, k, d), generator=gen, device=dev) * 5
    got, want = ops.kmeans_assign_sites(xs, cs), ref.kmeans_assign_sites_ref(xs, cs)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{tree}: kmeans_assign_sites is not bit-identical to the plain version")
    del got, want
    out["kmeans_assign_ms"] = chip_smoke.median_ms(lambda: ops.kmeans_assign_sites(xs, cs), reps=30)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=2, help="times to run the order other, this, this, other")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card: the kernels have no CPU mode")
    if args.worker:
        print(json.dumps(worker(args.worker, args.inputs)), flush=True)
        return
    if not args.other:
        ap.error("--other is required")
    other = os.path.realpath(args.other)
    if not os.path.isfile(os.path.join(other, "src", "repro_torch", "kernels", "ops.py")):
        ap.error(f"{other} is not a checkout of this repo")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    out_dir = os.path.join(ROOT, "build", "mining_kernels_ab")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "support_count_inputs.pt")
    record(path)
    runs = []
    for _ in range(args.rounds):
        for name, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
            env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree, "--inputs", path],
                                  env=env, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{name} ({tree}) failed:\n{proc.stdout}\n{proc.stderr}")
            runs.append({"tree": name, **json.loads(proc.stdout.strip().splitlines()[-1])})
    medians = {}
    for name in ("other", "this"):
        mine = [r for r in runs if r["tree"] == name]
        medians[name] = {"kmeans_assign_ms": statistics.median(r["kmeans_assign_ms"] for r in mine)}
        for key in ("support_count_prune_ms", "support_count_ms"):
            medians[name][key] = [statistics.median(r[key][j] for r in mine) for j in range(len(mine[0][key]))]
    print(json.dumps({"mining_kernels_ab": {"card": card, "other": other, "medians": medians, "runs": runs}}),
          flush=True)


if __name__ == "__main__":
    main()
