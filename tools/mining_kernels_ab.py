"""The kernels of this checkout beside those of another, timed alike.

    PYTHONPATH=src python tools/mining_kernels_ab.py --other DIR [--rounds 2] [--kernels mining|flash_f32]

DIR is another checkout of the repo (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
It starts one process per checkout, in the order other, this, this, other
(``--rounds`` times), each with ``PYTHONPATH`` set to that checkout's
``src``; each builds that checkout's kernels, holds every launch against
that checkout's plain versions (``kernels/ref.py``) and times it with this
checkout's ``chip_smoke.median_ms``.  Prints one JSON line: the card, each
process's times, and the median of each time per checkout.  Needs a card
and ``nvcc``.

``--kernels mining`` (the default): this script first records the inputs
of every support-count launch of one GFM main-path run (``chip_smoke.py``'s data: T10I4D100K over
4 sites, k 4, minsup 0.01; levels 2-4 through ``support_count_prune_sites``
and the recount through ``support_count_sites``) and saves them under
``build/mining_kernels_ab/``; each process times those launches (median of
30), and ``kmeans_assign_sites`` at the clustering path's launch shape
(S 200, N 250,000, K 20, D 8) on seeded points and centres made on the card.

``--kernels flash_f32``: the float32 flash-attention kernel at gemma2-2b's
float32 scoring launches (B 1, S 8,192, H 8, Kv 4, Dh 256, causal, softcap
50; the full layer and the window layer, window 4,096) on seeded inputs,
held normwise within chip_smoke's SMOKE_FLASH_TOL of the plain version and
timed (median of 10); each process also gives a hash of each output, and
the line says whether the two checkouts' outputs are the same bits.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
KMEANS_SHAPE = (200, 250_000, 20, 8)  # S, N, K, D
FLASH_SHAPE = (1, 8192, 8, 4, 256)  # B, S, H, Kv, Dh: gemma2-2b's float32 scoring launch
FLASH_CAP, FLASH_WINDOWS = 50.0, {"full": 0, "window": 4096}


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


def imported_from(tree: str):
    """(chip_smoke of this checkout, ops and ref of ``tree``'s repro_torch)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels import ops, ref

    here = os.path.realpath(ops.__file__)
    if not here.startswith(os.path.realpath(tree) + os.sep):
        raise RuntimeError(f"imported {here}, not the kernels of {tree}")
    return chip_smoke, ops, ref


def flash_worker(tree: str) -> dict:
    """ms of ``tree``'s float32 flash kernel at each FLASH_WINDOWS launch,
    and a hash of each output; each held against that checkout's plain
    version first."""
    chip_smoke, ops, ref = imported_from(tree)
    b, s, h, kvh, dh = FLASH_SHAPE
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((b, s, n, dh), generator=gen).cuda() for n in (h, kvh, kvh))
    out = {}
    for name, window in FLASH_WINDOWS.items():
        got = ops.flash_attention(q, k, v, causal=True, window=window, cap=FLASH_CAP)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window, cap=FLASH_CAP)
        normwise = float(torch.linalg.vector_norm((got - want).double()) / torch.linalg.vector_norm(want.double()))
        if not normwise <= chip_smoke.SMOKE_FLASH_TOL:
            raise AssertionError(f"{tree}: the float32 flash kernel differs from the plain version ({normwise:.3g})")
        out[f"{name}_sha256"] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        del got, want
        out[f"{name}_ms"] = chip_smoke.median_ms(
            lambda: ops.flash_attention(q, k, v, causal=True, window=window, cap=FLASH_CAP), reps=10)
    return out


def worker(tree: str, path: str) -> dict:
    """Times of the mining kernels that ``repro_torch`` (imported from
    ``tree``) builds, on the saved inputs; each launch held against that
    checkout's plain versions first."""
    chip_smoke, ops, ref = imported_from(tree)
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
    ap.add_argument("--kernels", choices=("mining", "flash_f32"), default="mining")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card: the kernels have no CPU mode")
    if args.worker:
        result = flash_worker(args.worker) if args.kernels == "flash_f32" else worker(args.worker, args.inputs)
        print(json.dumps(result), flush=True)
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
    if args.kernels == "mining":
        record(path)
    runs = []
    for _ in range(args.rounds):
        for name, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
            env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree, "--inputs", path,
                                   "--kernels", args.kernels], env=env, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{name} ({tree}) failed:\n{proc.stdout}\n{proc.stderr}")
            runs.append({"tree": name, **json.loads(proc.stdout.strip().splitlines()[-1])})
    medians = {}
    for name in ("other", "this"):
        mine = [r for r in runs if r["tree"] == name]
        medians[name] = {}
        for key, value in mine[0].items():
            if isinstance(value, list):
                medians[name][key] = [statistics.median(r[key][j] for r in mine) for j in range(len(value))]
            elif isinstance(value, float):
                medians[name][key] = statistics.median(r[key] for r in mine)
    same_bits = {key.removesuffix("_sha256"): len({r[key] for r in runs}) == 1
                 for key in runs[0] if key.endswith("_sha256")}
    print(json.dumps({"mining_kernels_ab": {"card": card, "kernels": args.kernels, "other": other, "medians": medians,
                                            "same_bits": same_bits, "runs": runs}}), flush=True)


if __name__ == "__main__":
    main()
