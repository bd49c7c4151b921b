"""The K-Means assignment kernel beside its two floors, on a CUDA card.

    PYTHONPATH=src python tools/kmeans_floors.py [--sites 200] [--points 250000] [--k 20] [--d 8]

At the clustering path's launch shape by default (S 200, N 250,000, K 20,
D 8: the paper's Table 3 row over 200 sites), on seeded random points and
centres made on the card: builds the kernels, checks that the kernel
(``csrc/kmeans_assign.cu``) is bit-identical to the plain version, and
times the kernel and the two floors built from the same body
(``csrc/kmeans_assign_floors.cu``: ``load_only`` reads every point row and
writes both outputs with no arithmetic, ``arith_only`` does all the
arithmetic on points made from their index and loads no row) with
``chip_smoke.median_ms`` (median of 30), beside ``chip_smoke``'s bytes
bound and issue floor.  What it adds to ``chip_smoke.py``: it then runs
the kernel back to back for two seconds while ``nvidia-smi`` samples the
SM clock and the power draw every 100 ms, and restates the issue floor at
the sampled clock.  Prints one JSON line.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402


def clock_and_power(fn, seconds: float = 2.0) -> tuple[float, float]:
    """Median SM clock (MHz) and power draw (W) that nvidia-smi samples
    every 100 ms while ``fn`` runs back to back for ``seconds``."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [[float(v) for v in line.split(",")] for line in out.strip().splitlines()[2:] if line.strip()]
    if not samples:
        raise RuntimeError(f"nvidia-smi sampled nothing: {out!r}")
    return statistics.median(c for c, _ in samples), statistics.median(w for _, w in samples)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", type=int, default=200)
    ap.add_argument("--points", type=int, default=250_000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--d", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card: the kernel has no CPU mode")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    for name, log in _build.build_all().items():
        for line in log.splitlines():
            if name.startswith("kmeans") and ("registers" in line or "spill" in line):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    s, n, k, d = args.sites, args.points, args.k, args.d
    xs = torch.randn((s, n, d), generator=gen, device=dev) * 5
    cs = torch.randn((s, k, d), generator=gen, device=dev) * 5
    a, m = ops.kmeans_assign_sites(xs, cs)
    ra, rm = ref.kmeans_assign_sites_ref(xs, cs)
    if not (torch.equal(a, ra) and torch.equal(m, rm)):
        raise AssertionError("the kernel is not bit-identical to the plain version")
    del ra, rm
    for floor in ops.KMEANS_FLOORS:  # both floors launch and write every output
        fa, fm = ops.kmeans_assign_floor(xs, cs, floor)
        torch.cuda.synchronize()
        if fa.shape != a.shape or fm.shape != m.shape:
            raise AssertionError(f"floor {floor}: outputs of the wrong shape")
    times = {"kernel_ms": chip_smoke.median_ms(lambda: ops.kmeans_assign_sites(xs, cs), reps=30)}
    for floor in ops.KMEANS_FLOORS:
        times[f"{floor}_ms"] = chip_smoke.median_ms(lambda: ops.kmeans_assign_floor(xs, cs, floor), reps=30)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b = {"bytes_bound_ms": chip_smoke.kmeans_bound(xs, cs)[0],
         "issue_floor_ms": chip_smoke.kmeans_issue_floor_ms(s, n, k, d, sms)}
    shares = {f"{t[:-3]}_share_of_{name[:-3]}": b[name] / times[t] for t in times for name in b}
    mhz, watts = clock_and_power(lambda: ops.kmeans_assign_sites(xs, cs))
    print(json.dumps({"kmeans_floors": {
        "shape": {"S": s, "N": n, "K": k, "D": d}, **times, **b, **shares, "sm_clock_mhz": mhz, "power_w": watts,
        "issue_floor_at_clock_ms": chip_smoke.kmeans_issue_floor_ms(s, n, k, d, sms, hz=mhz * 1e6), "card": card,
    }}), flush=True)


if __name__ == "__main__":
    main()
