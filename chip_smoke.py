"""Chip smoke for the PyTorch port: build the CUDA kernels, hold each one
against its plain PyTorch version on the card, then run both of the
paper's algorithms end to end through ``GridRuntime.run``:

  * GFM (Algorithm 2) at the IBM Quest T10I4D100K shape over 4 sites;
  * vclustering (Algorithm 1) at the paper's Table 3 size: 5e7 points in
    8 dimensions over 200 sites, 20 sub-clusters a site, 20 Lloyd
    iterations.

    python3 chip_smoke.py

For each path it then breaks the run down (device busy time and kernels
by torch.profiler, host functions by cProfile, and for clustering each
phase on its own), records the inputs of every kernel launch of one more
run, and holds and times each kernel at those inputs.  Needs one CUDA card
and ``nvcc``; exits non-zero without them, or when any check fails.
Imports the port only (``src/repro_torch``), never jax and never the JAX
package.  The last line of standard output is ``{"ok": true, "device":
{...}}``; the line before it is the card's name and power limit, and the
one before that lists every kernel with its launches on its path and, at
the path's largest launch of it, its time, its plain version's time, its
bound and the nearest library call's time.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, at the full 700 W).  The
# data sheet gives no int32 rate; the 67 TFLOP/s fp32 peak is 128 lanes per
# SM with 2 flops per FMA, and Hopper's int32 logic pipe has 64 lanes per
# SM, so its peak is 67e12 / 2 / 2 int32 operations per second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
FP32_FLOPS_PER_S = 67e12

# the main path: IBM Quest T10I4D100K (100,000 transactions, 1,000 items,
# average length 10, pattern length 4), over 4 grid sites
N_TX, N_ITEMS, N_SITES, K, MINSUP = 100_000, 1000, 4, 4, 0.01
MAIN_C = 2048  # candidates per site at the fixed level-2 kernel shape
DEVICE = "cuda"

# the clustering path: the paper's Table 3 V-Clustering row (5e7 samples over
# 200 processes, 20 sub-clusters each; benchmarks/bench_clustering.py:1-9),
# at the repo's dimension D = 8, over a 12-component Gaussian mixture
CL_POINTS, CL_DIM, CL_SITES, CL_COMPONENTS = 50_000_000, 8, 200, 12
CL_PARAMS = {"k_local": 20, "iters": 20, "seed": 0}
CL_PURITY = 0.99  # share of points in the majority planted component of their global cluster
CL_PLAIN_AGREE = 0.999  # share of points the plain path labels alike, up to renaming
# kernel vs plain: assignments must match wherever the plain best and second
# best d² differ by more than TIE_RTOL * (|x|^2 + max |c|^2); min d² within
# MIND2_RTOL plus 8 float32 roundings of that scale
TIE_RTOL, MIND2_RTOL = 1e-6, 1e-6


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the report on stdout; its time since the start, and its
    head, on stderr."""
    print(msg, flush=True)
    print(f"[{time.perf_counter() - T_START:8.1f} s] {msg[:100]}", file=sys.stderr, flush=True)


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call.
    All calls are enqueued back to back, so each event pair brackets one
    call's device work and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for a, b in zip(starts, ends):
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(starts, ends))


def profile_main_path(run_once, path: str = "gfm", phases=()) -> None:
    """Where the main path's time goes: the device's busy time and kernel
    breakdown from torch.profiler, and the host's top functions from
    cProfile (each over its own run, so neither pays the other's cost).

    ``phases`` names port functions, as (module, attribute, label), to
    wrap during the traced run only: each call becomes a record_function
    window that ends in a synchronize, and its row gives the window's host
    wall and the device time of the kernels that started inside it."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_once()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3

    real = {(mod, name): getattr(mod, name) for mod, name, _ in phases}

    def annotated(fn, label):
        def window(*args, **kwargs):
            with record_function(label):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            return out
        return window

    for mod, name, label in phases:
        setattr(mod, name, annotated(real[(mod, name)], label))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_once()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
    # the raw trace, not prof.key_averages(): that lists each kernel both
    # under its own name and under the op that launched it, and building it
    # takes minutes at the clustering path's 10^5 kernels.  A device event
    # that is not a user annotation (the record_function windows appear on
    # the device timeline too) is a kernel, a copy or a memset.
    t0 = time.perf_counter()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels, windows, by_name = [], [], {}
    labels = {label for _, _, label in phases}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            kernels.append((e.start_ns(), e.end_ns()))
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
        elif e.device_type() == cpu and e.name() in labels:
            windows.append((e.name(), e.start_ns(), e.end_ns()))
    busy_ms = sum(b - a for a, b in kernels) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {
        "path": path, "wall_ms": bare_ms, "traced_wall_ms": traced_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / traced_ms if traced_ms > 0 else None,
        "device_events": len(kernels),
        "device_top": [{"name": n[:80], "ms": ms, "calls": c} for n, (ms, c) in top],
    }
    if phases:
        kernels.sort()
        starts = [a for a, _ in kernels]
        rows = {label: {"host_ms": 0.0, "device_busy_ms": 0.0, "calls": 0} for _, _, label in phases}
        for label, a, b in windows:
            lo, hi = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
            rows[label]["host_ms"] += (b - a) / 1e6
            rows[label]["device_busy_ms"] += sum(k1 - k0 for k0, k1 in kernels[lo:hi]) / 1e6
            rows[label]["calls"] += 1
        for row in rows.values():
            row["share_of_traced_wall"] = row["host_ms"] / traced_ms if traced_ms > 0 else None
        out["phases"] = rows
    out["trace_processing_s"] = time.perf_counter() - t0
    log(json.dumps({"profile": out}))
    prof_host = cProfile.Profile()
    prof_host.enable()
    run_once()
    torch.cuda.synchronize()
    prof_host.disable()
    stats = pstats.Stats(prof_host)
    rows = []
    for (file, line, fn), (_, ncalls, tottime, cumtime, _) in stats.stats.items():
        if "repro_torch" in file or "torch._C" in fn:
            rows.append((cumtime, tottime, ncalls, f"{os.path.basename(file)}:{line}:{fn}"))
    rows.sort(reverse=True)
    log(json.dumps({"path": path, "host_profile_top": [
        {"fn": name, "cum_s": cum, "self_s": tot, "calls": n} for cum, tot, n, name in rows[:15]
    ]}))


def record_launch_inputs(ops, run_once) -> dict:
    """The inputs of every launch of the site-form wrappers during one
    call of ``run_once``: the wrappers are wrapped, for that call only, by
    ones that keep a copy of their arguments and then call them."""
    names = ("support_count_sites", "support_count_prune_sites")
    calls = {name: [] for name in names}
    real = {name: getattr(ops, name) for name in names}

    def recorder(name):
        def fn(*args):
            if all(d > 0 for d in (args[0].shape[0], args[0].shape[1], args[1].shape[1])):
                calls[name].append(tuple(torch.as_tensor(a).clone() for a in args))
            return real[name](*args)
        return fn

    for name in names:
        setattr(ops, name, recorder(name))
    try:
        run_once()
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    return calls


def record_kmeans_launches(ops, run_once) -> list:
    """The inputs of every ``kmeans_assign_sites`` launch during one call
    of ``run_once``.  Every launch of the batched path reads the same
    points tensor, so a points tensor is kept once (by storage) and each
    launch's centres are cloned."""
    calls, points = [], {}
    real = ops.kmeans_assign_sites

    def recorder(xs, centers):
        if xs.shape[1] > 0:
            key = (xs.data_ptr(), tuple(xs.shape))
            points.setdefault(key, xs)
            calls.append((points[key], centers.clone()))
        return real(xs, centers)

    ops.kmeans_assign_sites = recorder
    try:
        run_once()
    finally:
        ops.kmeans_assign_sites = real
    return calls


def run_clustering(dev, card, ops, ref, tkm, tvc, GridRuntime) -> dict:
    """The clustering slice on the card: the K-Means kernel against its
    plain version, the main path at full size with its checks, its
    profile, and the kernel at the path's own inputs.  Returns the
    kernel's row of the ``kernels`` line."""
    from repro_torch.data.synthetic import gaussian_mixture, split_sites

    check(not torch.backends.cuda.matmul.allow_tf32, "allow_tf32 is on: fp32 matmuls would run in TF32")

    # ---- phase 5: the K-Means kernel against its plain version -------------
    def hold_assign(xs, cs, label):
        """Both wrappers against the plain version.  Assignments must be
        equal wherever the plain best and second best d² differ by more
        than TIE_RTOL of the distances' scale; min d² within MIND2_RTOL plus
        8 float32 roundings of that scale.  Returns the largest |min d²|
        difference and the points inside the tie band."""
        a, m = ops.kmeans_assign_sites(xs, cs)
        a1, m1 = ops.kmeans_assign(xs[0], cs[0])
        torch.cuda.synchronize()
        ra, rm = ref.kmeans_assign_sites_ref(xs, cs)
        check(torch.equal(a1, a[0]) and torch.equal(m1, m[0]), f"{label}: kmeans_assign differs from the site form")
        if xs.shape[1] == 0:
            log(f"kmeans kernel check {label}: empty ({tuple(xs.shape)} x {tuple(cs.shape)})")
            return 0.0, 0
        scale = (ref.dot_last(xs, xs) + ref.dot_last(cs, cs).max(dim=1, keepdim=True).values).double()
        k = cs.shape[1]
        if k > 1:
            x2 = ref.dot_last(xs, xs)
            d2 = (x2[:, :, None] + ref.dot_last(cs, cs)[:, None, :]) - 2.0 * ref.dot_last(xs[:, :, None, :], cs[:, None, :, :])
            two = torch.topk(d2, 2, dim=-1, largest=False).values.double()
            tie = (two[..., 1] - two[..., 0]) <= TIE_RTOL * scale
            del d2, two
        else:
            tie = torch.zeros_like(a, dtype=torch.bool)
        bad = (a != ra) & ~tie
        err = (m.double() - rm.double()).abs()
        tol = MIND2_RTOL * rm.double().abs() + 8 * float(np.finfo(np.float32).eps) * scale
        n_tie, n_diff = int(tie.sum()), int((a != ra).sum())
        log(f"kmeans kernel check {label}: {tuple(xs.shape)} x {tuple(cs.shape)}, {n_tie} points in the tie band, "
            f"{n_diff} assignments differ, max |min d2 err| {float(err.max()):.3g}, "
            f"bit-identical {torch.equal(a, ra) and torch.equal(m, rm)}")
        check(not bool(bad.any()), f"{label}: kmeans_assign_sites assigns {int(bad.sum())} points otherwise")
        check(bool((err <= tol).all()), f"{label}: min d2 differs from the plain version past the tolerance")
        return float(err.max()), n_tie

    gen = torch.Generator().manual_seed(0)
    for s, n, k, d, dup, on_center in [
        (1, 1000, 20, 8, False, False), (4, 777, 1, 1, False, False), (1, 0, 5, 3, False, False),
        (2, 301, 600, 8, True, True), (2, 257, 70, 100, True, True), (4, 129, 5, 3, True, False),
        (200, 2049, 20, 8, True, True), (4, 70_001, 20, 8, False, False),
    ]:
        xs = torch.randn((s, n, d), generator=gen) * 5
        cs = torch.randn((s, k, d), generator=gen) * 5
        if dup and k > 1:
            cs[:, k - 1] = cs[:, 0]  # ties go to the lowest index
        if on_center and n > 0:
            xs[:, : min(n, k)] = cs[:, : min(n, k)]  # the clamp at 0
        hold_assign(xs.to(dev), cs.to(dev), f"S{s}-N{n}-K{k}-D{d}{'-dup' if dup else ''}{'-on' if on_center else ''}")

    # ---- phase 6: the clustering main path, at full size -------------------
    t0 = time.perf_counter()
    pts, comp = gaussian_mixture(7, CL_POINTS, CL_DIM, n_components=CL_COMPONENTS, spread=20.0, sigma=0.8)
    xs_np = split_sites(pts, CL_SITES, seed=1)
    # the planted component of every site point, from the permutation
    # split_sites draws (numpy only: independent of the code under test)
    truth = comp[np.random.default_rng(1).permutation(len(pts))[: xs_np.shape[0] * xs_np.shape[1]]]
    del pts, comp
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    xs = torch.from_numpy(xs_np).to(dev)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    del xs_np
    n_total = xs.shape[0] * xs.shape[1]
    log(f"clustering data: {tuple(xs.shape)} f32, {xs.numel() * 4 / 1e9:.3f} GB; generate {data_s:.3f} s, "
        f"host to device {h2d_s:.3f} s")

    def run_once(**kw):
        return GridRuntime(device=dev, **kw).run("vclustering", xs, CL_PARAMS)

    def timed_run(label, **kw):
        t0 = time.perf_counter()
        out = run_once(**kw)
        torch.cuda.synchronize()
        log(f"clustering {label}: {time.perf_counter() - t0:.3f} s host wall")
        return out.result

    ops.reset_launches()
    t0 = time.perf_counter()
    run = run_once()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    res = run.result
    log(f"clustering main path (batched, staged, kernel): {wall:.3f} s host wall, launches "
        f"{ {k: v for k, v in launches.items() if k.startswith('kmeans')} }")
    n_launch = launches["kmeans_assign_sites"] + launches["kmeans_assign"]
    check(launches["kmeans_assign_sites"] == CL_PARAMS["iters"] + 1 and launches["kmeans_assign"] == 0,
          f"kmeans_assign_sites launched {launches['kmeans_assign_sites']} times, want {CL_PARAMS['iters'] + 1}")
    labels = res.labels
    check(tuple(labels.shape) == tuple(xs.shape[:2]) and labels.dtype == torch.int32, "labels shape or type")
    t0 = time.perf_counter()
    lab = labels.cpu().numpy().reshape(-1)
    d2h_s = time.perf_counter() - t0
    sizes = res.merged.stats.sizes
    check(bool((sizes == sizes.round()).all()), "merged sizes are not integers")
    size_sum = int(sizes.long().sum())
    m = res.merged.labels.shape[0]
    table = np.bincount(lab.astype(np.int64) * CL_COMPONENTS + truth, minlength=m * CL_COMPONENTS)
    purity = table.reshape(m, CL_COMPONENTS).max(axis=1).sum() / n_total
    log(f"clustering result: n_global {res.merged.n_global}, n_merges {res.merged.n_merges}, purity {purity:.6f}, "
        f"merged sizes sum {size_sum}, comm_bytes {res.comm_bytes}, labels to host {d2h_s:.3f} s")
    log("clustering measured job s: " + json.dumps({
        "cluster (sum)": sum(v for k, v in run.measured.items() if k.startswith("cluster_")),
        "merge": run.measured["merge"],
        "perturb (sum)": sum(v for k, v in run.measured.items() if k.startswith("perturb_")),
        "collect": run.measured["collect"],
    }))
    check(purity >= CL_PURITY, f"purity {purity:.6f} against the planted components, want >= {CL_PURITY}")
    check(size_sum == n_total, f"merged sizes sum to {size_sum}, want {n_total}")

    again = timed_run("second batched run")
    check(torch.equal(again.labels, labels) and (again.merged.n_global, again.merged.n_merges)
          == (res.merged.n_global, res.merged.n_merges), "a second batched run differs")
    del again
    ops.reset_launches()
    inline = timed_run("inline + async run", backend="inline", schedule="async")
    inline_launches = {k: v for k, v in ops.LAUNCHES.items() if k.startswith("kmeans")}
    log(f"clustering inline + async launches {inline_launches}")
    check(inline_launches == {"kmeans_assign": (CL_PARAMS["iters"] + 1) * CL_SITES, "kmeans_assign_sites": 0},
          f"inline + async launched {inline_launches}, want kmeans_assign {(CL_PARAMS['iters'] + 1) * CL_SITES} times")
    check(torch.equal(inline.labels, labels) and (inline.merged.n_global, inline.merged.n_merges)
          == (res.merged.n_global, res.merged.n_merges), "inline + async differs from batched + staged")
    del inline
    log("clustering: two batched runs identical; batched + staged == inline + async")
    plain = timed_run("plain run (use_kernel=False)", use_kernel=False)
    pl = plain.labels.cpu().numpy().reshape(-1)
    # rename the plain path's labels onto the kernel path's by majority
    pair = np.bincount(pl.astype(np.int64) * m + lab, minlength=m * m).reshape(m, m)
    differ = int(n_total - pair.max(axis=1).sum())
    log(f"clustering plain path (use_kernel=False): n_global {plain.merged.n_global}, "
        f"n_merges {plain.merged.n_merges}, {differ} of {n_total} points labelled otherwise up to renaming")
    check(plain.merged.n_global == res.merged.n_global, "the plain path finds another number of global clusters")
    check(differ <= (1 - CL_PLAIN_AGREE) * n_total, f"the plain path labels {differ} points otherwise")
    del plain, pl, pair, lab

    # ---- phase 7: where the clustering path's time goes ---------------------
    profile_main_path(run_once, path="vclustering", phases=[
        (tkm, "kmeans_plus_plus_sites", "seeding"), (tkm, "lloyd_sites", "lloyd"),
        (tvc, "merge_subclusters", "merge loop"), (tvc, "perturb_sites", "perturbation loop"),
    ])

    # ---- phase 8: the kernel at the path's own inputs ------------------------
    t0 = time.perf_counter()
    calls = record_kmeans_launches(ops, run_once)
    log(f"clustering recorded run: {time.perf_counter() - t0:.3f} s host wall")
    check(len(calls) == n_launch, f"{len(calls)} recorded kmeans launches, {n_launch} on the main path")
    def kmeans_bound(px, pc):
        """(bytes bound ms, operations bound ms) of one launch: points and
        centres read once, assignment and min d² written once; 2·K·D flops
        a point."""
        s, n, d = px.shape
        nbytes = (px.numel() + pc.numel()) * 4 + s * n * 8
        flops = 2 * s * n * pc.shape[1] * d
        return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3, nbytes, flops

    errs, ties, launch_ms, bounds = [], [], [], []
    for j, (px, pc) in enumerate(calls):  # every launch, held against the plain version and timed
        err, n_tie = hold_assign(px, pc, f"main path, launch {j + 1}")
        errs.append(err)
        ties.append(n_tie)
        launch_ms.append(median_ms(lambda: ops.kmeans_assign_sites(px, pc), reps=30))
        bounds.append(max(kmeans_bound(px, pc)[:2]))
    log("clustering kmeans_assign_sites ms per launch of the path (median of 30 each): " + json.dumps(launch_ms))
    px, pc = calls[-1]  # the final assignment; every launch has the path's one shape
    s, n, d = px.shape
    k = pc.shape[1]
    p_ms = median_ms(lambda: ref.kmeans_assign_sites_ref(px, pc), reps=5, warmup=1)
    lib_ms = median_ms(lambda: torch.cdist(px, pc, compute_mode="use_mm_for_euclid_dist").min(-1), reps=5, warmup=1)
    t_bytes, t_ops, nbytes, flops = kmeans_bound(px, pc)
    row = {
        "name": "kmeans_assign", "route": "cuda", "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign.py:45", "launches": n_launch, "max_abs_err": max(errs),
        "ms": launch_ms[-1], "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib_ms,
        "library": "torch.cdist(compute_mode='use_mm_for_euclid_dist').min(-1)",
        "at": "main path, final assignment", "shape": {"S": s, "N": n, "K": k, "D": d},
        "points_in_tie_band": max(ties), "path_ms": sum(launch_ms), "path_bound_ms": sum(bounds),
    }
    log(json.dumps({"kernel": "kmeans_assign", **row, "bytes": nbytes, "flops": flops,
                    "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops, "card": card}))
    return row


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.apriori import (
        LocalMineResult,
        TransactionDB,
        apriori_join,
        item_supports,
        pack_itemsets,
    )
    from repro_torch.core import kmeans as tkm
    from repro_torch.core import vclustering as tvc
    from repro_torch.core.gfm import CommLog, topdown_search
    from repro_torch.data.synthetic import ibm_transactions, split_transactions
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.runtime import GridRuntime
    from repro_torch.workflow.registry import comm_digest, get_workload

    check("jax" not in sys.modules, "the port imported jax")
    check(not any(m == "repro" or m.startswith("repro.") for m in sys.modules), "the port imported repro")
    dev = torch.device(DEVICE)

    # ---- phase 1: setup ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    props = torch.cuda.get_device_properties(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} sms {props.multi_processor_count}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build_s: {time.perf_counter() - t0:.3f} ({', '.join(reports) or 'cached'})")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    dense = ibm_transactions(seed=0, n_tx=N_TX, n_items=N_ITEMS)
    parts = split_transactions(dense, N_SITES, seed=0)
    sites = [TransactionDB.from_dense(p, device=dev) for p in parts]
    log(f"data_s: {time.perf_counter() - t0:.3f} sites {[db.n_tx for db in sites]}")

    # ---- phase 2: every kernel against its plain version on the card ------
    gen = torch.Generator().manual_seed(0)

    def words(shape):
        a = torch.randint(-(2**31), 2**31, shape, generator=gen, dtype=torch.int64)
        b = torch.randint(-(2**31), 2**31, shape, generator=gen, dtype=torch.int64)
        return (a | b).to(torch.int32).to(dev)

    def masks_of(s, c, w, n_zero=2):
        out = np.zeros((s, c, w), dtype=np.uint32)
        rng = np.random.default_rng(s * 1000 + c + w)
        for i in range(s):
            for j in range(c):
                its = rng.choice(32 * w, size=rng.integers(1, 4), replace=False)
                out[i, j] = pack_itemsets([tuple(sorted(its))], 32 * w)[0]
        out[:, :n_zero] = 0  # all-zero masks count every row
        return torch.from_numpy(out.view(np.int32)).to(dev)

    def hold(tx, masks, mc, label):
        """All four wrappers against the plain versions, exact equality."""
        want = ref.support_count_sites_ref(tx, masks)
        got = ops.support_count_sites(tx, masks)
        pc, pf = ops.support_count_prune_sites(tx, masks, mc)
        one = ops.support_count(tx[0].contiguous(), masks[0].contiguous())
        oc, of = ops.support_count_prune(tx[0].contiguous(), masks[0].contiguous(), int(mc[0]))
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{label}: support_count_sites differs from the plain version")
        check(torch.equal(pc, want), f"{label}: support_count_prune_sites counts differ")
        check(torch.equal(pf, want >= mc[:, None]), f"{label}: support_count_prune_sites flags differ")
        check(torch.equal(one, want[0]), f"{label}: support_count differs")
        check(torch.equal(oc, want[0]) and torch.equal(of, want[0] >= mc[0]), f"{label}: support_count_prune differs")
        log(f"kernel check {label}: exact ({tuple(tx.shape)} x {tuple(masks.shape)})")

    for s, n, c, w in [(1, 700, 37, 1), (1, 700, 37, 32), (4, 700, 37, 32), (4, 700, 37, 3),
                       (1, 0, 5, 2), (1, 50, 0, 2), (2, 1, 1, 1)]:
        mc = torch.tensor([1 + 150 * i for i in range(s)], dtype=torch.int32, device=dev)
        hold(words((s, n, w)), masks_of(s, c, w), mc, f"S{s}-N{n}-C{c}-W{w}")

    def bound(tx, masks, out_bytes):
        """The least time one call on these inputs could take: the bytes it
        must move (tx and masks read once, outputs written once) over the
        HBM rate, or the word tests this data needs over the int32 rate (a
        zero mask word always matches, so only non-zero words count)."""
        needed_ops = tx.shape[1] * int((masks != 0).sum())
        t_bytes = ((tx.numel() + masks.numel()) * 4 + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = needed_ops / INT32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes"), needed_ops

    def measure(name, tx, masks, mc, label):
        """One kernel's site form and its plain version, timed on the same
        inputs; the row printed, checked and returned."""
        s, n, w = tx.shape
        c = masks.shape[1]
        if name == "support_count":
            kfn = lambda: ops.support_count_sites(tx, masks)  # noqa: E731
            pfn = lambda: ref.support_count_sites_ref(tx, masks)  # noqa: E731
            out_bytes = s * c * 4
        else:
            kfn = lambda: ops.support_count_prune_sites(tx, masks, mc)  # noqa: E731
            pfn = lambda: ref.support_count_prune_sites_ref(tx, masks, mc)  # noqa: E731
            out_bytes = s * c * 4 + s * c + s * 4  # counts, flags, thresholds
        got, want = kfn(), pfn()
        if name == "support_count":
            got, want = (got,), (want,)
        err = max(int((g.long() - x.long()).abs().max()) for g, x in zip(got, want))
        k_ms = median_ms(kfn, reps=30)
        p_ms = median_ms(pfn, reps=5, warmup=1)
        b_ms, b_by, needed_ops = bound(tx, masks, out_bytes)
        row = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        log(json.dumps({
            "kernel": name, "at": label, "shape": {"S": s, "N": n, "C": c, "W": w}, **row,
            "needed_word_tests": needed_ops, "dense_word_tests": s * n * c * w,
            "dense_ops_bound_ms": s * n * c * w / INT32_OPS_PER_S * 1e3, "card": card,
        }))
        check(err == 0, f"{name} at {label}: kernel differs from its plain version")
        return dict(row, at=label, shape={"S": s, "N": n, "C": c, "W": w}, dense=s * n * c * w)

    # a fixed level-2 shape: the sites' own packed words (padded to one N,
    # as fused_count_sites pads them) and C real level-2 candidates each
    n_max = max(db.n_tx for db in sites)
    w = sites[0].packed.shape[1]
    tx_l2 = torch.zeros((N_SITES, n_max, w), dtype=torch.int32, device=dev)
    masks_np = np.zeros((N_SITES, MAIN_C, w), dtype=np.uint32)
    rng = np.random.default_rng(1)
    for i, db in enumerate(sites):
        tx_l2[i, : db.n_tx] = db.packed
        l1 = [(int(j),) for j in np.nonzero(item_supports(db) >= int(np.ceil(MINSUP * db.n_tx)))[0]]
        cands = apriori_join(l1)[:MAIN_C]
        while len(cands) < MAIN_C:  # top up with random pairs
            cands.append(tuple(sorted(int(x) for x in rng.choice(N_ITEMS, size=2, replace=False))))
        masks_np[i] = pack_itemsets(cands, N_ITEMS)
    masks_l2 = torch.from_numpy(masks_np.view(np.int32)).to(dev)
    mc_sites = torch.tensor([int(np.ceil(MINSUP * db.n_tx)) for db in sites], dtype=torch.int32, device=dev)
    label = f"level 2, C={MAIN_C}"
    hold(tx_l2, masks_l2, mc_sites, label)
    for name in ("support_count", "support_count_prune"):
        measure(name, tx_l2, masks_l2, mc_sites, label)
    del tx_l2, masks_l2

    # the top-down descent's counting rounds (single-site support_count on
    # every site), which GFM's own pool never needs: a hand-built state in
    # which every triple and pair fails, counted by the kernel and by the
    # plain path, and recounted from the dense data
    def descend(backend):
        decided = {(0, 1, 2): (0, False), (3, 4, 5): (0, False)}
        local = [LocalMineResult(counts={}, frequent={}, count_calls=0, candidates_counted=0)
                 for _ in sites]
        comm, sizes = CommLog(), []
        topdown_search(sites, local, decided, N_TX + 1, comm, K, backend, sizes)
        return decided, comm_digest(comm), sizes

    ops.reset_launches()
    descent = descend("kernel")
    check(ops.LAUNCHES["support_count"] == 2 * N_SITES, f"descent launches {dict(ops.LAUNCHES)}")
    check(descent == descend("torch"), "top-down descent differs between the kernel and plain paths")
    for its, (c, _) in descent[0].items():
        if len(its) < 3:
            check(c == int(np.all(dense[:, list(its)], axis=1).sum()), f"descent count of {its}")
    log(f"top-down descent: kernel == plain == recount, pool sizes {descent[2]}, "
        f"rounds {descent[1]['rounds']}")

    # ---- phase 3: the main path -------------------------------------------
    params = {"k": K, "minsup": MINSUP}
    digest = get_workload("gfm").digest

    ops.reset_launches()
    t0 = time.perf_counter()
    run = GridRuntime(device=dev).run("gfm", sites, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = dict(ops.LAUNCHES)
    log(f"main path (batched, staged, kernel): {wall:.3f} s host wall, launches {main_launches}")
    kernel_launches = {
        "support_count": main_launches["support_count"] + main_launches["support_count_sites"],
        "support_count_prune": main_launches["support_count_prune"] + main_launches["support_count_prune_sites"],
    }
    for name, n in kernel_launches.items():
        check(n > 0, f"the main path never launched {name}")
    res = run.result
    check(res.comm.rounds == 2, f"GFM took {res.comm.rounds} rounds, want 2")
    sizes = np.bincount([len(i) for i in res.frequent]).tolist()
    log(f"frequent itemsets: {len(res.frequent)}, by size {dict(enumerate(sizes))}")
    log("measured job s: " + json.dumps({k: round(v, 6) for k, v in sorted(run.measured.items())}))
    log(f"report: wall_s {run.report.wall_s:.3f} compute_s {run.report.compute_s:.6f} "
        f"overhead_pct {run.report.overhead_pct():.3f} pool_sizes {res.pool_sizes}")

    # every reported count, recounted independently on the host from the
    # dense data; and the result is no toy
    g_min = int(np.ceil(MINSUP * N_TX))
    for its, c in res.frequent.items():
        got = int(np.all(dense[:, list(its)], axis=1).sum())
        check(got == c and c >= g_min, f"itemset {its}: reported {c}, recount {got}, g_min {g_min}")
    singles = int((dense.sum(axis=0) >= g_min).sum())
    check(sum(len(i) == 1 for i in res.frequent) == singles, "frequent singletons differ from a recount")
    check(len(res.frequent) > singles, "no frequent itemset beyond singletons")
    log(f"recount: all {len(res.frequent)} counts agree with the dense data")

    want_digest = digest(res)
    plain = GridRuntime(device=dev, count_backend="torch").run("gfm", sites, params)
    check(digest(plain.result) == want_digest, "digest differs between the kernel and plain paths")
    ops.reset_launches()
    inline = GridRuntime(device=dev, backend="inline", schedule="async").run("gfm", sites, params)
    torch.cuda.synchronize()
    log(f"inline+async (kernel) launches {dict(ops.LAUNCHES)}")
    check(digest(inline.result) == want_digest, "digest differs between batched+staged and inline+async")
    log("digests: kernel == plain, batched+staged == inline+async")

    profile_main_path(lambda: GridRuntime(device=dev).run("gfm", sites, params))

    # ---- phase 4: every kernel at the main path's own inputs --------------
    # one more batched + staged run records the inputs of each site-form
    # launch (levels 2..K of the local Apriori, then the recount); each is
    # held against the plain versions and timed
    calls = record_launch_inputs(ops, lambda: GridRuntime(device=dev).run("gfm", sites, params))
    rows = {"support_count": [], "support_count_prune": []}
    for j, (tx, masks, mc) in enumerate(calls["support_count_prune_sites"]):
        label = f"main path, level {j + 2}"
        hold(tx, masks, mc, label)
        rows["support_count_prune"].append(measure("support_count_prune", tx, masks, mc, label))
    for tx, masks in calls["support_count_sites"]:
        label = "main path, recount"
        hold(tx, masks, mc_sites[: tx.shape[0]], label)
        rows["support_count"].append(measure("support_count", tx, masks, None, label))
    for name, wrapper in [("support_count", "support_count_sites"),
                          ("support_count_prune", "support_count_prune_sites")]:
        check(len(rows[name]) == main_launches[wrapper],
              f"{wrapper}: {len(rows[name])} recorded calls, {main_launches[wrapper]} launches on the main path")

    kmeans_row = run_clustering(dev, card, ops, ref, tkm, tvc, GridRuntime)

    kernels = []
    for name, replaces in [
        ("support_count", "src/repro/kernels/support_count.py:51"),
        ("support_count_prune", "src/repro/kernels/support_count.py:134"),
    ]:
        # the times of the path's largest launch of this kernel, and the
        # sums over all of its launches on the path
        top = max(rows[name], key=lambda r: r["dense"])
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/support_count.cu",
            "replaces": replaces, "launches": kernel_launches[name],
            **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "at", "shape")},
            "path_ms": sum(r["ms"] for r in rows[name]),
            "path_plain_ms": sum(r["plain_ms"] for r in rows[name]),
            "path_bound_ms": sum(r["bound_ms"] for r in rows[name]),
        })
    kernels.append(kmeans_row)
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
