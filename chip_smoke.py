"""Chip smoke for the PyTorch port: build the CUDA kernels, hold each one
against its plain PyTorch version on the card, then run each ported path
end to end through the entry points a user calls:

  * GFM (Algorithm 2) at the IBM Quest T10I4D100K shape over 4 sites;
    on the same data, FDM and count-distribution Apriori, the delta path
    (the stream appended in 4 batches, a query after each, then the top
    20 itemsets) and four requests of each miner fused by ``run_many``;
  * vclustering (Algorithm 1) at the paper's Table 3 size: 5e7 points in
    8 dimensions over 200 sites, 20 sub-clusters a site, 20 Lloyd
    iterations; then seeds 0 and 1 fused by ``run_many`` (400 sites a
    launch);
  * xlstm-1.3b serving at its published widths: a prefill of 8 prompts of
    4,096 tokens through the sLSTM kernel, then 64 greedy decode steps;
  * gemma2-2b at its published widths: scoring 4 sequences of 8,192 tokens
    (the mean next-token CE) through the bfloat16 flash attention kernel on
    the tensor cores (its float32 checks through the CUDA-core one), then
    serving a prefill of 8,160 tokens and 32 greedy decode steps;
  * the multi-tenant mining service (``MiningService``) on the T10I4D100K
    stream and the Table 3 points: a 3-tenant trace of every itemset app,
    kmeans and vclustering, with cross-request fusion and then without,
    its results held to the paths' own runs above;
  * multi-host execution (``MultiHostBackend`` over gloo): a group of 2
    ranks shipping each ready wave in one collective (the three miners at
    T10I4D100K, vclustering at Table 3) and one of 3 ranks shipping once
    a job (the three miners), every rank on the one card and held to the
    single-process runs above; each rank is this script run again with
    ``--multihost-child``, which prints one report line and never the
    final line.

    python3 chip_smoke.py

For each path it then breaks the run down (device busy time and kernels
by torch.profiler, host functions by cProfile, and for clustering each
phase on its own), records the inputs of every kernel launch of one more
run, and holds and times each kernel at those inputs; for the sLSTM
kernel it also prints where a step goes, from its timed build.  Needs one CUDA card
and ``nvcc``; exits non-zero without them, or when any check fails.
Imports the port only (``src/repro_torch``), never jax and never the JAX
package.  The last line of standard output is ``{"ok": true, "device":
{...}}``; the line before it is the card's name and power limit, and the
one before that lists every kernel with its launches on its path (and,
under ``launches_by_path``, on every other path that runs it) and, at
the path's largest launch of it, its time, its plain version's time, its
bound and the nearest library call's time.
"""

from __future__ import annotations

import bisect
import ctypes
import hashlib
import json
import os
import re
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
BOOST_HZ = 1.98e9
FP32_LANES_PER_SM = 128

# the main path: IBM Quest T10I4D100K (100,000 transactions, 1,000 items,
# average length 10, pattern length 4), over 4 grid sites
N_TX, N_ITEMS, N_SITES, K, MINSUP = 100_000, 1000, 4, 4, 0.01
MAIN_C = 2048  # candidates per site at the fixed level-2 kernel shape
# the itemset family's other paths, on the same data (phases 17-19): FDM and
# count distribution; the delta path (the stream appended in 4 batches of
# 25,000, a query after each, then the top 20 itemsets of up to 3 items);
# and four requests fused by run_many for each miner
DELTA_BATCHES, TOPK_K, TOPK_TOP = 4, 3, 20
FUSE_MINSUPS = (0.01, 0.0125, 0.015, 0.02)
DEVICE = "cuda"

# the clustering path: the paper's Table 3 V-Clustering row (5e7 samples over
# 200 processes, 20 sub-clusters each; benchmarks/bench_clustering.py:1-9),
# at the repo's dimension D = 8, over a 12-component Gaussian mixture
CL_POINTS, CL_DIM, CL_SITES, CL_COMPONENTS = 50_000_000, 8, 200, 12
CL_PARAMS = {"k_local": 20, "iters": 20, "seed": 0}
CL_PURITY = 0.99  # share of points in the majority planted component of their global cluster
CL_PLAIN_AGREE = 0.999  # share of points the plain path labels alike, up to renaming
CL_FUSE_SEEDS = (0, 1)  # phase 20: two requests fused by run_many
# kernel vs plain: assignments must match wherever the plain best and second
# best d² differ by more than TIE_RTOL * (|x|^2 + max |c|^2); min d² within
# MIND2_RTOL plus 8 float32 roundings of that scale
TIE_RTOL, MIND2_RTOL = 1e-6, 1e-6

# phase 21: the mining service (launch.serve) on both paths' data, 3 tenants.
# "tx" gets T10I4D100K in appends of 25,000 rows (two before the trace, so it
# starts at version 2, and one before each of its last two stages); "pts" the
# Table 3 points (version 1), then SV_EXTRA_POINTS more from the same mixture
# (another seed) after the vclustering requests, so that the second kmeans
# request warm-starts.  Each stage of the trace is the CLI's burst generator
# (launch.serve._trace_bursts) over a pool at the paths' own params.  A
# second mixed stage, at tx version 3, is cut: with it the phase took 213 s
# on an H100 80GB HBM3 at 700 W, against the 150 s it is given.
SV_TENANTS, SV_BURST, SV_MAX_PER_STEP, SV_SEED = 3, 4, 8, 0
SV_MIXED_REQUESTS = 12  # the mixed stage (tx version 2)
SV_APP_REQUESTS = 12  # each single-app stage at tx version 4
SV_EXTRA_POINTS, SV_EXTRA_SEED = 1_000_000, 8
SV_KMEANS = {"k": 12, "iters": 20}
SV_APRIORI_MINSUPS = (0.01, 0.02)

# the serving path: xlstm-1.3b at its published widths (48 layers, 6 of them
# sLSTM), 8 prompts of 4,096 tokens (the repo's train_4k length), then 64
# greedy decode steps
XL_BATCH, XL_PROMPT, XL_DECODE = 8, 4096, 64
PARITY_TOL = 3e-2  # tests/test_models_smoke.py's prefill/decode tolerance
# sLSTM kernel vs plain: float32 outputs within 1e-4 of the value plus 1e-5
# (gate sums over P in another order, carried through the recurrence);
# bfloat16 outputs within one bf16 ulp of the value (2^-7 relative)
SLSTM_F32_RTOL, SLSTM_BF16_RTOL, SLSTM_ATOL = 1e-4, 2.0**-7, 1e-5

# the scoring and serving path: gemma2-2b at its published widths (26 layers,
# 13 of them within a 4,096-token window).  Scoring: 4 sequences of 8,192
# tokens (Gemma 2's context length, twice the window) through the flash
# kernel; serving: a prefill of the first 8,160 tokens (not a multiple of the
# oracle's 1,024 chunk) into a cache of 8,192, then 32 greedy decode steps
GM_BATCH, GM_SEQ, GM_PROMPT, GM_DECODE = 4, 8192, 8160, 32
GM_LOSS_CHUNK = 512
FLASH_LAUNCHES = 26  # one a layer in a scoring forward
# flash kernel vs plain: float32 within 1e-5 relative plus 1e-6 (the dot
# products sum in another order); bfloat16 within one bf16 ulp (2^-7) of the
# value plus one of the |v|-weighted mean, plus 1e-6: p rounds to bf16 for
# PV, and where the two float32 p straddle a bf16 rounding point the two
# round it to neighbouring values, moving the output by up to 2^-7·p·|v|/l
FLASH_F32_RTOL, FLASH_BF16_RTOL, FLASH_ATOL = 1e-5, 2.0**-7, 1e-6
# flash on against off in float32 at full width: the CE within 1e-3 (the
# tolerance of tests/test_models_smoke.py:155) and the hidden states within
# 1e-3 normwise.  Elementwise 1e-3 holds at the smoke test's 4 layers and 32
# tokens but not at 26 layers and 8,192 tokens: a near-uniform attention row
# averages 8,192 values to ~1/90 of their size, the post-norm scales it back,
# and float32 summation-order differences grow through the depth (the oracle
# against itself at another chunk, reported beside it, shows the same spread)
SMOKE_FLASH_TOL = 1e-3
BF16_TC_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak
# the special-function units: 16 results a clock per SM, 132 SMs, at the
# 1,980 MHz boost clock (the exp and tanh floor, a second bound)
SFU_OPS_PER_S = 132 * 16 * 1.98e9


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


SPIN_CYCLES = 20_000_000  # ~10 ms of a spin kernel at the boost clock
PTXAS: dict = {}  # ptxas_report of each source built by this run


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call.
    A spin kernel holds the card first while the host enqueues every call
    back to back, so each event pair brackets one call's device work and
    not the host's launch overhead (which exceeds the device work of a
    small call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for a, b in zip(starts, ends):
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(starts, ends))


def ptxas_report(text: str) -> dict:
    """{kernel entry (mangled): {"registers", "spill_stores", "spill_loads"}}
    from one source's ``-Xptxas -v`` log."""
    out, entry = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            out[entry] = {}
        elif entry and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[entry].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            out[entry]["registers"] = int(m[1])
    return out


def kmeans_bound(px, pc):
    """(bytes bound ms, operations bound ms, bytes, flops) of one K-Means
    launch: points and centres read once, assignment and min d² written
    once; 2·K·D flops a point."""
    s, n, d = px.shape
    nbytes = (px.numel() + pc.numel()) * 4 + s * n * 8
    flops = 2 * s * n * pc.shape[1] * d
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3, nbytes, flops


def kmeans_issue_floor_ms(s: int, n: int, k: int, d: int, sms: int, hz: float = BOOST_HZ) -> float:
    """The issue floor of one K-Means launch in the plain version's order:
    2D + 5 instructions a (point, centre) pair (D FMUL, D - 1 FADD,
    |x|² + |c|², 2·dot, the subtraction, the compare and its two selects)
    at 128 lanes a clock on every SM."""
    return s * n * k * (2 * d + 5) / (sms * FP32_LANES_PER_SM * hz) * 1e3


def gfm_sites(dev):
    """The GFM main path's data: T10I4D100K (seed 0) as a dense 0/1 array,
    and split over N_SITES sites as packed ``TransactionDB``s on ``dev``."""
    from repro_torch.core.apriori import TransactionDB
    from repro_torch.data.synthetic import ibm_transactions, split_transactions

    dense = ibm_transactions(seed=0, n_tx=N_TX, n_items=N_ITEMS)
    parts = split_transactions(dense, N_SITES, seed=0)
    return dense, [TransactionDB.from_dense(p, device=dev) for p in parts]


def profile_main_path(run_once, path: str = "gfm", phases=(), kernel: str = "", n_host: int = 15) -> dict:
    """Where the main path's time goes: the device's busy time and kernel
    breakdown from torch.profiler, and the host's top functions from
    cProfile (each over its own run, so neither pays the other's cost).

    ``phases`` names port functions, as (module, attribute, label), to
    wrap during the traced run only: each call becomes a record_function
    window that ends in a synchronize, and its row gives the window's host
    wall and the device time of the kernels that started inside it.
    ``kernel`` names a device kernel (a substring of its name) whose share
    of the device's busy time the row also gives.  ``n_host`` host functions
    are logged.  Returns the row."""
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
    if kernel:
        k_ms = sum(ms for name, (ms, _) in by_name.items() if kernel in name)
        out["kernel"] = {"name": kernel, "device_ms": k_ms,
                         "calls": sum(n for name, (_, n) in by_name.items() if kernel in name),
                         "share_of_device_busy": k_ms / busy_ms if busy_ms > 0 else None}
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
        {"fn": name, "cum_s": cum, "self_s": tot, "calls": n} for cum, tot, n, name in rows[:n_host]
    ]}))
    return out


SITE_FORMS = ("support_count_sites", "support_count_prune_sites")
SUPPORT_WRAPPERS = ("support_count", "support_count_prune") + SITE_FORMS


def record_launch_inputs(ops, run_once) -> dict:
    """The inputs of every launch of the support-count wrappers during one
    call of ``run_once``: the wrappers are wrapped, for that call only, by
    ones that keep a copy of their arguments and then call them."""
    calls = {name: [] for name in SUPPORT_WRAPPERS}
    real = {name: getattr(ops, name) for name in SUPPORT_WRAPPERS}

    def recorder(name):
        def fn(*args):
            tx, masks = args[:2]
            dims = (tx.shape[0], tx.shape[1], masks.shape[1]) if name in SITE_FORMS else (tx.shape[0], masks.shape[0])
            if all(d > 0 for d in dims):
                calls[name].append(tuple(torch.as_tensor(a).clone() for a in args))
            return real[name](*args)
        return fn

    for name in SUPPORT_WRAPPERS:
        setattr(ops, name, recorder(name))
    try:
        run_once()
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    return calls


def recorded_launches(calls: dict):
    """Every launch that ``record_launch_inputs`` recorded, in site form:
    (wrapper, tx (S, N, W), masks (S, C, W), min_counts (S,) int32 or None)."""
    for name in SUPPORT_WRAPPERS:
        for args in calls[name]:
            tx, masks = args[:2]
            if name not in SITE_FORMS:
                tx, masks = tx[None], masks[None]
            mc = args[2].reshape(-1).to(device=tx.device, dtype=torch.int32) if len(args) > 2 else None
            yield name, tx, masks, mc


POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def dense_columns(dense: np.ndarray) -> np.ndarray:
    """The dense 0/1 transactions as packed bit columns, (items, ceil(N/8))
    uint8: the recounts below AND an itemset's columns and count the bits,
    in numpy alone (independent of the code under test)."""
    return np.ascontiguousarray(np.packbits(dense.astype(bool), axis=0).T)


def recount(cols: np.ndarray, its) -> int:
    return int(POPCOUNT8[np.bitwise_and.reduce(cols[list(its)], axis=0)].sum())


def kernel_launches_of(launches: dict) -> dict:
    """Launches of each support-count kernel, its single-DB and site forms together."""
    return {"support_count": launches["support_count"] + launches["support_count_sites"],
            "support_count_prune": launches["support_count_prune"] + launches["support_count_prune_sites"]}


def hold_support_launches(windows, hold, dev) -> tuple:
    """Every launch recorded in ``windows`` ((label, recorded calls) pairs)
    held exactly against the plain versions by ``hold``: all four wrappers
    and the transpose, on the launch's own inputs (a count with no
    threshold is held with minsup's).  Returns (launches held, the largest
    launch of each kernel in site form, for ``time_largest_launches``)."""
    n_held, largest = 0, {}
    for label, calls in windows:
        for name, tx, masks, mc in recorded_launches(calls):
            n_held += 1
            at = f"{label}, {name} launch {n_held}"
            s_, n_, w_ = tx.shape
            thr = mc if mc is not None else torch.full((s_,), int(np.ceil(MINSUP * n_)), dtype=torch.int32,
                                                       device=dev)
            hold(tx, masks, thr, at)
            kernel = "support_count" if mc is None else "support_count_prune"
            size = s_ * n_ * masks.shape[1] * w_
            if size > largest.get(kernel, (0,))[0]:
                largest[kernel] = (size, tx, masks, mc, at)
    return n_held, largest


def time_largest_launches(largest: dict, measure) -> dict:
    """The largest launch of each kernel timed beside its plain version
    (``measure``, which logs the row)."""
    return {kernel: {k: row[k] for k in ("at", "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for kernel, (_, tx, masks, mc, at) in largest.items()
            for row in [measure(kernel, tx, masks, mc, at)]}


def run_itemset_family(dev, card, ops, dense, sites, gfm_res, hold, measure, bound, GridRuntime) -> tuple:
    """Phases 17-19, on the GFM phases' data: FDM and count distribution
    through ``GridRuntime.run``; the delta path (``DeltaApriori`` and
    ``topk_itemsets``); and ``run_many`` of four requests for each miner.
    Returns the support-count kernels' launches on each of these paths, and
    what phase 21 holds the service to: the digests of phase 19's serial
    runs by (app, minsup), the delta path's query at each version and its
    top-k; and under "grid" phase 17's digests, which phase 22 holds the
    multi-host runs to."""
    from repro_torch.core.apriori import DeltaApriori, TransactionDB, bruteforce_frequent, local_apriori, topk_itemsets
    from repro_torch.workflow.registry import get_workload

    params = {"k": K, "minsup": MINSUP}
    cols = dense_columns(dense)
    by_path, grid = {}, {}

    def recorded(fn) -> tuple:
        """(fn(), the inputs of every support-count launch during it)."""
        out = []
        calls = record_launch_inputs(ops, lambda: out.append(fn()))
        return out[0], calls

    def hold_all(windows) -> tuple:
        return hold_support_launches(windows, hold, dev)

    def time_largest(largest: dict) -> dict:
        return time_largest_launches(largest, measure)

    # ---- phase 17: FDM and count distribution at T10I4D100K ----------------
    for app in ("fdm", "cd_apriori"):
        digest = get_workload(app).digest
        ops.reset_launches()
        t0 = time.perf_counter()
        run = GridRuntime(device=dev).run(app, sites, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: ops.LAUNCHES[name] for name in SUPPORT_WRAPPERS}
        by_path[app] = kernel_launches_of(launches)
        res = run.result
        levels = sum(1 for c in res.per_level_candidates if c)
        log(f"{app} main path (batched, staged, kernel): {wall:.3f} s host wall, launches {launches}; rounds "
            f"{res.comm.rounds} (GFM {gfm_res.comm.rounds}), count_calls {res.comm.count_calls}, candidates a level "
            f"{res.per_level_candidates}, frequent itemsets {len(res.frequent)}")
        check(launches["support_count_sites"] > 0, f"{app}: the batched path never launched support_count_sites")
        check(res.comm.rounds == levels, f"{app}: {res.comm.rounds} rounds over {levels} levels")
        check(res.frequent == gfm_res.frequent, f"{app}: the frequent itemsets differ from GFM's (phase 3)")
        bad = [its for its, c in res.frequent.items() if recount(cols, its) != c]
        check(not bad, f"{app}: counts differ from the dense recount, e.g. {bad[:3]}")
        if app == "fdm":
            log(f"fdm remote support: {res.remote_count_time:.6f} s of {res.total_count_time:.6f} s of counting "
                f"({res.remote_count_time / res.total_count_time:.4f}; the paper measures about 0.13)")
        want = grid[app] = digest(res)
        plain = GridRuntime(device=dev, count_backend="torch").run(app, sites, params)
        check(digest(plain.result) == want, f"{app}: digest differs between the kernel and plain paths")
        ops.reset_launches()
        inline, inline_calls = recorded(
            lambda: GridRuntime(device=dev, backend="inline", schedule="async").run(app, sites, params))
        torch.cuda.synchronize()
        inline_launches = {name: ops.LAUNCHES[name] for name in SUPPORT_WRAPPERS}
        check(inline_launches["support_count"] > 0 and not any(inline_launches[n] for n in SITE_FORMS),
              f"{app}: inline+async launched {inline_launches}")
        check(all(len(inline_calls[n]) == inline_launches[n] for n in SUPPORT_WRAPPERS),
              f"{app}: recorded {[len(inline_calls[n]) for n in SUPPORT_WRAPPERS]} calls, launched {inline_launches}")
        check(digest(inline.result) == want, f"{app}: digest differs between batched+staged and inline+async")
        n_held, _ = hold_all([(f"{app} inline+async", inline_calls)])
        del inline_calls
        log(f"{app} inline+async (kernel) launches {inline_launches}; all {n_held} single-DB launches held exactly")
        log(f"{app}: recount of all {len(res.frequent)} counts agrees; frequent == GFM's; kernel == plain; "
            f"batched+staged == inline+async")

        # every launch of one more batched run, held against the plain
        # versions and timed; the plain version timed at the largest
        calls = record_launch_inputs(ops, lambda: GridRuntime(device=dev).run(app, sites, params))
        check(all(len(calls[name]) == launches[name] for name in SUPPORT_WRAPPERS),
              f"{app}: recorded {[len(calls[n]) for n in SUPPORT_WRAPPERS]} calls, launched {launches}")
        rows = []
        for j, (tx, masks) in enumerate(calls["support_count_sites"]):
            mc = torch.tensor([int(np.ceil(MINSUP * db.n_tx)) for db in sites[: tx.shape[0]]],
                              dtype=torch.int32, device=dev)
            hold(tx, masks, mc, f"{app}, launch {j + 1}")
            s_, n_, w_ = tx.shape
            c_ = masks.shape[1]
            rows.append({"S": s_, "N": n_, "C": c_, "ms": median_ms(lambda: ops.support_count_sites(tx, masks), reps=30),
                         "bound_ms": bound(tx, masks, s_ * c_ * 4)[0], "dense": s_ * n_ * c_ * w_})
        top = max(range(len(rows)), key=lambda r: rows[r]["dense"])
        largest = measure("support_count", *calls["support_count_sites"][top], None, f"{app}, launch {top + 1}")
        log(json.dumps({"path": app, "support_count_sites_launches": rows, "path_ms": sum(r["ms"] for r in rows),
                        "path_bound_ms": sum(r["bound_ms"] for r in rows), "largest_plain_ms": largest["plain_ms"],
                        "card": card}))
        del calls
    profile_main_path(lambda: GridRuntime(device=dev).run("fdm", sites, params), path="fdm")

    # ---- phase 18: the delta path --------------------------------------------
    # the stream appended in batches; after each append a query at minsup,
    # held to from-scratch mining (the plain backend) of everything appended
    # so far; a repeat query launches nothing; then the top TOPK_TOP
    # itemsets.  Every launch's inputs are recorded, and each is held
    # against the plain versions once the path has run
    delta = DeltaApriori(N_ITEMS, backend="kernel", device=dev)
    n_batch = N_TX // DELTA_BATCHES
    delta_launches = dict.fromkeys(SUPPORT_WRAPPERS, 0)
    windows, queries = [], {}

    def step(label, fn):
        """(fn(), host wall s, launches, recorded calls): ``fn`` run with its
        launches counted and their inputs recorded (the wall includes the
        recording's device copies)."""
        ops.reset_launches()
        t0 = time.perf_counter()
        out, calls = recorded(fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {name: ops.LAUNCHES[name] for name in SUPPORT_WRAPPERS}
        check(all(len(calls[n]) == launched[n] for n in SUPPORT_WRAPPERS),
              f"{label}: recorded {[len(calls[n]) for n in SUPPORT_WRAPPERS]} calls, launched {launched}")
        for name in SUPPORT_WRAPPERS:
            delta_launches[name] += launched[name]
        windows.append((label, calls))
        return out, wall, launched, calls

    for b in range(DELTA_BATCHES):
        batch = dense[b * n_batch:(b + 1) * n_batch]
        _, append_s, append_launches, appended = step(f"delta append {b + 1}", lambda: delta.append(batch))
        seen = [(tuple(tx.shape), tuple(masks.shape)) for _, tx, masks, _ in recorded_launches(appended)]
        check(len(seen) == (1 if b else 0) and all(tx[1] == n_batch for tx, _ in seen),
              f"append {b + 1}: count launches over {seen}, want one over the {n_batch} new rows after the first")
        mc = int(np.ceil(MINSUP * delta.n_tx))
        q, query_s, query_launches, _ = step(f"delta query, version {delta.version}", lambda: delta.query(K, mc))
        queries[delta.version] = q
        scratch = local_apriori(TransactionDB.from_dense(dense[: (b + 1) * n_batch], device=dev), K, mc,
                                backend="torch")
        check(q.counts == scratch.counts and q.frequent == scratch.frequent
              and q.candidates_counted == scratch.candidates_counted,
              f"delta query at version {delta.version} differs from mining {delta.n_tx} transactions from scratch")
        ops.reset_launches()
        again = delta.query(K, mc)
        check(not any(ops.LAUNCHES.values()) and again.count_calls == 0 and again.counts == q.counts,
              f"a repeat query at version {delta.version} launched {dict(ops.LAUNCHES)}")
        log(f"delta version {delta.version}: {delta.n_tx} transactions; append {append_s:.3f} s, launches "
            f"{append_launches}, count launches {seen}; query (min_count {mc}) {query_s:.3f} s, count_calls "
            f"{q.count_calls}, launches {query_launches}; == from-scratch mining (plain backend); a repeat query: "
            f"0 launches")
    final = {its: q.counts[its] for lv in q.frequent for its in q.frequent[lv]}
    check(final == gfm_res.frequent, "the delta path's last query differs from GFM's frequent itemsets")
    top, topk_s, topk_launches, _ = step("delta top-k", lambda: topk_itemsets(delta, TOPK_K, TOPK_TOP))
    ranked = sorted(bruteforce_frequent(dense, TOPK_K, top.threshold).items(), key=lambda ic: (-ic[1], len(ic[0]), ic[0]))
    check(top.items == ranked[:TOPK_TOP], "top-k differs from the brute-force ranking at its threshold")
    log(f"delta top-{TOPK_TOP} (k {TOPK_K}): {topk_s:.3f} s, threshold {top.threshold}, count_calls "
        f"{top.count_calls}, launches {topk_launches}; == brute force; first {top.items[:3]}")
    log(f"delta path launches in all: {delta_launches}")
    check(delta_launches["support_count"] > 0 and delta_launches["support_count_prune"] > 0,
          f"the delta path launched {delta_launches}")
    by_path["delta"] = kernel_launches_of(delta_launches)
    n_held, largest = hold_all(windows)
    del windows
    check(n_held == sum(delta_launches.values()), f"the delta path: {n_held} launches held of {delta_launches}")
    log(json.dumps({"path": "delta", "launches_held_exactly": n_held, "largest": time_largest(largest), "card": card}))
    del largest

    # ---- phase 19: four requests fused by run_many, for each miner ----------
    reqs = [{"k": K, "minsup": m} for m in FUSE_MINSUPS]
    miners = {}
    for app in ("gfm", "fdm", "cd_apriori"):
        digest = get_workload(app).digest
        ops.reset_launches()
        t0 = time.perf_counter()
        serial = [GridRuntime(device=dev).run(app, sites, p).result for p in reqs]
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t0
        serial_launches = {name: ops.LAUNCHES[name] for name in SUPPORT_WRAPPERS}
        ops.reset_launches()
        t0 = time.perf_counter()
        fused = GridRuntime(device=dev).run_many(app, [sites] * len(reqs), reqs)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        fused_launches = {name: ops.LAUNCHES[name] for name in SUPPORT_WRAPPERS}
        by_path[f"run_many {app}"] = kernel_launches_of(fused_launches)
        for p, want, got in zip(reqs, serial, fused):
            check(digest(got.result) == digest(want), f"run_many {app}, minsup {p['minsup']}: differs from its serial run")
            miners[(app, p["minsup"])] = digest(want)
        # one more fused run: every launch recorded, held against the plain
        # versions, and the largest of each kernel timed
        calls = record_launch_inputs(ops, lambda: GridRuntime(device=dev).run_many(app, [sites] * len(reqs), reqs))
        check(all(len(calls[n]) == fused_launches[n] for n in SUPPORT_WRAPPERS),
              f"run_many {app}: recorded {[len(calls[n]) for n in SUPPORT_WRAPPERS]} calls, launched {fused_launches}")
        widest = max((tx.shape[0] for name, tx, _, _ in recorded_launches(calls) if name in SITE_FORMS), default=0)
        n_held, largest = hold_all([(f"run_many {app}", calls)])
        del calls
        log(json.dumps({"path": f"run_many {app}", "launches_held_exactly": n_held, "largest": time_largest(largest),
                        "card": card}))
        del largest
        n_fused, n_serial = (sum(d[n] for n in SITE_FORMS) for d in (fused_launches, serial_launches))
        log(f"run_many {app} x{len(reqs)} (minsup {list(FUSE_MINSUPS)}): {fused_s:.3f} s host wall against "
            f"{serial_s:.3f} s serial; site-form launches {n_fused} fused, {n_serial} serial; widest launch "
            f"{widest} sites; compute_s {[round(f.compute_s, 6) for f in fused]}; digests == the serial runs'; "
            f"all {n_held} launches of one more fused run held exactly")
        check(n_fused < n_serial, f"run_many {app}: {n_fused} site-form launches, {n_serial} serial")
        check(widest == N_SITES * len(reqs), f"run_many {app}: the widest launch spans {widest} sites")
    return by_path, {"miners": miners, "delta": queries, "topk": top, "grid": grid}


def record_kmeans_launches(ops, run_once, wrappers=("kmeans_assign_sites",)) -> list:
    """The inputs of every launch of the K-Means ``wrappers`` during one
    call of ``run_once``, in site form (a single-site call's as S = 1).
    Every launch of a Lloyd run reads the same points tensor, so a points
    tensor is kept once (by storage) and each launch's centres are cloned."""
    calls, points = [], {}
    real = {name: getattr(ops, name) for name in wrappers}

    def recorder(name):
        def fn(xs, centers):
            if xs.shape[-2] > 0:
                key = (xs.data_ptr(), tuple(xs.shape))
                px = points.setdefault(key, xs if xs.dim() == 3 else xs[None])
                calls.append((px, centers.clone() if centers.dim() == 3 else centers[None].clone()))
            return real[name](xs, centers)
        return fn

    for name in wrappers:
        setattr(ops, name, recorder(name))
    try:
        run_once()
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    return calls


def clustering_points() -> tuple:
    """The clustering path's points on the host, (CL_SITES, n, CL_DIM)
    float32, the planted component of each site point, and the points
    before the split, (CL_POINTS, CL_DIM) (the service's dataset)."""
    from repro_torch.data.synthetic import gaussian_mixture, split_sites

    pts, comp = gaussian_mixture(7, CL_POINTS, CL_DIM, n_components=CL_COMPONENTS, spread=20.0, sigma=0.8)
    xs_np = split_sites(pts, CL_SITES, seed=1)
    # the planted component of every site point, from the permutation
    # split_sites draws (numpy only: independent of the code under test)
    truth = comp[np.random.default_rng(1).permutation(len(pts))[: xs_np.shape[0] * xs_np.shape[1]]]
    return xs_np, truth, pts


def hold_kmeans_launch(ops, ref, xs, cs, label):
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


def labels_digest(res) -> dict:
    """A vclustering result in a form that two runs are compared by: the
    SHA-256 of its label bytes, and its merge counts."""
    return {"labels_sha256": hashlib.sha256(res.labels.contiguous().cpu().numpy().tobytes()).hexdigest(),
            "n_global": int(res.merged.n_global), "n_merges": int(res.merged.n_merges)}


def run_clustering(dev, card, ops, ref, tkm, tvc, GridRuntime) -> tuple:
    """The clustering slice on the card: the K-Means kernel against its
    plain version, the main path at full size with its checks, its
    profile, and the kernel at the path's own inputs.  Returns the
    kernel's row of the ``kernels`` line, and what phase 21 holds the
    service to: the points before the split, and the digests of the
    seed 0 and seed 1 runs."""
    check(not torch.backends.cuda.matmul.allow_tf32, "allow_tf32 is on: fp32 matmuls would run in TF32")

    # ---- phase 5: the K-Means kernel against its plain version -------------
    def hold_assign(xs, cs, label):
        return hold_kmeans_launch(ops, ref, xs, cs, label)

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
    xs_np, truth, pooled = clustering_points()
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
    # the kernel's two floors (csrc/kmeans_assign_floors.cu, the same body
    # with only its loads, or only its arithmetic) on the same inputs
    floors = {f"{f}_ms": median_ms(lambda: ops.kmeans_assign_floor(px, pc, f), reps=30) for f in ops.KMEANS_FLOORS}
    row = {
        "name": "kmeans_assign", "route": "cuda", "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign.py:45", "launches": n_launch, "max_abs_err": max(errs),
        "ms": launch_ms[-1], "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib_ms,
        "library": "torch.cdist(compute_mode='use_mm_for_euclid_dist').min(-1)",
        "at": "main path, final assignment", "shape": {"S": s, "N": n, "K": k, "D": d},
        "points_in_tie_band": max(ties), "path_ms": sum(launch_ms), "path_bound_ms": sum(bounds),
        **floors,
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(json.dumps({"kernel": "kmeans_assign", **row, "bytes": nbytes, "flops": flops,
                    "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
                    "issue_floor_ms": kmeans_issue_floor_ms(s, n, k, d, sms), "card": card}))
    del calls

    # ---- phase 20: two requests fused by run_many, seeds 0 and 1 -------------
    # seed 0's serial run is phase 6's; seed 1's runs here.  The fused run
    # clusters both requests' 200 sites in one kmeans_assign_sites launch an
    # iteration, and perturbs them with one merge result a member.
    params = [dict(CL_PARAMS, seed=sd) for sd in CL_FUSE_SEEDS]
    check(params[0] == CL_PARAMS, "phase 6 ran another seed than the first fused request")
    ops.reset_launches()
    t0 = time.perf_counter()
    serial1 = GridRuntime(device=dev).run("vclustering", xs, params[1]).result
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    serial_launches = n_launch + ops.LAUNCHES["kmeans_assign_sites"] + ops.LAUNCHES["kmeans_assign"]
    widest, last = [0], []
    real = ops.kmeans_assign_sites

    def recorder(px, pc):
        widest[0] = max(widest[0], px.shape[0])
        last[:] = [px, pc.clone()]
        return real(px, pc)

    ops.reset_launches()
    ops.kmeans_assign_sites = recorder
    try:
        t0 = time.perf_counter()
        fused = GridRuntime(device=dev).run_many("vclustering", [xs, xs], params)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
    finally:
        ops.kmeans_assign_sites = real
    fused_launches = ops.LAUNCHES["kmeans_assign_sites"] + ops.LAUNCHES["kmeans_assign"]
    refs = {"points": pooled, "labels": {sd: labels_digest(r) for sd, r in zip(CL_FUSE_SEEDS, (res, serial1))}}
    for sd, want, got in zip(CL_FUSE_SEEDS, (res, serial1), fused):
        check(torch.equal(got.result.labels, want.labels)
              and (got.result.merged.n_global, got.result.merged.n_merges)
              == (want.merged.n_global, want.merged.n_merges), f"fused vclustering, seed {sd}: differs from its serial run")
    log(f"clustering run_many (seeds {list(CL_FUSE_SEEDS)}): {fused_s:.3f} s host wall against {wall + serial_s:.3f} s "
        f"for the two serial runs (seed 1 {serial_s:.3f} s); kmeans launches {fused_launches} fused, "
        f"{serial_launches} serial; widest launch {widest[0]} sites; n_global "
        f"{[f.result.merged.n_global for f in fused]}; labels equal to the serial runs'")
    check(fused_launches < serial_launches, "the fused run launched kmeans_assign no fewer times than the serial runs")
    check(widest[0] == CL_SITES * len(CL_FUSE_SEEDS), f"the widest fused launch spans {widest[0]} sites")
    hold_assign(*last, "run_many, final assignment")
    fused_ms = median_ms(lambda: ops.kmeans_assign_sites(*last), reps=30)
    log(f"clustering run_many kmeans_assign_sites, final assignment {tuple(last[0].shape)}: {fused_ms:.4f} ms "
        f"(median of 30), bound {max(kmeans_bound(*last)[:2]):.4f} ms; the serial path's {launch_ms[-1]:.4f} ms at "
        f"{CL_SITES} sites; {card}")
    del fused, serial1, last
    torch.cuda.empty_cache()
    row["launches_by_path"] = {"vclustering": n_launch, "run_many vclustering": fused_launches}
    return row, refs


def mixture_points(n: int, seed: int) -> np.ndarray:
    """``n`` more points of the clustering path's mixture: its 12 centres
    (the first draw of ``gaussian_mixture(7, ...)``), fresh components and
    noise from ``seed``.  numpy only."""
    centers = np.random.default_rng(7).uniform(-20.0, 20.0, size=(CL_COMPONENTS, CL_DIM)).astype(np.float32)
    rng = np.random.default_rng(seed)
    comp = rng.integers(0, CL_COMPONENTS, size=n)
    return (centers[comp] + rng.normal(0.0, 0.8, size=(n, CL_DIM)).astype(np.float32)).astype(np.float32)


def service_trace(dense: np.ndarray, extra: np.ndarray) -> list:
    """Phase 21's trace: ("append", dataset, array) and ("burst", [(tenant,
    app, dataset, params), ...]) in order.  Each stage's bursts come from
    the CLI's generator over the stage's pool; one seeded generator runs
    through all stages."""
    from types import SimpleNamespace

    from repro_torch.launch.serve import _trace_bursts

    def miner(app):
        return [(app, "tx", {"k": K, "minsup": m, "n_sites": N_SITES, "split_seed": 0}) for m in FUSE_MINSUPS]

    local = [("apriori", "tx", {"k": K, "minsup": m}) for m in SV_APRIORI_MINSUPS]
    local.append(("topk", "tx", {"k": TOPK_K, "top": TOPK_TOP}))
    vcl = [("vclustering", "pts", {"k_local": CL_PARAMS["k_local"], "iters": CL_PARAMS["iters"], "seed": sd,
                                   "n_sites": CL_SITES, "split_seed": 1}) for sd in CL_FUSE_SEEDS]
    km = [("kmeans", "pts", dict(SV_KMEANS))]
    mixed = miner("gfm") + miner("fdm") + miner("cd_apriori") + local
    n_batch = N_TX // DELTA_BATCHES
    stages = [
        (vcl, 2 * SV_TENANTS), (km, SV_TENANTS), (mixed, SV_MIXED_REQUESTS),
        ("pts", extra), ("tx", dense[2 * n_batch:3 * n_batch]),
        (km, SV_TENANTS),
        ("tx", dense[3 * n_batch:4 * n_batch]),
        (miner("gfm"), SV_APP_REQUESTS), (miner("fdm"), SV_APP_REQUESTS), (miner("cd_apriori"), SV_APP_REQUESTS),
        (local, 3 * SV_TENANTS),
    ]
    rng = np.random.default_rng(SV_SEED)
    trace = []
    for first, second in stages:
        if isinstance(first, str):
            trace.append(("append", first, second))
            continue
        args = SimpleNamespace(tenants=SV_TENANTS, requests=second, burst=SV_BURST, n_sites=N_SITES)
        trace.extend(("burst", b) for b in _trace_bursts(args, rng, pool=first))
    return trace


def result_digest(app: str, res, memo: dict | None = None) -> dict:
    """What two served results are compared by: the registry's digest for
    the itemset apps; label hashes for the clustering apps (their lists
    would be 5e7 long).  ``memo`` keeps each result object's digest
    (coalesced and cached requests share one)."""
    from repro_torch.workflow.registry import get_workload

    if memo is not None:
        if id(res) not in memo:
            memo[id(res)] = (res, result_digest(app, res))
        return memo[id(res)][1]
    if app == "vclustering":
        return labels_digest(res)
    if app == "kmeans":
        return {name: hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()
                for name, t in (("assign", res.assign), ("centers", res.centers), ("inertia", res.inertia))}
    return get_workload(app).digest(res)


def run_service(dev, card, ops, ref, dense, pooled, refs, hold, measure) -> dict:
    """Phase 21: the mining service at T10I4D100K and the Table 3 point set,
    through ``MiningService.submit`` / ``drain`` / ``result`` / ``ledger``:
    the trace played once with cross-request fusion (every support-count
    and K-Means launch recorded), its checks, the same trace replayed with
    fusion off, every recorded launch held against the plain versions and
    the largest of each kernel timed, then one grid and one kmeans request
    profiled.  Returns {"launches": the kernels' launches on the fused run,
    "largest": each kernel's largest launch, timed}."""
    from repro_torch.core.apriori import bruteforce_frequent
    from repro_torch.core.kmeans import kmeans, kmeans_warm
    from repro_torch.launch.serve import MiningService, fairness_violations
    from repro_torch.workflow.registry import get_workload
    from repro_torch.workflow.requests import MiningRequest

    tenants = [f"tenant{i}" for i in range(SV_TENANTS)]
    n_batch = N_TX // DELTA_BATCHES
    extra = mixture_points(SV_EXTRA_POINTS, SV_EXTRA_SEED)
    trace = service_trace(dense, extra)
    n_requests = sum(len(item[1]) for item in trace if item[0] == "burst")

    def build(fuse: bool):
        t0 = time.perf_counter()
        svc = MiningService(device=dev, backend="batched", n_sites=N_SITES, fuse_requests=fuse)
        svc.register_dataset("tx", "transactions", n_items=N_ITEMS)
        svc.register_dataset("pts", "points", dim=CL_DIM)
        for b in range(2):
            svc.append_transactions("tx", dense[b * n_batch:(b + 1) * n_batch])
        svc.append_points("pts", pooled)
        torch.cuda.synchronize()
        return svc, time.perf_counter() - t0

    def play(svc) -> tuple:
        """The trace through ``svc``: (request ids, wall s, fairness violations)."""
        rids, unfair = [], []
        t0 = time.perf_counter()
        for item in trace:
            if item[0] == "append":
                (svc.append_transactions if item[1] == "tx" else svc.append_points)(item[1], item[2])
                continue
            for tenant, app, dataset, params in item[1]:
                rids.append(svc.submit(tenant, app, dataset, params))
            # every tenant is backlogged: audit the round-robin bound over the
            # picks that drain this burst's guaranteed backlog (as the CLI does)
            window = len(svc.pick_log) + min(svc.queues.depth(t) for t in tenants) * len(tenants)
            svc.drain(max_requests=SV_MAX_PER_STEP)
            unfair.extend(fairness_violations(svc.pick_log[:window], tenants, window))
        torch.cuda.synchronize()
        return rids, time.perf_counter() - t0, unfair

    # ---- the trace with cross-request fusion: a fused dispatch or a
    # signature hook that throws fails the phase (the service itself would
    # fall back to serial execution and hide it)
    svc, setup_s = build(fuse=True)
    errors, fused_sizes = [], []
    real_fused, real_sig = svc._execute_fused, svc._fuse_signature

    def execute_fused(bucket):
        try:
            out = real_fused(bucket)
        except Exception as e:  # noqa: BLE001 — recorded, then the check below fails
            errors.append(f"fused dispatch of {[reqs[0].app for _, _, reqs in bucket]}: {type(e).__name__}: {e}")
            raise
        fused_sizes.append(sum(len(reqs) for _, _, reqs in bucket))
        return out

    def fuse_signature(rep):
        try:
            return real_sig(rep)
        except Exception as e:  # noqa: BLE001
            errors.append(f"signature hook of {rep.app}: {type(e).__name__}: {e}")
            raise

    svc._execute_fused, svc._fuse_signature = execute_fused, fuse_signature
    played = []
    ops.reset_launches()
    km_calls = record_kmeans_launches(
        ops, lambda: played.append(record_launch_inputs(ops, lambda: played.append(play(svc)))),
        wrappers=("kmeans_assign_sites", "kmeans_assign"))
    launches = dict(ops.LAUNCHES)
    (rids, fused_s, unfair), sc_calls = played[0], played[1]
    led = svc.ledger()
    by_kernel = {**kernel_launches_of(launches),
                 "kmeans_assign": launches["kmeans_assign"] + launches["kmeans_assign_sites"]}
    log("service trace: the mixed stage at tx version 3 is cut (the phase took 213 s with it, against 150 s)")
    log(f"service trace (fused): {n_requests} requests over {sum(1 for i in trace if i[0] == 'burst')} bursts, "
        f"{fused_s:.3f} s host wall (setup {setup_s:.3f} s); launches {launches}")
    for name, n in by_kernel.items():
        check(n > 0, f"the service trace never launched {name}")
    check(len(sc_calls["support_count"]) + len(sc_calls["support_count_sites"]) == by_kernel["support_count"]
          and len(sc_calls["support_count_prune"]) + len(sc_calls["support_count_prune_sites"])
          == by_kernel["support_count_prune"] and len(km_calls) == by_kernel["kmeans_assign"],
          "the service trace: recorded calls differ from the launches")

    # ---- the CLI's --check invariants, and no hidden fused failure
    records = led["requests"]
    failed = [r for r in records if r["status"] != "done"]
    check(not failed, f"{len(failed)} service requests did not finish, e.g. {failed[:1]}")
    check(len(records) == n_requests, f"{len(records)} requests ledgered of {n_requests}")
    check(not errors, f"the service hid an exception: {errors[:2]}")
    check(not unfair, f"fairness bound violated: {unfair[:3]}")
    check(led["cache"]["hits"] >= 1, "no cache hit in the service trace")
    check(led["coalesced"] >= 1, "no coalesced request in the service trace")
    check(led["device_dispatches"] < led["executions"],
          f"device_dispatches {led['device_dispatches']} >= executions {led['executions']}")
    check(led["fused_requests"] == sum(fused_sizes) > 0,
          f"fused_requests {led['fused_requests']}, requests in multi-group buckets {sum(fused_sizes)}")

    # ---- the served results against the earlier phases' runs of the same
    # data, and the kmeans requests against direct calls
    digests, memo = {}, {}
    cold = warm = None
    checked = dict.fromkeys(("gfm", "fdm", "cd_apriori", "apriori", "topk", "vclustering", "kmeans"), 0)
    for r in records:
        rid, app, v, p = r["request_id"], r["app"], r["dataset_version"], r["params"]
        res = svc.result(rid)
        digests[rid] = result_digest(app, res, memo)
        if app in ("gfm", "fdm", "cd_apriori") and v == DELTA_BATCHES:
            check(digests[rid] == refs["miners"][(app, p["minsup"])],
                  f"service {app} at minsup {p['minsup']}, version {v}: differs from phase 19's serial run")
            checked[app] += 1
        elif app == "apriori":
            q = refs["delta"][v]
            mc = int(np.ceil(MINSUP * (n_batch * v)))
            if p["minsup"] == MINSUP:
                check(digests[rid] == get_workload("apriori").digest(q),
                      f"service apriori at version {v}: differs from phase 18's query")
            else:
                mc2 = max(1, int(np.ceil(p["minsup"] * (n_batch * v))))
                check(mc2 >= mc, f"apriori minsup {p['minsup']} is below phase 18's")
                for lv, its_list in res.frequent.items():
                    want = sorted(its for its in q.frequent.get(lv, []) if q.counts[its] >= mc2)
                    check(sorted(its_list) == want, f"service apriori minsup {p['minsup']}, version {v}, level {lv}")
                check(all(q.counts[its] == c for its, c in res.counts.items()),
                      f"service apriori minsup {p['minsup']}, version {v}: counts differ from phase 18's")
            checked[app] += 1
        elif app == "topk":
            q = refs["delta"][v]
            if v == DELTA_BATCHES:
                check(res.items == refs["topk"].items, "service topk at version 4 differs from phase 18's top-k")
            if res.threshold >= int(np.ceil(MINSUP * (n_batch * v))):
                pool = [(its, c) for its, c in q.counts.items() if len(its) <= TOPK_K and c >= res.threshold]
            else:
                pool = list(bruteforce_frequent(dense[: n_batch * v], TOPK_K, res.threshold).items())
            want = sorted(pool, key=lambda ic: (-ic[1], len(ic[0]), ic[0]))[:TOPK_TOP]
            check(res.items == want, f"service topk at version {v} differs from the counts of phase 18")
            checked[app] += 1
        elif app == "vclustering":
            check(v == 1, f"a vclustering request ran at points version {v}")
            check(digests[rid] == refs["labels"][p["seed"]],
                  f"service vclustering seed {p['seed']}: differs from phases 6 and 20")
            checked[app] += 1
        elif app == "kmeans" and r["coalesced_into"] is None and not r["cache_hit"]:
            if v == 1:
                cold = res
            else:
                warm = res
            checked[app] += 1
    check(cold is not None and warm is not None, "the trace served no cold and warm kmeans pair")
    direct = kmeans(torch.from_numpy(pooled).to(dev), SV_KMEANS["k"], iters=SV_KMEANS["iters"], use_kernel=True, seed=0)
    check(result_digest("kmeans", direct) == result_digest("kmeans", cold),
          "the cold kmeans request differs from a direct kmeans call")
    x2 = torch.from_numpy(np.concatenate([pooled, extra])).to(dev)
    direct = kmeans_warm(x2, cold.centers.clone(), iters=SV_KMEANS["iters"], use_kernel=True)
    check(result_digest("kmeans", direct) == result_digest("kmeans", warm),
          "the warm kmeans request differs from kmeans_warm from the stored centres")
    del direct, x2
    for app in ("gfm", "fdm", "cd_apriori", "apriori", "topk", "vclustering"):
        check(checked[app] > 0, f"no {app} result of the trace was held to an earlier phase")
    log(f"service results held: {checked} (gfm/fdm/cd_apriori at version {DELTA_BATCHES} == phase 19's serial "
        f"runs; apriori and topk == phase 18's queries; vclustering == phases 6 and 20; kmeans cold == kmeans(), "
        f"warm == kmeans_warm from the stored centres)")

    # ---- the numbers, then the same trace with fusion off
    lat = np.array([r["service_s"] for r in records])
    per_tenant = {t: {"p50_s": float(np.percentile(x, 50)), "p95_s": float(np.percentile(x, 95))}
                  for t in tenants for x in [np.array([r["service_s"] for r in records if r["tenant"] == t])]}
    apps = {}
    for r in records:
        apps[r["app"]] = apps.get(r["app"], 0) + 1
    svc_serial, _ = build(fuse=False)
    rids_s, serial_s, unfair_s = play(svc_serial)
    check(rids_s == rids and not unfair_s, "the serial replay admitted other requests")
    led_s = svc_serial.ledger()
    check(all(r["status"] == "done" for r in led_s["requests"]), "a request of the serial replay failed")
    memo = {}
    for r in led_s["requests"]:
        check(result_digest(r["app"], svc_serial.result(r["request_id"]), memo) == digests[r["request_id"]],
              f"request {r['request_id']} ({r['app']}): the serial replay served another result")
    numbers = {
        "requests": n_requests, "by_app": apps, "wall_s": fused_s, "requests_per_s": n_requests / fused_s,
        "service_p50_s": float(np.percentile(lat, 50)), "service_p95_s": float(np.percentile(lat, 95)),
        "per_tenant": per_tenant, "serial_wall_s": serial_s, "fused_over_serial": fused_s / serial_s,
        "cache_hit_rate": led["cache"]["hit_rate"], "cache_hits": led["cache"]["hits"],
        "executions": led["executions"], "coalesced": led["coalesced"], "exec_groups": led["exec_groups"],
        "device_dispatches": led["device_dispatches"], "fused_requests": led["fused_requests"],
        "serial_device_dispatches": led_s["device_dispatches"],
        "compute_s": sum(r["compute_s"] for r in records), "queue_wait_s": sum(r["queue_wait_s"] for r in records),
        "card": card,
    }
    log(json.dumps({"service": numbers}))
    log(f"service: fused {fused_s:.3f} s against serial {serial_s:.3f} s ({fused_s / serial_s:.3f}x); every request "
        f"of the serial replay served the same digest; fused_requests {led['fused_requests']} == the requests of "
        f"{len(fused_sizes)} multi-group buckets; no hidden exception")
    del svc_serial, led_s, memo

    # ---- every recorded launch held against the plain versions; the largest
    # of each kernel timed
    n_held, largest = hold_support_launches([("service", sc_calls)], hold, dev)
    timed_rows = time_largest_launches(largest, measure)
    del sc_calls, largest
    km_errs, km_largest = [], None
    for j, (px, pc) in enumerate(km_calls):
        err, _ = hold_kmeans_launch(ops, ref, px, pc, f"service, kmeans launch {j + 1}")
        km_errs.append(err)
        if px.shape[0] == 1 and (km_largest is None or px.shape[1] > km_largest[0].shape[1]):
            km_largest = (px, pc, j + 1)
    px, pc, j = km_largest
    t_bytes, t_ops, nbytes, flops = kmeans_bound(px, pc)
    km_row = {
        "at": f"service, kmeans launch {j}", "shape": {"S": 1, "N": px.shape[1], "K": pc.shape[1], "D": px.shape[2]},
        "ms": median_ms(lambda: ops.kmeans_assign(px[0], pc[0]), reps=30),
        "plain_ms": median_ms(lambda: ref.kmeans_assign_ref(px[0], pc[0]), reps=5, warmup=1),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": median_ms(lambda: torch.cdist(px[0], pc[0], compute_mode="use_mm_for_euclid_dist").min(-1),
                                reps=5, warmup=1),
        "max_abs_err": max(km_errs),
    }
    log(json.dumps({"kernel": "kmeans_assign", **km_row, "bytes": nbytes, "flops": flops, "bytes_bound_ms": t_bytes,
                    "ops_bound_ms": t_ops, "card": card}))
    log(json.dumps({"path": "service", "launches_held_exactly": n_held, "kmeans_launches_held": len(km_calls),
                    "largest": timed_rows, "card": card}))
    del km_calls, km_largest, px, pc

    # ---- where one grid request's and one kmeans request's time goes
    def request(app, dataset, params):
        return lambda: svc._execute(MiningRequest(request_id=0, tenant="profile", app=app, dataset=dataset,
                                                  params=dict(params)))

    profile_main_path(request("gfm", "tx", {"k": K, "minsup": MINSUP, "n_sites": N_SITES, "split_seed": 0}),
                      path="service gfm request", n_host=30)
    profile_main_path(request("kmeans", "pts", SV_KMEANS), path="service kmeans request (warm)", n_host=30)
    del svc
    torch.cuda.empty_cache()
    return {"launches": by_kernel, "largest": {**timed_rows, "kmeans_assign": km_row}}



def run_xlstm(dev, card, ops, ref) -> dict:
    """The xLSTM serving slice on the card: the sLSTM kernel against its
    plain version at edge shapes, xlstm-1.3b at full width served (prefill
    of 8 x 4,096 tokens, then 64 greedy decode steps) with its checks, every
    kernel launch of one more prefill held and timed, and where the time
    goes.  Returns the kernel's row of the ``kernels`` line."""
    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    # ---- phase 9: the sLSTM kernel against its plain version ---------------
    def slstm_inputs(gen, b, s, h, p, dtype):
        """wx, R (scaled 1/sqrt(P), as the model's init), bias, and a
        non-zero initial state (n > 0, as the recurrence keeps it)."""
        wx = (torch.randn((b, s, h, 4 * p), generator=gen) * 0.5).to(dtype)
        r = torch.randn((h, p, 4 * p), generator=gen) / p**0.5
        bias = torch.randn((h, 4 * p), generator=gen) * 0.1
        c0 = torch.randn((b, h, p), generator=gen).to(dtype)
        n0 = (torch.rand((b, h, p), generator=gen) + 0.5).to(dtype)
        h0 = (torch.randn((b, h, p), generator=gen) * 0.5).to(dtype)
        return [t.to(dev) for t in (wx, r, bias, c0, n0, h0)]

    def hold_slstm(wx, r, bias, state0, label):
        """The kernel against the plain version on the same inputs, and
        against itself run again (bit for bit).  float32 outputs within
        SLSTM_F32_RTOL of the value plus SLSTM_ATOL (the gate sums over P run
        in another order); bfloat16 outputs within one bf16 ulp of the value
        (SLSTM_BF16_RTOL = 2^-7), since equal-within-float32 states may round
        to neighbouring bf16 values.  Returns the largest |difference|."""
        hids, state = ops.slstm_scan(wx, r, bias, state0)
        again, again_state = ops.slstm_scan(wx, r, bias, state0)
        torch.cuda.synchronize()
        rh, rstate = ref.slstm_scan_ref(wx, r, bias, state0)
        check(torch.equal(hids, again) and all(torch.equal(a, b) for a, b in zip(state, again_state)),
              f"{label}: two launches on the same inputs differ")
        rtol = SLSTM_BF16_RTOL if wx.dtype == torch.bfloat16 else SLSTM_F32_RTOL
        err = 0.0
        for got, want in [(hids, rh), *zip(state, rstate)]:
            check(got.dtype == wx.dtype and got.shape == want.shape, f"{label}: output dtype or shape")
            d = (got.double() - want.double()).abs()
            err = max(err, float(d.max()) if d.numel() else 0.0)
            check(bool((d <= SLSTM_ATOL + rtol * want.double().abs()).all()),
                  f"{label}: slstm_scan differs from the plain version past the tolerance (max {float(d.max()):.3g})")
        return err

    gen = torch.Generator().manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for p in (16, 512):
        for h in (1, 4):
            for b in (1, 3, 8):
                for s in (1, 37, 256):
                    for dtype in (torch.float32, torch.bfloat16):
                        wx, r, bias, c0, n0, h0 = slstm_inputs(gen, b, s, h, p, dtype)
                        err = hold_slstm(wx, r, bias, (c0, n0, h0), f"slstm S{s}-B{b}-H{h}-P{p}-{dtype}")
                        worst[dtype] = max(worst[dtype], err)
                        n_cases += 1
    log(f"slstm kernel checks: {n_cases} shapes x dtypes, S in (1, 37, 256), B in (1, 3, 8), H in (1, 4), "
        f"P in (16, 512), non-zero initial state; max |err| f32 {worst[torch.float32]:.3g}, "
        f"bf16 {worst[torch.bfloat16]:.3g}")

    # ---- phase 10: xlstm-1.3b served at full width -------------------------
    cfg = get("xlstm-1.3b").scaled(slstm_kernel=True)
    t0 = time.perf_counter()
    model = T.Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == T.param_count(cfg), f"{n_params} parameters, the specs count {T.param_count(cfg)}")
    log(f"xlstm-1.3b: {n_params} parameters (fp32), built on the card in {time.perf_counter() - t0:.3f} s")
    tokens = torch.randint(0, cfg.vocab, (XL_BATCH, XL_PROMPT), generator=torch.Generator().manual_seed(1)).to(dev)
    prefill_step, decode_step = make_prefill_step(cfg), make_decode_step(cfg)
    n_slstm = sum(k == "slstm" for k in cfg.blocks())

    def serve(step_cfg, label):
        """Prefill the prompts, then XL_DECODE greedy steps.  Returns the
        prefill logits, the generated tokens (B, XL_DECODE + 1), the launches
        during prefill and during decode, the two host walls, and whether
        every logit was finite."""
        pre, dec = make_prefill_step(step_cfg), make_decode_step(step_cfg)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = pre(model, {"tokens": tokens}, T.init_cache(step_cfg, XL_BATCH, XL_PROMPT + XL_DECODE, dev))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre_launches = ops.LAUNCHES["slstm_scan"]
        ops.reset_launches()
        finite = torch.isfinite(logits).all()
        out = [logits[:, -1].argmax(-1)]
        t0 = time.perf_counter()
        for i in range(XL_DECODE):
            lg, cache = dec(model, {"token": out[-1][:, None], "pos": XL_PROMPT + i}, cache)
            finite &= torch.isfinite(lg).all()
            out.append(lg[:, -1].argmax(-1))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec_launches = ops.LAUNCHES["slstm_scan"]
        log(f"xlstm {label}: prefill {XL_BATCH} x {XL_PROMPT} tokens {prefill_s:.3f} s "
            f"({XL_BATCH * XL_PROMPT / prefill_s:.1f} tokens/s), {XL_DECODE} decode steps {decode_s:.3f} s "
            f"({decode_s / XL_DECODE * 1e3:.3f} ms a step, {XL_BATCH * XL_DECODE / decode_s:.1f} tokens/s at "
            f"B={XL_BATCH}); slstm_scan launches: prefill {pre_launches}, decode {dec_launches}")
        return logits, torch.stack(out, 1), pre_launches, dec_launches, prefill_s, decode_s, bool(finite)

    logits, gen_tokens, pre_n, dec_n, prefill_s, decode_s, finite = serve(cfg, "main path (slstm_kernel=True)")
    check(finite, "a prefill or decode logit is not finite")
    check(pre_n == n_slstm, f"slstm_scan launched {pre_n} times in prefill, want {n_slstm}")
    check(dec_n == 0, f"slstm_scan launched {dec_n} times during decode, want 0")
    check(logits.shape == (XL_BATCH, 1, cfg.vocab_padded), f"prefill logits shape {tuple(logits.shape)}")

    # a second prefill: the same logits, bit for bit
    with torch.inference_mode():
        again, _ = prefill_step(model, {"tokens": tokens}, T.init_cache(cfg, XL_BATCH, XL_PROMPT, dev))
    same_prefill = torch.equal(again, logits)
    log(f"xlstm second prefill: logits bit-identical {same_prefill}")
    check(same_prefill, "a second prefill gives other logits")
    del again

    # prefill/decode parity (tests/test_models_smoke.py:48-63): decode of the
    # last token after a prefill of the rest against the full forward's last
    # position, |a - b| <= 3e-2 + 3e-2 |b|.  The JAX smoke test holds it in
    # float32, and in bfloat16 it fails in both packages at long prompts (on
    # the CPU, the JAX package's own bf16 decode differs from its forward by
    # 0.37 at d_model 512 and 1,024 tokens), so it is held in float32 (the
    # same weights, the kernel path with f32 wx) and reported in bfloat16.
    def parity(step_cfg):
        ops.reset_launches()
        with torch.inference_mode():
            full, _ = T.forward_train(step_cfg, model, tokens)
            fwd_n = ops.LAUNCHES["slstm_scan"]
            full_last = full[:, -1].clone()
            full_finite = bool(torch.isfinite(full).all())
            del full
            _, cache = make_prefill_step(step_cfg)(
                model, {"tokens": tokens[:, :-1]}, T.init_cache(step_cfg, XL_BATCH, XL_PROMPT, dev))
            last, _ = make_decode_step(step_cfg)(model, {"token": tokens[:, -1:], "pos": XL_PROMPT - 1}, cache)
        diff = (last[:, 0] - full_last).abs()
        ok = bool((diff <= PARITY_TOL + PARITY_TOL * full_last.abs()).all())
        log(f"xlstm prefill/decode parity ({step_cfg.dtype}): max |decode - forward| {float(diff.max()):.4g} over "
            f"logits up to {float(full_last.abs().max()):.4g}, within 3e-2 {ok}; forward slstm_scan launches "
            f"{fwd_n}; forward logits finite {full_finite}")
        check(full_finite, f"a {step_cfg.dtype} forward logit is not finite")
        check(fwd_n == n_slstm, f"slstm_scan launched {fwd_n} times in the forward, want {n_slstm}")
        return ok, float(diff.max())

    _, parity_bf16 = parity(cfg)
    parity_ok, parity_f32 = parity(cfg.scaled(dtype="float32"))
    check(parity_ok, f"float32 prefill/decode parity past {PARITY_TOL}")

    # the JAX scan path's bf16 semantics (slstm_kernel=False): reported only,
    # the two paths round the sLSTM state differently by design
    cell_logits, cell_tokens, cell_n, _, cell_prefill_s, _, cell_finite = serve(
        cfg.scaled(slstm_kernel=False), "per-step cell path (slstm_kernel=False)")
    check(cell_n == 0, "slstm_kernel=False launched the kernel")
    agree = float((cell_tokens == gen_tokens).float().mean())
    first_diff = (cell_tokens != gen_tokens).float().argmax(1)
    log(f"xlstm kernel path vs cell path: max |prefill logit diff| {float((cell_logits - logits).abs().max()):.4g}, "
        f"greedy tokens agreeing {agree:.4f} of {gen_tokens.numel()}, first differing step per request "
        f"{first_diff.tolist()} (0 where none differ and the first agrees), cell logits finite {cell_finite}")
    del cell_logits

    # ---- phase 11: every launch of one more prefill, held and timed --------
    calls = []
    real = ops.slstm_scan

    def recorder(wx, r, bias, state0):
        calls.append((wx.clone(), r, bias, tuple(t.clone() for t in state0)))
        return real(wx, r, bias, state0)

    ops.slstm_scan = recorder
    try:
        prefill_step(model, {"tokens": tokens}, T.init_cache(cfg, XL_BATCH, XL_PROMPT, dev))
    finally:
        ops.slstm_scan = real
    check(len(calls) == pre_n, f"{len(calls)} recorded slstm_scan launches, {pre_n} on the main path")

    def slstm_bound(wx):
        """(bytes bound ms, operations bound ms, bytes, flops): wx, R, bias and
        the state read once, hids and the final state written once; 2·P·4P
        flops per (step, row, head) for h @ R (the gates' elementwise work,
        about 30 flops per unit, left out)."""
        b, s, h, p4 = wx.shape
        p, e = p4 // 4, wx.element_size()
        nbytes = wx.numel() * e + (h * p * p4 + h * p4) * 4 + 3 * b * h * p * e + b * s * h * p * e + 3 * b * h * p * e
        flops = 2 * s * b * h * p * p4
        return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3, nbytes, flops

    errs, launch_ms = [], []
    for j, (wx, r, bias, state0) in enumerate(calls):
        errs.append(hold_slstm(wx, r, bias, state0, f"xlstm prefill, launch {j + 1}"))
        launch_ms.append(median_ms(lambda: ops.slstm_scan(wx, r, bias, state0), reps=10))
    log("xlstm slstm_scan ms per launch of the prefill (median of 10 each): " + json.dumps(launch_ms))
    wx, r, bias, state0 = calls[-1]
    b, s, h, p4 = wx.shape
    p_ms = median_ms(lambda: ref.slstm_scan_ref(wx, r, bias, state0), reps=3, warmup=1)
    t_bytes, t_ops, nbytes, flops = slstm_bound(wx)

    # where a step's time goes: the timed build (csrc/slstm_scan_timed.cu) on the last launch's inputs,
    # bit-identical to the kernel, every phase of every CTA counted
    hids, state = ops.slstm_scan(wx, r, bias, state0)
    t_hids, t_state, cycles = ops.slstm_scan_phase_cycles(wx, r, bias, state0)
    torch.cuda.synchronize()
    check(torch.equal(t_hids, hids) and all(torch.equal(a, c) for a, c in zip(t_state, state)),
          "the timed sLSTM build gives other bits than the kernel")
    check(bool((cycles > 0).all()), "an sLSTM phase timer stayed at 0")
    timed_ms = median_ms(lambda: ops.slstm_scan_phase_cycles(wx, r, bias, state0), reps=5)
    _, _, cycles = ops.slstm_scan_phase_cycles(wx, r, bias, state0)
    torch.cuda.synchronize()
    split = ops.slstm_phase_split(cycles, s, timed_ms)
    log("xlstm slstm_scan phase split, us a step (timed build, mean over CTAs): " + json.dumps({
        **split, "untimed_us_per_step": launch_ms[-1] * 1e3 / s, "card": card}))
    del hids, state, t_hids, t_state
    row = {
        "name": "slstm_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/slstm_scan.cu",
        "replaces": "src/repro/kernels/slstm_cell.py:95", "launches": pre_n, "max_abs_err": max(errs),
        "ms": launch_ms[-1], "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
        "library": "none: torch.nn.LSTM and cuDNN have no normaliser state n and no max(n, 1)",
        "at": "xlstm-1.3b prefill, last sLSTM layer", "shape": {"B": b, "S": s, "H": h, "P": p4 // 4,
                                                              "dtype": str(wx.dtype)},
        "us_per_step": launch_ms[-1] * 1e3 / s, "bound_us_per_step": max(t_bytes, t_ops) * 1e3 / s,
        "path_ms": sum(launch_ms), "path_bound_ms": len(calls) * max(t_bytes, t_ops),
        "phase_us_per_step": split["us_per_step"],
    }
    log(json.dumps({"kernel": "slstm_scan", **row, "bytes": nbytes, "flops": flops, "bytes_bound_ms": t_bytes,
                    "ops_bound_ms": t_ops, "edge_max_abs_err": {str(k): v for k, v in worst.items()},
                    "card": card}))
    del calls

    # ---- phase 12: where the serving path's time goes ----------------------
    profile_main_path(
        lambda: prefill_step(model, {"tokens": tokens}, T.init_cache(cfg, XL_BATCH, XL_PROMPT, dev)),
        path="xlstm-1.3b prefill")
    _, cache0 = prefill_step(model, {"tokens": tokens}, T.init_cache(cfg, XL_BATCH, XL_PROMPT + XL_DECODE, dev))

    def decode_all():
        cache, tok = cache0, gen_tokens[:, :1]
        for i in range(XL_DECODE):
            lg, cache = decode_step(model, {"token": tok, "pos": XL_PROMPT + i}, cache)
            tok = lg[:, -1].argmax(-1, keepdim=True)

    profile_main_path(decode_all, path=f"xlstm-1.3b decode ({XL_DECODE} steps)")
    log(json.dumps({"xlstm_serving": {
        "batch": XL_BATCH, "prompt": XL_PROMPT, "decode_steps": XL_DECODE, "prefill_s": prefill_s,
        "prefill_tokens_per_s": XL_BATCH * XL_PROMPT / prefill_s, "decode_ms_per_step": decode_s / XL_DECODE * 1e3,
        "decode_tokens_per_s": XL_BATCH * XL_DECODE / decode_s, "cell_path_prefill_s": cell_prefill_s,
        "parity_max_diff": {"bfloat16": parity_bf16, "float32": parity_f32},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card,
    }}))
    del model, cache0
    torch.cuda.empty_cache()
    return row


def visible_pairs(sq: int, window: int) -> int:
    """(query, key) pairs a causal Sq = Skv launch sees: min(q + 1, window)
    keys for row q (q + 1 without a window)."""
    if not window or window >= sq:
        return sq * (sq + 1) // 2
    return window * (window + 1) // 2 + (sq - window) * window


def flash_bound(q, k, v, window: int, cap: float, peak: float = BF16_TC_FLOPS_PER_S):
    """(bytes bound ms, operations bound ms, sfu floor ms, bytes, flop) of a
    causal launch: q, k, v read once and the output written once; 4·Dh flop
    a visible pair at ``peak`` (the bf16 tensor-core peak unless given); an
    exp (and a tanh with a softcap) a visible pair on the special-function
    units."""
    b, sq, h, dh = q.shape
    pairs = b * h * visible_pairs(sq, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flop = 4 * dh * pairs
    sfu = pairs * (2 if cap else 1)
    return (nbytes / HBM_BYTES_PER_S * 1e3, flop / peak * 1e3, sfu / SFU_OPS_PER_S * 1e3,
            nbytes, flop)


def flash_library(q, k, v, window: int, cap: float, want):
    """The nearest PyTorch call, timed only (the port never calls it):
    flex_attention under torch.compile with the softcap as a score_mod and a
    causal + window block mask, which computes the same function; where that
    fails, scaled_dot_product_attention (causal, no softcap, no window), a
    neighbouring function.  Returns (ms, the call's name, max |out - plain|
    or None, the reason flex failed or None)."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sq = q.shape[1]
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        def mask_mod(b, h, qi, ki):
            m = qi >= ki
            return m & (qi - ki < window) if window else m

        def score_mod(score, b, h, qi, ki):
            return torch.tanh(score / cap) * cap

        block_mask = create_block_mask(mask_mod, None, None, sq, sq, device=q.device)
        flex = torch.compile(flex_attention)

        def call():
            return flex(qt, kt, vt, score_mod=score_mod if cap else None, block_mask=block_mask, enable_gqa=True)

        t0 = time.perf_counter()
        out = call().transpose(1, 2)
        torch.cuda.synchronize()
        log(f"flex_attention compiled and ran in {time.perf_counter() - t0:.1f} s")
        err = float((out.double() - want.double()).abs().max())
        return median_ms(call, reps=10), "torch.compile(flex_attention) with a tanh score_mod and a causal+window " \
            "BlockMask, enable_gqa=True", err, None
    except Exception as e:  # the yardstick's failure is recorded, not fatal
        reason = f"{type(e).__name__}: {str(e)[:300]}"
        log(f"flex_attention yardstick failed: {reason}")
        call = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        return median_ms(call, reps=10), "scaled_dot_product_attention(is_causal=True, enable_gqa=True): no " \
            "softcap, no window (a neighbouring function)", None, reason


def run_gemma2(dev, card, ops, ref) -> dict:
    """The dense attention slice on the card: the flash kernels (bfloat16 on
    the tensor cores, float32 on the CUDA cores) against their plain version
    at edge shapes; gemma2-2b at its published widths scoring 4 x 8,192
    tokens through the bfloat16 kernel and serving (prefill of 8,160 tokens,
    32 greedy decode steps) through the chunked oracle, with its checks;
    every kernel launch of one more scoring run held and timed, with its
    bound and the library's time, and one float32 launch beside it; and
    where the time goes.  Returns the kernel's row of the ``kernels`` line,
    with a route for each dtype."""
    from repro_torch.configs import get
    from repro_torch.models import transformer as T
    from repro_torch.train.losses import chunked_softmax_ce
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    # ---- phase 13: the flash kernels against their plain version -----------
    def hold_flash(q, k, v, causal, window, cap, label):
        """The kernel against the plain version on the same inputs (the same
        key tiles), and against itself run again (bit for bit), within
        FLASH_F32_RTOL or FLASH_BF16_RTOL (see there).  Both launches go to
        the tensor-core kernel in bfloat16 and to the CUDA-core one in
        float32.  Returns the largest |difference| and the share of outputs
        more than one bf16 ulp of the value away (0 in float32)."""
        before = dict(ops.LAUNCHES)
        out = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
        again = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
        torch.cuda.synchronize()
        n_wgmma = ops.LAUNCHES["flash_attention_wgmma"] - before["flash_attention_wgmma"]
        check(ops.LAUNCHES["flash_attention"] - before["flash_attention"] == 2
              and n_wgmma == (2 if q.dtype == torch.bfloat16 else 0),
              f"{label}: {n_wgmma} of 2 launches went to the tensor-core kernel")
        check(torch.equal(out, again), f"{label}: two launches on the same inputs differ")
        check(out.dtype == q.dtype and out.shape == q.shape, f"{label}: output dtype or shape")
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap).double()
        err = (out.double() - want).abs()
        beyond_ulp = 0.0
        if q.dtype == torch.float32:
            bound = FLASH_F32_RTOL * want.abs() + FLASH_ATOL
        else:
            spread = ref.flash_attention_ref(q, k, v.abs(), causal=causal, window=window, cap=cap).double()
            bound = FLASH_BF16_RTOL * (want.abs() + spread) + FLASH_ATOL
            beyond_ulp = float((err > FLASH_BF16_RTOL * want.abs() + FLASH_ATOL).double().mean())
            del spread
        worst = float(err.max()) if err.numel() else 0.0
        check(bool((err <= bound).all()), f"{label}: flash_attention differs from the plain version past the "
              f"bound (max {worst:.3g}, at {float((err / bound).max()):.3g} of the bound)")
        return worst, beyond_ulp

    def flash_inputs(gen, b, sq, skv, h, kvh, dh, dtype):
        return [torch.randn((b, s, n, dh), generator=gen).to(dtype).to(dev)
                for s, n in ((sq, h), (skv, kvh), (skv, kvh))]

    gen = torch.Generator().manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    heads = [(8, 4), (4, 1), (4, 4), (32, 32)]
    for i, (s, dh) in enumerate((s, dh) for s in (1, 37, 128, 300, 1031) for dh in (64, 96, 128, 256)):
        h, kvh = heads[i % 4]
        window, cap = (0, 16, 4096)[i % 3], (0.0, 50.0)[(i // 3) % 2]
        causal = i % 5 != 4  # every S has one non-causal case
        b = 2 if s <= 300 else 1
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(gen, b, s, s, h, kvh, dh, dtype)
            err, _ = hold_flash(q, k, v, causal, window, cap,
                                f"flash B{b}-S{s}-H{h}/{kvh}-Dh{dh}-{'causal' if causal else 'full'}-w{window}-"
                                f"cap{cap}-{dtype}")
            worst[dtype] = max(worst[dtype], err)
            n_cases += 1
            torch.cuda.synchronize()
    # the tensor-core kernel's own edges, in bfloat16 and in float32: a depth
    # padded with zeros (Dh 24, 40; in float32 not a multiple of the 32-column
    # K slice), Sq != Skv without the causal mask, rows that see no key (a
    # window shorter than their distance to every key: exact zeros), and
    # granite-20b's group of 48 query heads on one KV head
    edges = [  # (B, Sq, Skv, H, Kv, Dh, causal, window, cap)
        (2, 130, 130, 4, 2, 24, True, 0, 50.0), (2, 200, 200, 4, 4, 40, False, 16, 0.0),
        (2, 40, 200, 4, 2, 64, False, 0, 50.0), (1, 300, 77, 8, 4, 256, False, 0, 0.0),
        (2, 72, 32, 4, 4, 16, False, 16, 0.0), (1, 400, 64, 4, 1, 128, False, 100, 50.0),
        (1, 256, 256, 48, 1, 128, True, 0, 50.0), (1, 1031, 1031, 48, 1, 64, True, 128, 0.0),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for b, sq, skv, h, kvh, dh, causal, window, cap in edges:
            q, k, v = flash_inputs(gen, b, sq, skv, h, kvh, dh, dtype)
            label = (f"flash {dtype} B{b}-Sq{sq}-Skv{skv}-H{h}/{kvh}-Dh{dh}-{'causal' if causal else 'full'}-"
                     f"w{window}-cap{cap}")
            err, _ = hold_flash(q, k, v, causal, window, cap, label)
            if not causal and window and sq - window > skv - 1:  # rows window + skv - 1.. see no key
                out = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
                check(bool((out[:, window + skv - 1:] == 0).all()), f"{label}: a row that sees no key is not 0")
            worst[dtype] = max(worst[dtype], err)
            n_cases += 1
    log(f"flash kernel checks: {n_cases} shapes x dtypes, Sq=Skv in (1, 37, 128, 300, 1031), (H, Kv) in {heads}, "
        f"Dh in (64, 96, 128, 256), window 0/16/4096, cap 0/50, causal and not, in float32 (CUDA cores) and "
        f"bfloat16 (tensor cores); and {len(edges)} edges in each dtype: Dh 16/24/40, Sq != Skv non-causal, rows "
        f"that see no key (exact zeros), H 48 on Kv 1; two launches bit-identical; max |err| f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}")

    # ---- phase 14: gemma2-2b at its published widths ------------------------
    cfg = get("gemma2-2b").scaled(flash_kernel=True)
    t0 = time.perf_counter()
    model = T.Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == T.param_count(cfg) == 2_614_341_888, f"{n_params} parameters, want 2,614,341,888")
    log(f"gemma2-2b: {n_params} parameters (fp32), built on the card in {time.perf_counter() - t0:.3f} s")
    tokens = torch.randint(0, cfg.vocab, (GM_BATCH, GM_SEQ), generator=torch.Generator().manual_seed(1)).to(dev)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1  # the next token of each position; the last has none
    torch.cuda.reset_peak_memory_stats()

    def score(step_cfg, b=GM_BATCH, chunk=1024):
        """forward_train(return_hidden=True) then chunked_softmax_ce over the
        first b sequences: (hidden, ce, n_tok, (flash launches, of them on
        the tensor cores), host s).  ``chunk`` is the chunked oracle's
        (flash_kernel=False)."""
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            hidden, _ = T.forward_train(step_cfg, model, tokens[:b], chunk=chunk, return_hidden=True)
            ce, n_tok = chunked_softmax_ce(step_cfg, model, hidden, labels[:b], chunk=GM_LOSS_CHUNK)
        torch.cuda.synchronize()
        launches = (ops.LAUNCHES["flash_attention"], ops.LAUNCHES["flash_attention_wgmma"])
        return hidden, ce, n_tok, launches, time.perf_counter() - t0

    hidden, ce, n_tok, (n_flash, n_wgmma), score_s = score(cfg)
    log(f"gemma2 scoring (flash_kernel=True): {GM_BATCH} x {GM_SEQ} tokens {score_s:.3f} s "
        f"({GM_BATCH * GM_SEQ / score_s:.1f} tokens/s), mean CE {float(ce):.6f} over {int(n_tok)} tokens, "
        f"flash_attention launches {n_flash}, of them on the tensor cores (flash_attention_wgmma) {n_wgmma}")
    check(n_flash == FLASH_LAUNCHES and n_wgmma == FLASH_LAUNCHES,
          f"a bf16 scoring forward launched flash_attention {n_flash} and flash_attention_wgmma {n_wgmma} times, "
          f"want {FLASH_LAUNCHES} each")
    check(bool(torch.isfinite(ce)) and int(n_tok) == GM_BATCH * (GM_SEQ - 1), "the scoring loss or count")
    check(hidden.shape == (GM_BATCH, GM_SEQ, cfg.d_model) and bool(torch.isfinite(hidden).all()), "hidden states")
    hidden2, ce2, _, _, score2_s = score(cfg)
    same = torch.equal(hidden2, hidden) and torch.equal(ce2, ce)
    log(f"gemma2 second scoring run: {score2_s:.3f} s, hidden states and CE bit-identical {same}")
    check(same, "a second scoring run differs")
    del hidden2
    oracle_hidden, oracle_ce, _, oracle_n, oracle_s = score(cfg.scaled(flash_kernel=False))
    check(oracle_n == (0, 0), "flash_kernel=False launched the kernel")
    bf16_hidden_diff = float((oracle_hidden.float() - hidden.float()).abs().max())
    log(f"gemma2 scoring through the chunked oracle (flash_kernel=False, reported only: its bf16 accumulator "
        f"differs from the kernel's f32 one by design): {oracle_s:.3f} s, mean CE {float(oracle_ce):.6f} "
        f"(kernel path {float(ce):.6f}), max |hidden diff| {bf16_hidden_diff:.4g} over values up to "
        f"{float(hidden.float().abs().max()):.4g}")
    del oracle_hidden, hidden

    # serving: the first GM_PROMPT tokens, then GM_DECODE greedy steps
    prefill_step, decode_step = make_prefill_step(cfg), make_decode_step(cfg)
    prompt = tokens[:, :GM_PROMPT]
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_step(model, {"tokens": prompt}, T.init_cache(cfg, GM_BATCH, GM_SEQ, dev))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre_n = ops.LAUNCHES["flash_attention"]
    finite = torch.isfinite(logits).all()
    out = [logits[:, -1].argmax(-1)]
    t0 = time.perf_counter()
    for i in range(GM_DECODE):
        lg, cache = decode_step(model, {"token": out[-1][:, None], "pos": GM_PROMPT + i}, cache)
        finite &= torch.isfinite(lg).all()
        out.append(lg[:, -1].argmax(-1))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    dec_n = ops.LAUNCHES["flash_attention"] - pre_n
    gen_tokens = torch.stack(out, 1)
    log(f"gemma2 serving: prefill {GM_BATCH} x {GM_PROMPT} tokens {prefill_s:.3f} s "
        f"({GM_BATCH * GM_PROMPT / prefill_s:.1f} tokens/s), {GM_DECODE} decode steps {decode_s:.3f} s "
        f"({decode_s / GM_DECODE * 1e3:.3f} ms a step at B={GM_BATCH}); flash_attention launches: prefill "
        f"{pre_n}, decode {dec_n}")
    check(bool(finite), "a prefill or decode logit is not finite")
    check(pre_n == 0 and dec_n == 0, "prefill or decode launched the flash kernel")
    check(logits.shape == (GM_BATCH, 1, cfg.vocab_padded), f"prefill logits shape {tuple(logits.shape)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del cache, logits

    # held in float32 at B = 1 (the same weights, f32 compute): the kernel
    # path against the chunked oracle on the hidden states and the CE, and
    # prefill + teacher-forced decode against the forward's logits
    cfg32 = cfg.scaled(dtype="float32")
    h_on, ce_on, _, n_on, on_s = score(cfg32, b=1)
    # every launch of a second float32 run is recorded: phase 15 holds and times them
    f32_calls = []
    real = ops.flash_attention

    def record_f32(q, k, v, causal=True, window=0, cap=0.0):
        f32_calls.append((q.clone(), k.clone(), v.clone(), causal, window, cap))
        return real(q, k, v, causal=causal, window=window, cap=cap)

    ops.flash_attention = record_f32
    try:
        _, ce_again, _, _, _ = score(cfg32, b=1)
    finally:
        ops.flash_attention = real
    check(torch.equal(ce_again, ce_on), "a second float32 scoring run differs")
    h_off, ce_off, _, n_off, off_s = score(cfg32.scaled(flash_kernel=False), b=1)
    h_512, _, _, _, _ = score(cfg32.scaled(flash_kernel=False), b=1, chunk=512)
    check(n_on == (FLASH_LAUNCHES, 0) and n_off == (0, 0) and len(f32_calls) == FLASH_LAUNCHES,
          f"float32 scoring launches (flash, of them tensor-core) {n_on}, {n_off}: want (26, 0), (0, 0)")
    log(f"gemma2 float32 scoring at B = 1: flash_attention launches {n_on[0]}, flash_attention_wgmma {n_on[1]}")

    def spread(a, b):  # (max |a - b|, ||a - b|| / ||b||)
        return float((a - b).abs().max()), float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    hid_max, hid_rel = spread(h_on, h_off)
    ctl_max, ctl_rel = spread(h_512, h_off)
    with torch.inference_mode():
        want = T.logits_from(cfg32, model, h_on[:, GM_PROMPT - 1 :])  # positions GM_PROMPT-1 .. GM_SEQ-1
        lg_max, _ = spread(want, T.logits_from(cfg32, model, h_off[:, GM_PROMPT - 1 :]))
    ce_ok = abs(float(ce_on) - float(ce_off)) <= SMOKE_FLASH_TOL * (1 + abs(float(ce_off)))
    log(f"gemma2 float32 flash on vs off: CE {float(ce_on):.7f} vs {float(ce_off):.7f}, scoring 1 x {GM_SEQ} "
        f"tokens {on_s:.3f} s vs {off_s:.3f} s; hidden states max |diff| "
        f"{hid_max:.4g}, normwise {hid_rel:.3g} (the oracle at chunk 512 vs 1024: max {ctl_max:.4g}, normwise "
        f"{ctl_rel:.3g}); logits at the last {want.shape[1]} positions max |diff| {lg_max:.4g}; CE and normwise "
        f"hidden within {SMOKE_FLASH_TOL}: {ce_ok and hid_rel <= SMOKE_FLASH_TOL}")
    check(ce_ok and hid_rel <= SMOKE_FLASH_TOL, f"float32 flash on vs off past {SMOKE_FLASH_TOL}")
    del h_on, h_off, h_512

    def parity(step_cfg):
        """Prefill of GM_PROMPT tokens (B = 1), then teacher-forced decode of
        the rest: the logits of positions GM_PROMPT-1 .. GM_SEQ-1."""
        lg, cache = make_prefill_step(step_cfg)(
            model, {"tokens": tokens[:1, :GM_PROMPT]}, T.init_cache(step_cfg, 1, GM_SEQ, dev))
        got = [lg[:, 0]]
        dec = make_decode_step(step_cfg)
        for pos in range(GM_PROMPT, GM_SEQ):
            lg, cache = dec(model, {"token": tokens[:1, pos : pos + 1], "pos": pos}, cache)
            got.append(lg[:, 0])
        return torch.stack(got, 1)

    got = parity(cfg32)
    diff = (got - want).abs()
    parity_ok = bool((diff <= PARITY_TOL + PARITY_TOL * want.abs()).all())
    parity_f32 = float(diff.max())
    log(f"gemma2 float32 prefill ({GM_PROMPT}) + {GM_SEQ - GM_PROMPT} teacher-forced decode steps vs the "
        f"forward's logits at those {want.shape[1]} positions: max |diff| {parity_f32:.4g} over logits up to "
        f"{float(want.abs().max()):.4g}, within {PARITY_TOL} {parity_ok}")
    check(parity_ok, f"float32 prefill/decode parity past {PARITY_TOL}")
    with torch.inference_mode():
        h_bf, _, _, _, _ = score(cfg, b=1)
        want_bf = T.logits_from(cfg, model, h_bf[:, GM_PROMPT - 1 :])
    parity_bf16 = float((parity(cfg) - want_bf).abs().max())
    log(f"gemma2 bfloat16 prefill + decode vs the forward's logits (reported only: the oracle's bf16 "
        f"accumulator against the kernel's f32 one): max |diff| {parity_bf16:.4g}")
    del h_bf, want_bf, want, got, diff

    # ---- phase 15: every launch of one more scoring run, held and timed -----
    calls = []
    real = ops.flash_attention

    def recorder(q, k, v, causal=True, window=0, cap=0.0):
        calls.append((q.clone(), k.clone(), v.clone(), causal, window, cap))
        return real(q, k, v, causal=causal, window=window, cap=cap)

    ops.flash_attention = recorder
    try:
        score(cfg)
    finally:
        ops.flash_attention = real
    check(len(calls) == n_flash, f"{len(calls)} recorded flash launches, {n_flash} on the main path")
    errs, beyond, launch_ms = [], [], []
    for j, (q, k, v, causal, window, cap) in enumerate(calls):
        err, share = hold_flash(q, k, v, causal, window, cap, f"gemma2 scoring, launch {j + 1} (window {window})")
        errs.append(err)
        beyond.append(share)
        launch_ms.append(median_ms(lambda: ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap),
                                   reps=10, warmup=1))
    log("gemma2 flash_attention ms per launch of the scoring run (median of 10 each): " + json.dumps(launch_ms))

    def route_row(q, k, v, causal, window, cap, ms, at):
        """The plain version's and the library's times beside the kernel's,
        with the bound by the bf16 tensor-core peak (bfloat16) or the f32
        CUDA-core peak (float32: TF32 would be another function)."""
        p_ms = median_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap),
                         reps=3, warmup=1)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap)
        lib_ms, lib_name, lib_err, flex_failed = flash_library(q, k, v, window, cap, want)
        del want
        peak = BF16_TC_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
        t_bytes, t_ops, t_sfu, nbytes, flop = flash_bound(q, k, v, window, cap, peak)
        b, sq, h, dh = q.shape
        row = {
            "ms": ms, "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib_ms, "library": lib_name,
            "tflops_on_visible_pairs": flop / ms / 1e9, "share_of_bound": max(t_bytes, t_ops) / ms, "at": at,
            "shape": {"B": b, "Sq": sq, "Skv": k.shape[1], "H": h, "Kv": k.shape[2], "Dh": dh, "window": window,
                      "cap": cap, "dtype": str(q.dtype)},
        }
        log(json.dumps({"kernel": "flash_attention", **row, "bytes": nbytes, "flop": flop,
                        "visible_pairs": b * h * visible_pairs(sq, window), "bytes_bound_ms": t_bytes,
                        "ops_bound_ms": t_ops, "sfu_floor_ms": t_sfu, "library_max_abs_diff": lib_err,
                        "flex_failure": flex_failed, "card": card}))
        return row

    rows = {}
    for kind, j in (("full", next(j for j, c in enumerate(calls) if not c[4])),
                    ("swa", next(j for j, c in enumerate(calls) if c[4]))):
        rows[kind] = route_row(*calls[j], launch_ms[j], f"gemma2-2b scoring, launch {j + 1} ({kind} layer)")
    path_bound = sum(max(flash_bound(q, k, v, w, c)[:2]) for q, k, v, _, w, c in calls)
    del calls
    # the float32 route: every launch of the B = 1 float32 scoring run, on the
    # CUDA cores.  Held as phase 14 holds float32 at full width, normwise
    # within SMOKE_FLASH_TOL (see there): FLASH_F32_RTOL is an elementwise
    # bound for the edge cases' random inputs, and over 8,192 keys of a
    # model's activations the sums' order moves small outputs by more
    # (reported beside it for the first full layer, against the |v|-weighted
    # mean).  Two launches of each bit-identical; each timed
    f32_ms, f32_err, f32_rel = [], [], []
    for j, (q, k, v, causal, window, cap) in enumerate(f32_calls):
        before = ops.LAUNCHES["flash_attention_wgmma"]
        out = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
        again = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
        torch.cuda.synchronize()
        label = f"gemma2 float32 scoring, launch {j + 1} (window {window})"
        check(ops.LAUNCHES["flash_attention_wgmma"] == before, f"{label} went to the tensor-core kernel")
        check(torch.equal(out, again) and bool(torch.isfinite(out).all()), f"{label}: repeat or finiteness")
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap).double()
        err = (out.double() - want).abs()
        f32_err.append(float(err.max()))
        f32_rel.append(float(torch.linalg.vector_norm(err) / torch.linalg.vector_norm(want)))
        check(f32_rel[-1] <= SMOKE_FLASH_TOL, f"{label}: normwise {f32_rel[-1]:.3g} past {SMOKE_FLASH_TOL}")
        if j == next(i for i, c in enumerate(f32_calls) if not c[4]):
            spread = ref.flash_attention_ref(q, k, v.abs(), causal=causal, window=window, cap=cap).double()
            log(f"gemma2 float32 full layer (B = 1) against the plain version: max |err| {f32_err[-1]:.4g}, normwise "
                f"{f32_rel[-1]:.3g} (bound {SMOKE_FLASH_TOL}); max |err| / (|want| + |v|-weighted mean) "
                f"{float((err / (want.abs() + spread)).max()):.3g}; beyond the edge cases' elementwise bound "
                f"{float((err > FLASH_F32_RTOL * want.abs() + FLASH_ATOL).double().mean()):.3g} of the outputs")
            del spread
        del out, again, want, err
        f32_ms.append(median_ms(lambda: ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap),
                                reps=10, warmup=1))
    f32_bound = sum(max(flash_bound(q, k, v, w, c, FP32_FLOPS_PER_S)[:2]) for q, k, v, _, w, c in f32_calls)
    log(f"gemma2 float32 flash_attention ms per launch of the B = 1 scoring run (median of 10 each), all "
        f"{len(f32_ms)} held normwise within {SMOKE_FLASH_TOL} (max {max(f32_rel):.3g}): {json.dumps(f32_ms)}; sum "
        f"{sum(f32_ms):.3f} ms against a bound of {f32_bound:.3f} ms")
    f32_rows = {}
    for kind, j in (("full", next(j for j, c in enumerate(f32_calls) if not c[4])),
                    ("swa", next(j for j, c in enumerate(f32_calls) if c[4]))):
        f32_rows[kind] = route_row(*f32_calls[j], f32_ms[j],
                                   f"gemma2-2b float32 scoring at B = 1, launch {j + 1} ({kind} layer)")
    # the full layer through the timed build: the same bits, and where its time goes
    q, k, v, causal, window, cap = next(c for c in f32_calls if not c[4])
    out = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    timed_out, cycles = ops.flash_attention_phase_cycles(q, k, v, causal=causal, window=window, cap=cap)
    torch.cuda.synchronize()
    check(torch.equal(out, timed_out), "the float32 flash kernel's timed build gives other bits")
    check(bool((cycles.sum(1) > 0).all()), "a CTA's phase timers stayed at 0")
    timed_ms = median_ms(lambda: ops.flash_attention_phase_cycles(q, k, v, causal=causal, window=window, cap=cap),
                         reps=10, warmup=1)
    _, cycles = ops.flash_attention_phase_cycles(q, k, v, causal=causal, window=window, cap=cap)
    f32_split = ops.flash_phase_split(cycles, timed_ms)
    f32_ptxas = {f"NJ{name.split('kernelILi')[1][0]}": regs
                 for name, regs in PTXAS.get("flash_attention", {}).items() if "kernelILi" in name}
    log("gemma2 float32 flash_attention phase split, the full layer (timed build, thread 0 of every CTA; ms = "
        "share x the timed build's ms): " + json.dumps({**f32_split, "ptxas": f32_ptxas or "cached build",
                                                        "card": card}))
    del f32_calls, q, k, v, out, timed_out, cycles
    summary = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops_on_visible_pairs", "at")
    row = {
        "name": "flash_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84", "launches": n_flash, "max_abs_err": max(errs),
        **rows["full"], "swa_launch": {k: rows["swa"][k] for k in summary},
        "routes": {
            "bf16": {"source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu", "launches": n_wgmma,
                     **{k: rows["full"][k] for k in summary}},
            "f32": {"source": "src/repro_torch/kernels/csrc/flash_attention.cuh", "launches_bf16_scoring": 0,
                    "launches_f32_scoring": n_on[0], "max_abs_err": max(f32_err), "normwise_err": max(f32_rel),
                    **{k: f32_rows["full"][k] for k in summary},
                    "swa_launch": {k: f32_rows["swa"][k] for k in summary},
                    "path_ms": sum(f32_ms), "path_bound_ms": f32_bound,
                    "phase_split_full_layer": {k: f32_split[k] for k in ("share", "phase_ms", "timed_ms")},
                    "ptxas": f32_ptxas or None},
        },
        "path_ms": sum(launch_ms), "path_bound_ms": path_bound,
        "outputs_beyond_one_bf16_ulp": max(beyond), "edge_max_abs_err": {str(k): v for k, v in worst.items()},
    }

    # ---- phase 16: where gemma2's time goes ---------------------------------
    prof_score = profile_main_path(lambda: score(cfg), path="gemma2-2b scoring",
                                   kernel="flash_attention_wgmma_kernel")
    prof_prefill = profile_main_path(
        lambda: prefill_step(model, {"tokens": prompt}, T.init_cache(cfg, GM_BATCH, GM_SEQ, dev)),
        path="gemma2-2b prefill")
    _, cache0 = prefill_step(model, {"tokens": prompt}, T.init_cache(cfg, GM_BATCH, GM_SEQ, dev))

    def decode_all():  # writes positions GM_PROMPT.. of cache0 in place, the same values each run
        cache, tok = cache0, gen_tokens[:, :1]
        for i in range(GM_DECODE):
            lg, cache = decode_step(model, {"token": tok, "pos": GM_PROMPT + i}, cache)
            tok = lg[:, -1].argmax(-1, keepdim=True)

    prof_decode = profile_main_path(decode_all, path=f"gemma2-2b decode ({GM_DECODE} steps)")
    log(json.dumps({"gemma2_scoring_serving": {
        "batch": GM_BATCH, "seq": GM_SEQ, "prompt": GM_PROMPT, "decode_steps": GM_DECODE,
        "scoring_s": score_s, "scoring_tokens_per_s": GM_BATCH * GM_SEQ / score_s,
        "scoring_s_second_run": score2_s, "oracle_scoring_s": oracle_s, "mean_ce": float(ce),
        "oracle_mean_ce": float(oracle_ce), "bf16_hidden_max_diff": bf16_hidden_diff,
        "prefill_s": prefill_s, "prefill_tokens_per_s": GM_BATCH * GM_PROMPT / prefill_s,
        "decode_ms_per_step": decode_s / GM_DECODE * 1e3, "decode_tokens_per_s": GM_BATCH * GM_DECODE / decode_s,
        "f32_ce": [float(ce_on), float(ce_off)], "f32_hidden_flash_vs_oracle": [hid_max, hid_rel],
        "f32_hidden_oracle_chunk_512_vs_1024": [ctl_max, ctl_rel], "f32_logits_flash_vs_oracle_max": lg_max,
        "parity_max_diff": {"float32": parity_f32, "bfloat16": parity_bf16},
        "flash_share_of_scoring_device_busy": prof_score["kernel"]["share_of_device_busy"],
        "device_idle_share": {"scoring": prof_score["device_idle_share"],
                              "prefill": prof_prefill["device_idle_share"],
                              "decode": prof_decode["device_idle_share"]},
        "peak_memory_gb": peak_gb, "card": card,
    }}))
    check(prof_score["kernel"]["calls"] == FLASH_LAUNCHES, "the profiled scoring run's flash kernels")
    del model, cache0
    torch.cuda.empty_cache()
    return row


# phase 22: multi-host execution (runtime.backends.MultiHostBackend) on the
# card: gloo groups of ranks that all compute on the one H100, each a run of
# this script in child mode.  Group A ships each ready wave in one
# collective and runs the three miners at configuration 1 and vclustering at
# configuration 2; group B ships once per job and runs the three miners.
MH_GROUPS = {
    "A": {"nprocs": 2, "fuse": 1, "apps": ("gfm", "fdm", "cd_apriori", "vclustering")},
    "B": {"nprocs": 3, "fuse": 0, "apps": ("gfm", "fdm", "cd_apriori")},
}
# the kernels each app's path launches (phases 3, 6 and 17): every rank must
# launch each kernel of its group's apps at least once over the group's runs
# (one app alone need not: a site whose GFM recount has nothing to count
# launches no support_count)
MH_PATH_KERNELS = {"gfm": ("support_count", "support_count_prune"), "fdm": ("support_count",),
                   "cd_apriori": ("support_count",), "vclustering": ("kmeans_assign",)}
MH_MARKER = "MULTIHOST_CHILD "
MH_TIMEOUT_S = 300  # a child's collectives, and the parent's wait for a group
MH_CHILD = [sys.executable, os.path.abspath(__file__)]  # how a rank starts
MH_KMEANS = ("kmeans_assign", "kmeans_assign_sites")


def record_launches(ops, run_once) -> dict:
    """Every support-count and K-Means launch during one call of
    ``run_once``, with its inputs and its outputs: each wrapper is wrapped,
    for that call only, by one that calls it and keeps copies.  A K-Means
    points tensor is kept once (by storage): every launch of a Lloyd run
    reads the same one."""
    calls = {name: [] for name in SUPPORT_WRAPPERS + MH_KMEANS}
    real = {name: getattr(ops, name) for name in calls}
    points = {}

    def recorder(name):
        def fn(*args):
            out = real[name](*args)
            outs = out if isinstance(out, tuple) else (out,)
            if name in MH_KMEANS:
                xs, cs = args
                if xs.shape[-2] > 0:
                    px = points.setdefault((xs.data_ptr(), tuple(xs.shape)), xs)
                    calls[name].append(((px, cs.clone()), tuple(o.clone() for o in outs)))
            elif all(d > 0 for d in args[0].shape[:-1]) and args[1].shape[-2] > 0:
                calls[name].append((tuple(torch.as_tensor(a).clone() for a in args), tuple(o.clone() for o in outs)))
            return out
        return fn

    for name in calls:
        setattr(ops, name, recorder(name))
    try:
        run_once()
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    return calls


def hold_recorded(ref, calls: dict) -> dict:
    """Every recorded launch's outputs against the plain version on its own
    inputs: support counts (and flags) exactly, K-Means assignments and min
    d² bit for bit.  Returns the launches held, by kernel."""
    held = {"support_count": 0, "support_count_prune": 0, "kmeans_assign": 0}
    for name, recs in calls.items():
        while recs:
            args, outs = recs.pop(0)
            site = name.endswith("_sites")
            if name in MH_KMEANS:
                xs, cs = args if site else (args[0][None], args[1][None])
                want = ref.kmeans_assign_sites_ref(xs, cs)
                kernel = "kmeans_assign"
            else:
                tx, masks = args[:2] if site else (args[0][None], args[1][None])
                if name.startswith("support_count_prune"):
                    mc = args[2].reshape(-1).to(device=tx.device, dtype=torch.int32)
                    want = ref.support_count_prune_sites_ref(tx, masks, mc)
                    kernel = "support_count_prune"
                else:
                    want = (ref.support_count_sites_ref(tx, masks),)
                    kernel = "support_count"
            if not site:
                want = tuple(w[0] for w in want)
            torch.cuda.synchronize()
            check(all(torch.equal(o, w) for o, w in zip(outs, want)),
                  f"{name}: a launch of the multi-host run differs from the plain version")
            held[kernel] += 1
    return held


def multihost_child(argv) -> None:
    """One rank of a phase 22 group: join the gloo group, run each app
    through ``MultiHostBackend`` (every kernel launch recorded, the wire
    timed) and then alone on one process, the ranks taking turns; hold
    every recorded launch against the plain version; print one marker line
    of JSON.  Fails (exit 1) on any check."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--multihost-child", action="store_true")
    for name in ("--pid", "--nprocs", "--port", "--fuse"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--apps", required=True)
    ap.add_argument("--data", required=True, help="the directory the parent wrote the data to")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the multi-host child needs the CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist

    from repro_torch.core.apriori import TransactionDB
    from repro_torch.data.synthetic import split_transactions
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh
    from repro_torch.runtime import GridRuntime
    from repro_torch.runtime.backends import MultiHostBackend
    from repro_torch.workflow.registry import get_workload

    check("jax" not in sys.modules, "the port imported jax")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.nprocs))
    dev = torch.device(DEVICE)
    be = MultiHostBackend(coordinator_address=f"127.0.0.1:{args.port}", num_processes=args.nprocs,
                          process_id=args.pid, fuse_waves=bool(args.fuse), timeout=MH_TIMEOUT_S)
    topo = be.describe()
    check(topo["is_multiprocess"] is True and topo["process_count"] == args.nprocs
          and topo["process_index"] == args.pid and topo["wire"] == "gloo",
          f"rank {args.pid}: the group did not come up as {args.nprocs} gloo processes: {topo}")

    dense = np.load(os.path.join(args.data, "dense.npy"))
    sites = [TransactionDB.from_dense(p, device=dev) for p in split_transactions(dense, N_SITES, seed=0)]
    del dense
    # the wire: every allgather_bytes call's seconds (waiting for the
    # slowest rank included) and bytes, this rank's and all ranks' together
    wire = {"bytes_sent": 0, "bytes_gathered": 0, "s": 0.0, "call_s": []}
    real_gather = mesh.allgather_bytes

    def spy(data: bytes) -> list:
        t0 = time.perf_counter()
        out = real_gather(data)
        dt = time.perf_counter() - t0
        wire["s"] += dt
        wire["call_s"].append(dt)
        wire["bytes_sent"] += len(data)
        wire["bytes_gathered"] += sum(len(b) for b in out)
        return out

    mesh.allgather_bytes = spy
    alone_backend = "batched" if args.fuse else "inline"
    report = {"pid": args.pid, "topology": topo, "alone_backend": alone_backend, "apps": {}}
    for app in args.apps.split(","):
        if app == "vclustering":
            data = torch.from_numpy(np.load(os.path.join(args.data, "points.npy"))).to(dev)
            params = CL_PARAMS
            digest = labels_digest
        else:
            data, params = sites, {"k": K, "minsup": MINSUP}
            digest = lambda res, app=app: json.loads(json.dumps(get_workload(app).digest(res)))  # noqa: E731
        wire.update(bytes_sent=0, bytes_gathered=0, s=0.0, call_s=[])
        out = []
        dist.barrier()
        ops.reset_launches()
        t0 = time.perf_counter()
        calls = record_launches(ops, lambda: out.append(GridRuntime(device=dev, backend=be).run(app, data, params)))
        torch.cuda.synchronize()
        mh_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        run = out[0]
        got = digest(run.result)
        row = {
            "digest": got, "multihost_s": mh_s, "wire": {**wire, "call_s": list(wire["call_s"])}, "launches": launches,
            "n_processes": run.n_processes, "owned_sites": list(run.owned_sites or []),
            "executed": list(be.executed_log), "shipped": sorted(be.shipped_log),
            "job_sites": {n: int(s_) for n, s_ in run.report.placements.items()},
            "ledger": dict(be.ledger(), waves=be.waves),
            "owned_compute_s": sum(t for n, t in run.report.job_times.items() if n in set(be.executed_log)),
        }
        del run, out
        # alone: the ranks take turns, so that each single-process run has
        # the card to itself
        for turn in range(args.nprocs):
            if turn == args.pid:
                t0 = time.perf_counter()
                alone = GridRuntime(device=dev, backend=alone_backend).run(app, data, params)
                torch.cuda.synchronize()
                row["alone_s"] = time.perf_counter() - t0
                check(digest(alone.result) == got, f"rank {args.pid}, {app}: multi-host differs from the run alone")
                del alone
            dist.barrier()
        row["held"] = hold_recorded(ref, calls)
        del calls, data
        torch.cuda.empty_cache()
        report["apps"][app] = row
    mesh.allgather_bytes = real_gather
    print(MH_MARKER + json.dumps(report), flush=True)
    dist.destroy_process_group()


def run_multihost(card: str, dense: np.ndarray, pooled: np.ndarray, refs: dict) -> dict:
    """Phase 22: the multi-host backend on the card.  The parent writes the
    data under build/, starts each gloo group (this script in child mode,
    one process a rank), and holds every rank to the single-process
    results of phases 3, 6 and 17 (``refs``: app -> digest), to site
    ownership (each site's jobs on exactly one rank), and to its launches
    (each kernel of its path launched on every rank, every launch held in
    the child).  Returns each kernel's launches on the multi-host runs,
    summed over ranks and groups."""
    from repro_torch.data.synthetic import split_sites

    data_dir = os.path.join(ROOT, "build", "multihost_smoke")
    os.makedirs(data_dir, exist_ok=True)
    t0 = time.perf_counter()
    np.save(os.path.join(data_dir, "dense.npy"), dense)
    np.save(os.path.join(data_dir, "points.npy"), split_sites(pooled, CL_SITES, seed=1))
    log(f"multihost data written: {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    totals = {"support_count": 0, "support_count_prune": 0, "kmeans_assign": 0}
    summary = {}
    for name, g in MH_GROUPS.items():
        nprocs, apps = g["nprocs"], g["apps"]
        with __import__("socket").socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        argv = [*MH_CHILD, "--multihost-child", "--nprocs", str(nprocs),
                "--port", str(port), "--fuse", str(g["fuse"]), "--apps", ",".join(apps), "--data", data_dir]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(argv + ["--pid", str(pid)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for pid in range(nprocs)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MH_TIMEOUT_S))
        except subprocess.TimeoutExpired:
            fail(f"multihost group {name}: a rank did not finish in {MH_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        group_s = time.perf_counter() - t0
        reports = []
        rank_launched = [dict.fromkeys(totals, 0) for _ in range(nprocs)]
        for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"multihost group {name}, rank {pid} exited {p.returncode}:\n{err[-3000:]}")
            lines = [ln for ln in out.splitlines() if ln.startswith(MH_MARKER)]
            check(len(lines) == 1, f"multihost group {name}, rank {pid}: no report line")
            reports.append(json.loads(lines[0][len(MH_MARKER):]))
        for app in apps:
            rows = [r["apps"][app] for r in reports]
            for pid, row in enumerate(rows):
                check(row["digest"] == refs[app], f"group {name}, rank {pid}, {app}: differs from the single-process run")
                check(row["n_processes"] == nprocs, f"group {name}, rank {pid}, {app}: {row['n_processes']} processes")
                launched = kernel_launches_of(row["launches"])
                launched["kmeans_assign"] = sum(row["launches"][k] for k in MH_KMEANS)
                for kernel in totals:
                    rank_launched[pid][kernel] += launched[kernel]
                    check(row["held"][kernel] == launched[kernel],
                          f"group {name}, rank {pid}, {app}: {row['held'][kernel]} of {launched[kernel]} "
                          f"{kernel} launches held")
                    totals[kernel] += launched[kernel]
                led = row["ledger"]
                check(led["collective_rounds"] == 2 * led["shipments"] and led["shipped_results"] == len(row["shipped"]),
                      f"group {name}, rank {pid}, {app}: ledger {led}")
                check(led["shipments"] == (led["waves"] if g["fuse"] else len(row["job_sites"])),
                      f"group {name}, rank {pid}, {app}: {led['shipments']} shipments")
            # each site's jobs on exactly one rank, and on the rank owning it
            job_sites = rows[0]["job_sites"]
            executed = [set(r["executed"]) for r in rows]
            check(sum(map(len, executed)) == len(job_sites) and set().union(*executed) == set(job_sites),
                  f"group {name}, {app}: the ranks' executed jobs do not partition the DAG")
            owners = {}
            for pid, row in enumerate(rows):
                for site in row["owned_sites"]:
                    check(site not in owners, f"group {name}, {app}: site {site} owned twice")
                    owners[site] = pid
                check(all(owners.get(job_sites[n]) == pid for n in row["executed"]),
                      f"group {name}, rank {pid}, {app}: executed a job of a site it does not own")
            check(set(owners) == set(job_sites.values()), f"group {name}, {app}: a site has no owner")
            summary[f"{name} {app}"] = {
                "ranks": nprocs, "fuse_waves": bool(g["fuse"]), "jobs": len(job_sites),
                "multihost_s": [r["multihost_s"] for r in rows], "alone_s": [r["alone_s"] for r in rows],
                "alone_backend": reports[0]["alone_backend"],
                "shipments": rows[0]["ledger"]["shipments"], "waves": rows[0]["ledger"]["waves"],
                "wire_bytes_gathered": [r["wire"]["bytes_gathered"] for r in rows],
                "wire_bytes_sent": [r["wire"]["bytes_sent"] for r in rows],
                "wire_s": [r["wire"]["s"] for r in rows],
                # each call's time on the rank that reached it last: the
                # transfer itself, with no wait for a slower rank
                "wire_calls": len(rows[0]["wire"]["call_s"]),
                "wire_last_arrival_s": sum(map(min, zip(*(r["wire"]["call_s"] for r in rows)))),
                "owned_sites": [r["owned_sites"] for r in rows],
                "owned_compute_s": [r["owned_compute_s"] for r in rows],
                "held": [r["held"] for r in rows],
            }
            log(json.dumps({"multihost": f"group {name}", "app": app, **summary[f"{name} {app}"], "card": card}))
        for pid, launched in enumerate(rank_launched):
            for kernel in sorted({k for app in apps for k in MH_PATH_KERNELS[app]}):
                check(launched[kernel] > 0, f"group {name}, rank {pid}: never launched {kernel}")
        log(json.dumps({"multihost": f"group {name}", "launches_by_rank": rank_launched, "card": card}))
        log(f"multihost group {name}: {nprocs} gloo ranks on {reports[0]['topology']['device_name']}, "
            f"{group_s:.3f} s with start-up; every rank's digests == the single-process runs'; each site's jobs "
            f"on one rank; every launch held")
    return totals


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # torch.compile (the flex_attention yardstick) caches inside the checkout
    # and compiles in this process, so no worker pool outlives the script
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "torchinductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    from repro_torch.core.apriori import (
        LocalMineResult,
        apriori_join,
        item_supports,
        pack_itemsets,
    )
    from repro_torch.core import kmeans as tkm
    from repro_torch.core import vclustering as tvc
    from repro_torch.core.gfm import CommLog, topdown_search
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import transformer  # noqa: F401  (the serving slice, for the import check)
    from repro_torch.runtime import GridRuntime
    from repro_torch.train import steps  # noqa: F401
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
        PTXAS[name] = ptxas_report(text)
        injected = 0
        for line in text.splitlines():
            if "C7519" in line:  # "warpgroup.arrive is injected": counted, not logged line by line
                injected += 1
            elif "registers" in line or "spill" in line or "Compiling entry" in line or "warning" in line:
                log(f"ptxas {name}: {line.strip()}")
        if injected:
            log(f"ptxas {name}: {injected} wgmma fences (warpgroup.arrive) injected by the compiler (C7519)")
    smem_of = _build.load("flash_attention_wgmma").flash_attention_wgmma_smem_bytes
    smem_of.argtypes, smem_of.restype = [ctypes.c_int], ctypes.c_size_t
    log("flash_attention_wgmma dynamic shared memory a CTA, bytes by Dh: "
        + json.dumps({dh: smem_of(dh) for dh in (64, 128, 192, 256)}))

    t0 = time.perf_counter()
    dense, sites = gfm_sites(dev)
    log(f"data_s: {time.perf_counter() - t0:.3f} sites {[db.n_tx for db in sites]}")

    # ---- phase 2: every kernel against its plain version on the card ------
    gen = torch.Generator().manual_seed(0)

    def words(shape):
        a = torch.randint(-(2**31), 2**31, shape, generator=gen, dtype=torch.int64)
        b = torch.randint(-(2**31), 2**31, shape, generator=gen, dtype=torch.int64)
        return (a | b).to(torch.int32).to(dev)

    def masks_of(s, c, w, n_zero=2, dense=False):
        """Masks of 1-3 items (40 spread over the words when dense, or all
        32 bits of the one word at W = 1), the first n_zero all zero."""
        out = np.zeros((s, c, w), dtype=np.uint32)
        rng = np.random.default_rng(s * 1000 + c + w)
        for i in range(s):
            for j in range(c):
                its = rng.choice(32 * w, size=min(40, 32 * w) if dense else rng.integers(1, 4), replace=False)
                out[i, j] = pack_itemsets([tuple(sorted(its))], 32 * w)[0]
        out[:, :n_zero] = 0  # all-zero masks count every row
        return torch.from_numpy(out.view(np.int32)).to(dev)

    def hold(tx, masks, mc, label):
        """All four wrappers against the plain versions, exact equality; and
        the count's first stage, the transpose, against its plain version
        bit for bit."""
        if tx.shape[0] and tx.shape[1]:
            check(torch.equal(ops.vertical_bitmap(tx), ref.vertical_bitmap_ref(tx)),
                  f"{label}: the transpose differs from ref.vertical_bitmap_ref")
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

    for s, n, c, w, many in [(1, 700, 37, 1, False), (1, 700, 37, 32, False), (4, 700, 37, 32, False),
                             (4, 700, 37, 3, False), (1, 0, 5, 2, False), (1, 50, 0, 2, False), (2, 1, 1, 1, False),
                             (2, 1, 9, 3, True), (3, 33, 40, 32, False), (2, 33, 40, 3, True),
                             (2, 700, 64, 32, True), (1, 31, 9, 1, True), (3, 25_000, 18, 32, False)]:
        mc = torch.tensor([1 + 150 * i for i in range(s)], dtype=torch.int32, device=dev)
        tx = words((s, n, w))
        tx[:, n - min(n, 2) :] = 0  # zero pad rows, as the stacked sites have
        hold(tx, masks_of(s, c, w, dense=many), mc, f"S{s}-N{n}-C{c}-W{w}{'-dense' if many else ''}")

    def bound(tx, masks, out_bytes):
        """The least time one call on these inputs could take: the bytes it
        must move (tx and masks read once, outputs written once) over the
        HBM rate, or the word operations of the bit-sliced count over the
        int32 rate: ceil(N/32) x (items + 1) a (site, candidate), one AND a
        32-row word for each item and one popcount.  Also returns the
        horizontal count's word tests (N x the non-zero mask words: a zero
        mask word always matches), the bound the kernel was held to before."""
        s, n, _ = tx.shape
        items = int(torch.bitwise_and(masks[..., None] >> torch.arange(32, device=masks.device), 1).sum())
        needed_ops = -(-n // 32) * (items + s * masks.shape[1])
        horizontal_ops = n * int((masks != 0).sum())
        t_bytes = ((tx.numel() + masks.numel()) * 4 + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = needed_ops / INT32_OPS_PER_S * 1e3
        return (max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes"), needed_ops,
                horizontal_ops)

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
        # the two stages apart: the transpose, then the count from its output
        vt = ops.vertical_bitmap(tx)
        mcs = None if name == "support_count" else mc
        stages = {"transpose_ms": median_ms(lambda: ops.vertical_bitmap(tx), reps=30),
                  "count_ms": median_ms(lambda: ops.support_count_vertical_sites(vt, masks, n, mcs), reps=30)}
        b_ms, b_by, needed_ops, horizontal_ops = bound(tx, masks, out_bytes)
        row = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None, **stages}
        log(json.dumps({
            "kernel": name, "at": label, "shape": {"S": s, "N": n, "C": c, "W": w}, **row,
            "needed_word_ops": needed_ops, "horizontal_word_tests": horizontal_ops, "dense_word_tests": s * n * c * w,
            "horizontal_ops_bound_ms": horizontal_ops / INT32_OPS_PER_S * 1e3,
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
    kernel_launches = kernel_launches_of(main_launches)
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
    # dense data (its packed bit columns); and the result is no toy
    g_min = int(np.ceil(MINSUP * N_TX))
    cols = dense_columns(dense)
    for its, c in res.frequent.items():
        got = recount(cols, its)
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

    launches_by_path, itemset_refs = run_itemset_family(dev, card, ops, dense, sites, res, hold, measure, bound,
                                                        GridRuntime)
    launches_by_path = {"gfm": kernel_launches, **launches_by_path}

    kmeans_row, cluster_refs = run_clustering(dev, card, ops, ref, tkm, tvc, GridRuntime)

    # what phase 22 holds the multi-host runs to: phases 3, 17 and 6
    single = {app: json.loads(json.dumps(d)) for app, d in [("gfm", want_digest), *itemset_refs.pop("grid").items()]}
    single["vclustering"] = cluster_refs["labels"][CL_PARAMS["seed"]]
    pooled = cluster_refs.pop("points")

    # ---- phase 21: the mining service on both paths' data ------------------
    service = run_service(dev, card, ops, ref, dense, pooled, {**itemset_refs, **cluster_refs}, hold, measure)
    del itemset_refs, cluster_refs
    launches_by_path["service"] = {k: service["launches"][k] for k in ("support_count", "support_count_prune")}
    kmeans_row["launches_by_path"]["service"] = service["launches"]["kmeans_assign"]
    kmeans_row["service"] = service["largest"]["kmeans_assign"]

    # ---- phase 22: multi-host execution, gloo ranks sharing the card -------
    multihost = run_multihost(card, dense, pooled, single)
    del pooled
    launches_by_path["multihost"] = {k: multihost[k] for k in ("support_count", "support_count_prune")}
    kmeans_row["launches_by_path"]["multihost"] = multihost["kmeans_assign"]

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
                                   "at", "shape", "transpose_ms", "count_ms")},
            "path_ms": sum(r["ms"] for r in rows[name]),
            "path_plain_ms": sum(r["plain_ms"] for r in rows[name]),
            "path_bound_ms": sum(r["bound_ms"] for r in rows[name]),
            "launches_by_path": {path: n[name] for path, n in launches_by_path.items()},
            "service": service["largest"].get(name),
        })
    kernels.append(kmeans_row)
    kernels.append(run_xlstm(dev, card, ops, ref))
    kernels.append(run_gemma2(dev, card, ops, ref))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    if "--multihost-child" in sys.argv[1:]:
        multihost_child(sys.argv[1:])
    else:
        main()
