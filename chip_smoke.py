"""Chip smoke for the PyTorch port: build the CUDA kernels, hold each one
against its plain PyTorch version on the card, then mine GFM end to end at
the IBM Quest T10I4D100K shape through ``GridRuntime.run("gfm")``.

    python3 chip_smoke.py

It then breaks the main path down (device busy time and kernels by
torch.profiler, host functions by cProfile), records the inputs of every
kernel launch of one more run of it, and holds and times each kernel at
those inputs.  Needs one CUDA card and ``nvcc``; exits non-zero without
them, or when any check fails.  Imports the port only (``src/repro_torch``), never jax and
never the JAX package.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit, and the one before that lists every kernel with its
launches on the main path and, at the path's largest launch of it, its
time, its plain version's time and its bound.
"""

from __future__ import annotations

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

# the main path: IBM Quest T10I4D100K (100,000 transactions, 1,000 items,
# average length 10, pattern length 4), over 4 grid sites
N_TX, N_ITEMS, N_SITES, K, MINSUP = 100_000, 1000, 4, 4, 0.01
MAIN_C = 2048  # candidates per site at the fixed level-2 kernel shape
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def profile_main_path(run_once) -> None:
    """Where the main path's time goes: the device's busy time and kernel
    breakdown from torch.profiler, and the host's top functions from
    cProfile (each over its own run, so neither pays the other's cost)."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_once()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    device = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0)
        if us > 0:
            device.append((evt.key, us / 1e3, evt.count))
    device.sort(key=lambda e: -e[1])
    busy_ms = sum(ms for _, ms, _ in device)
    log(json.dumps({"profile": {
        "wall_ms": bare_ms, "traced_wall_ms": traced_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / traced_ms if traced_ms > 0 else None,
        "device_top": [{"name": n[:80], "ms": ms, "calls": c} for n, ms, c in device[:8]],
    }}))
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
    log(json.dumps({"host_profile_top": [
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
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
