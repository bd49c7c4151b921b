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
    kmeans and vclustering, with cross-request fusion, then its mixed burst
    (15 requests) replayed without, its results held to the paths' own runs
    above;
  * the autotuner (``kernels.autotune``) at the mining kernels' own
    launches above: every launch variant timed, held bit for bit to the
    default and the default to the plain version, the tuned table saved
    and loaded, then GFM and vclustering run again under auto blocks, held
    to their digests with no search;
  * multi-host execution (``MultiHostBackend`` over gloo): a group of 2
    ranks shipping each ready wave in one collective (the three miners at
    T10I4D100K, vclustering at Table 3) and one of 3 ranks shipping once
    a job (the three miners), every rank on the one card and held to the
    single-process runs above; each rank is this script run again with
    ``--multihost-child``, which prints one report line and never the
    final line;
  * the per-site mesh (``launch.mesh.make_site_mesh``): 4 gloo ranks on
    the card, one a site of the first quarter of the Table 3 points split
    4 ways, each running
    ``vcluster_shard_map`` and ``GridRuntime.for_sites(4)`` in the
    SPMD-redundant mode with the merge's gather as the one collective,
    held bit for bit to the pooled runs of the same split (each rank is
    this script run with ``--mesh-child``);
  * the MoE archs at their published widths, deepseek-moe-16b at full
    depth (2 x 4,096 tokens) and mixtral-8x22b cut to 4 of its 56 layers
    (8,192 tokens, twice its window), and zamba2-1.2b (Mamba-2 with its
    shared attention block, 4 x 4,096 tokens) at full depth: scoring
    through the bfloat16 flash kernel at Dh 128 and 64, serving a prefill
    and greedy decode steps, each flash launch held and timed;
  * the encoder-decoder seamless-m4t-large-v2 (4 x 4,096 decoder tokens,
    each with 1,024 stub frames through its 24-layer encoder) and
    phi-3-vision-4.2b (576 stub patches in front of 3,520 tokens, Dh 96),
    both at published widths and full depth: scoring through the bfloat16
    flash kernel, non-causal in the encoder and at Sq 4,096 over Skv 1,024
    in the cross-attention, serving a prefill (seamless's encoder and cross
    launches held too) and greedy decode steps;
  * training stablelm-1.6b at its published widths (4 x 4,096 tokens a
    step, bf16, remat "full", AdamW): two steps twice from one seed,
    bit-identical, the loss falling, a grad_accum-2 step, a profiled step,
    and the reduced float32 step on the card against the CPU, in a child
    process (``--train-child``) with deterministic algorithms; in the same
    child GridLocal over two pods of it (2 x 4,096 tokens a pod, 2 steps,
    1 merge of int8 deltas; the pods bit-identical after the merge, the
    loss falling, each step and merge timed, the reduced float32 GridLocal
    step on the card against the CPU in both merge modes), then the
    training entry (``launch.train``) at a reduced width resumed from a
    checkpoint, its step directory byte for byte the unbroken run's; in
    this process while that child runs, the one-card dry run (``launch.dryrun``) of the train step's cell on fake tensors,
    its estimated peak then held within 10% of the measured one at
    grad_accum 1 and 2, with its counted FLOPs over the measured step (mfu,
    hfu) and the data sheet's roofline;
  * training gemma2-2b and zamba2-1.2b at their published widths and
    depth in the same child, as stablelm is trained: two steps twice from
    one seed, bit-identical, a profiled step, the peak within 10% of the
    committed one-card dry run's estimate, and the reduced float32 step on
    the card against the CPU; then xlstm-1.3b at its published widths and
    one period of its pattern (8 layers: the sLSTM's eager step loop in
    the backward), one step twice, its peak printed.

The mining kernels are also held at their wide shapes: the support count
past 32 words (1,024 items) and the K-Means assignment past D = 128.

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
bound and the nearest library call's time (and, for the mining kernels,
the autotuned config there with its time beside the default's).
"""

from __future__ import annotations

import ast
import bisect
import ctypes
import hashlib
import json
import math
import os
import re
import statistics
import socket
import subprocess
import sys
import threading
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
CL_INLINE_SITES = 20  # phase 6's inline + async run clusters the first 20 sites (5e6 points)
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
# the replay with fusion off plays one burst of the trace, the mixed one
# (burst SV_REPLAY_BURST: 15 requests of gfm, fdm, cd_apriori, apriori and
# topk at tx version 2), on a service built as the fused run's was: no
# item before it appends, so its requests meet the same versions; each
# serves the fused run's digest for the request in its place.  Cut for the
# script's 1,200 s limit: the replay of the first 36 requests (up to tx
# version 4) took 57.0 s on an H100 80GB HBM3 at 700 W, 43.9 s of it the
# first two bursts (vclustering and cold kmeans)
SV_REPLAY_BURST = 2

# phase 23: the autotuner at the mining kernels' own launches, recorded by
# the phases above into TUNE_AT (label -> ("support_count" or
# "support_count_prune", tx, masks, min_counts or None), or ("kmeans", xs,
# centres)).  The default's time at each is held within AT_PERF_RTOL of
# PERF.md §6's row for it (its shape, its ms), taken on an H100 80GB HBM3 at
# 700 W: checked at that power limit and shape, logged otherwise; GFM's
# three levels against their sum there.
TUNE_AT: dict = {}
WALLS: dict = {}  # host walls of the paths phase 23 runs again (phases 3 and 6)
VC_POINTS: dict = {}  # phase 6's points, which phase 23 clusters again
AT_PERF_MS = {
    "GFM level 4": ({"S": 4, "N": 25_000, "C": 10_883}, 0.1076),
    "GFM recount": ({"S": 3, "N": 25_000, "C": 18}, 0.0241),
    "FDM level 4": ({"S": 4, "N": 25_000, "C": 10_662}, 0.1053),
    "service largest": ({"S": 12, "N": 25_000, "C": 10_897}, 0.2766),
    "run_many GFM level 4": ({"S": 16, "N": 25_000}, 0.3369),
    "vclustering": ({"S": 200, "N": 250_000, "K": 20, "D": 8}, 1.0078),
    "run_many vclustering": ({"S": 400, "N": 250_000, "K": 20, "D": 8}, 2.0036),
    "service kmeans": ({"S": 1, "N": 51_000_000, "K": 12, "D": 8}, 0.7021),
}
AT_PERF_GFM_LEVELS = ({"S": 4, "N": 25_000}, 0.2492)
AT_PERF_RTOL = 0.10
AT_PERF_CARD = "700.00 W"
AT_TABLE = os.path.join(ROOT, "build", "autotune_table.json")

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
# phases 25-26: the MoE archs and zamba2 at their published widths, scoring
# through the bfloat16 flash kernel (Dh 128, and Dh 64 in zamba2's shared
# block) and serving (prefill through the chunked oracle, greedy decode).
# deepseek-moe-16b at full depth (28 layers, 16,375,728,128 fp32 parameters,
# 65.5 GB); mixtral-8x22b cut from 56 layers to 4 (2.50e9 parameters, 10.0 GB
# fp32 a layer: all 56 take 562 GB); zamba2-1.2b at full depth (38 Mamba-2
# layers, the shared block 6 times).  Each: the layers (None: all), the
# scoring batch and length, the serving prompt (scoring's batch, into a
# cache of the scoring length) and greedy decode steps, and the flash
# launches a scoring forward makes (one an attention layer or shared run)
# and a prefill makes (none: prefill's self-attention takes the oracle).
# Phase 27: the encoder-decoder and the patch frontend at published widths
# and full depth, with their stub frontends' embeddings drawn by TokenStream
# (seed 1).  seamless-m4t-large-v2 (24 encoder and 24 decoder layers,
# 1,632,260,096 fp32 parameters): 4 x 4,096 decoder tokens, each with 1,024
# frames; a scoring forward launches flash 72 times (24 encoder layers,
# non-causal; 24 decoder self-attentions, causal; 24 cross-attentions,
# non-causal at Sq 4,096 over Skv 1,024), a prefill 48 times (the encoder
# and the cross-attentions).  phi-3-vision-4.2b (phi3-mini's 32 layers at Dh
# 96, 3,722,578,944 parameters): 576 patches in front of 3,520 tokens, 4,096
# positions (the repo's train_4k length counts the prefix), 32 launches a
# scoring forward; the cache holds 576 + seq positions
LM_RUNS = {
    "deepseek-moe-16b": {"n_layers": None, "batch": 2, "seq": 4096, "prompt": 4064, "decode": 32, "flash": 28,
                         "prefill_flash": 0},
    "mixtral-8x22b": {"n_layers": 4, "batch": 1, "seq": 8192, "prompt": 8160, "decode": 32, "flash": 4,
                      "prefill_flash": 0},
    "zamba2-1.2b": {"n_layers": None, "batch": 4, "seq": 4096, "prompt": 4000, "decode": 64, "flash": 6,
                    "prefill_flash": 0},
    "seamless-m4t-large-v2": {"n_layers": None, "batch": 4, "seq": 4096, "prompt": 4064, "decode": 32,
                              "flash": 72, "prefill_flash": 48},
    "phi-3-vision-4.2b": {"n_layers": None, "batch": 4, "seq": 3520, "prompt": 3488, "decode": 32, "flash": 32,
                          "prefill_flash": 0},
}
LM_PHASE = {"deepseek-moe-16b": 25, "mixtral-8x22b": 25, "zamba2-1.2b": 26, "seamless-m4t-large-v2": 27,
            "phi-3-vision-4.2b": 27}
LM_PARAMS = {"deepseek-moe-16b": 16_375_728_128, "zamba2-1.2b": 1_104_777_344,
             "seamless-m4t-large-v2": 1_632_260_096, "phi-3-vision-4.2b": 3_722_578_944}
# decode steps in the profiled runs (16 until phase 33 needed the seconds)
LM_PROFILE_DECODE = 8
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


# torch.profiler drops the first device events of a trace: 0-15 of them in
# tools/flash_trace_count.py's process, 62-67 in this script's phase 16,
# where the first flash kernel of the run was among them in 3 of 5 runs.
# Each traced run is led by this many spin kernels (torch.cuda._sleep, which
# no path launches), so the loss falls on them; they are left out of every
# number, and the row reports how many the trace kept.
TRACE_WARMUP = 1000
SPIN_KERNEL = "spin_kernel"


def profile_main_path(run_once, path: str = "gfm", phases=(), kernel: str = "", n_host: int = 15,
                      bare: bool = True, host: bool = True, host_ops: bool = True) -> dict:
    """Where the main path's time goes: the device's busy time and kernel
    breakdown from torch.profiler, and the host's top functions from
    cProfile (each over its own run, so neither pays the other's cost).
    The traced run is led by TRACE_WARMUP spin kernels, left out of every
    number.

    ``phases`` names port functions, as (module, attribute, label), to
    wrap during the traced run only: each call becomes a record_function
    window that ends in a synchronize, and its row gives the window's host
    wall and the device time of the kernels that started inside it.
    ``kernel`` names a device kernel (a substring of its name) whose share
    of the device's busy time the row also gives, with each of its events
    in the trace in order (start from the first, duration, CUPTI
    correlation id).  ``n_host`` host functions are logged.  ``bare`` and
    ``host`` False skip the untraced and the cProfiled run (each one more
    call of ``run_once``); ``host_ops`` False traces the device alone,
    without a host event an op (no ``phases`` then), which costs a step of
    10^5 eager ops less of the profiler's host time.  Returns the row."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if bare:
        run_once()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3 if bare else None

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
        check(host_ops or not phases, "the phases' windows are host events")
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
        with profile(activities=activities) as prof:
            for _ in range(TRACE_WARMUP):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
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
    named = []  # (start, duration, correlation id) of each event of ``kernel``
    spins = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and SPIN_KERNEL in e.name():
            spins.append(e.start_ns())
        elif e.device_type() == cuda and not e.is_user_annotation():
            kernels.append((e.start_ns(), e.end_ns()))
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
            if kernel and kernel in e.name():
                named.append((e.start_ns(), e.duration_ns(), e.correlation_id()))
        elif e.device_type() == cpu and e.name() in labels:
            windows.append((e.name(), e.start_ns(), e.end_ns()))
    busy_ms = sum(b - a for a, b in kernels) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    # spin kernels after the run's first kernel are marks that ``run_once``
    # launched itself: each pair of them brackets a window of the run
    first = min((a for a, _ in kernels), default=None)
    marks = sorted(t for t in spins if first is not None and t > first)
    out = {
        "path": path, "wall_ms": bare_ms, "traced_wall_ms": traced_ms, "device_busy_ms": busy_ms, "host_ops": host_ops,
        "device_idle_share": 1.0 - busy_ms / traced_ms if traced_ms > 0 else None,
        "device_events": len(kernels), "warmup_kept": f"{len(spins) - len(marks)} of {TRACE_WARMUP}",
        "device_top": [{"name": n[:80], "ms": ms, "calls": c} for n, (ms, c) in top],
    }
    if marks:
        check(len(marks) % 2 == 0, f"{path}: {len(marks)} marks, an odd number, bracket no windows")
        ordered = sorted(kernels)
        starts = [a for a, _ in ordered]
        inside = [k for lo, hi in zip(marks[::2], marks[1::2])
                  for k in ordered[bisect.bisect_right(starts, lo):bisect.bisect_left(starts, hi)]]
        in_ms = sum(b - a for a, b in inside) / 1e6
        out["marked"] = {"windows": len(marks) // 2, "device_events": len(inside), "device_busy_ms": in_ms,
                         "share_of_events": len(inside) / len(kernels),
                         "share_of_device_busy": in_ms / busy_ms if busy_ms > 0 else None,
                         "window_ms": (sum(b - a for a, b in zip(marks[::2], marks[1::2]))) / 1e6}
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
        named.sort()
        out["kernel"]["events"] = [[(a - named[0][0]) / 1e6, d / 1e6, c] for a, d, c in named]
    out["trace_processing_s"] = time.perf_counter() - t0
    log(json.dumps({"profile": out}))
    if not host:
        return out
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
        if app == "fdm":
            TUNE_AT["FDM level 4"] = ("support_count", *calls["support_count_sites"][top], None)
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
        if app == "gfm":
            TUNE_AT["run_many GFM level 4"] = ("support_count_prune", *largest["support_count_prune"][1:4])
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
    float32, the planted component of each site point, the points before
    the split, (CL_POINTS, CL_DIM) (the service's dataset), and the planted
    component of each of those (int8)."""
    from repro_torch.data.synthetic import gaussian_mixture, split_sites

    pts, comp = gaussian_mixture(7, CL_POINTS, CL_DIM, n_components=CL_COMPONENTS, spread=20.0, sigma=0.8)
    xs_np = split_sites(pts, CL_SITES, seed=1)
    # the planted component of every site point, from the permutation
    # split_sites draws (numpy only: independent of the code under test)
    truth = comp[np.random.default_rng(1).permutation(len(pts))[: xs_np.shape[0] * xs_np.shape[1]]]
    return xs_np, truth, pts, comp.astype(np.int8)


MH_DATA = os.path.join(ROOT, "build", "multihost_smoke")  # phase 22's data, read by its ranks


def start_clustering_points() -> tuple:
    """``clustering_points`` drawn on a thread of its own once the kernels
    are built, while phases 2-5 run (numpy's fills, gathers and shuffles run
    without the GIL); the thread then writes the split for phase 22's ranks
    (``MH_DATA``).  Returns (thread, box): the box gets the points, the
    seconds each part took, or the error, which phase 6 raises."""
    box = {"t0": time.perf_counter()}

    def draw():
        try:
            box["points"] = clustering_points()
            box["generate_s"] = time.perf_counter() - box["t0"]
            t0 = time.perf_counter()
            os.makedirs(MH_DATA, exist_ok=True)
            np.save(os.path.join(MH_DATA, "points.npy"), box["points"][0])
            box["write_s"] = time.perf_counter() - t0
        except BaseException as e:  # raised by phase 6
            box["error"] = e

    th = threading.Thread(target=draw, name="clustering-points", daemon=True)
    th.start()
    return th, box


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


def purity_of(labels: np.ndarray, truth: np.ndarray, m: int) -> float:
    """Share of points in the majority planted component of their global
    cluster (``m`` slots)."""
    table = np.bincount(labels.astype(np.int64) * CL_COMPONENTS + truth, minlength=m * CL_COMPONENTS)
    return float(table.reshape(m, CL_COMPONENTS).max(axis=1).sum() / len(labels))


def labels_digest(res) -> dict:
    """A vclustering result in a form that two runs are compared by: the
    SHA-256 of its label bytes, and its merge counts."""
    return {"labels_sha256": hashlib.sha256(res.labels.contiguous().cpu().numpy().tobytes()).hexdigest(),
            "n_global": int(res.merged.n_global), "n_merges": int(res.merged.n_merges)}


def run_clustering(dev, card, ops, ref, tkm, tvc, GridRuntime, points) -> tuple:
    """The clustering slice on the card: the K-Means kernel against its
    plain version, the main path at full size (``points``:
    ``start_clustering_points``' thread and box) with its checks, its
    profile, and the kernel at the path's own inputs.  Returns the
    kernel's row of the ``kernels`` line, and what phase 21 holds the
    service to: the points before the split, their planted components, and
    the digests of the seed 0 and seed 1 runs."""
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

    # F3: past D = 128 the wide kernel (one thread a point, D in chunks
    # through shared memory): its edges held bit for bit, then timed at a
    # path-sized shape with its plain version, bound and cdist
    wide_rows = []
    for s, n, k, d, dup, on_center in [(1, 1000, 20, 129, True, True), (3, 777, 70, 160, True, True),
                                       (2, 513, 33, 256, False, True), (1, 300, 1, 200, False, False)]:
        xs = (torch.randn((s, n, d), generator=gen) * 5).to(dev)
        cs = (torch.randn((s, k, d), generator=gen) * 5).to(dev)
        if dup and k > 1:
            cs[:, k - 1] = cs[:, 0]
        if on_center:
            xs[:, : min(n, k)] = cs[:, : min(n, k)]
        label = f"S{s}-N{n}-K{k}-D{d}"
        hold_assign(xs, cs, label)
        a, m = ops.kmeans_assign_sites(xs, cs)
        ra, rm = ref.kmeans_assign_sites_ref(xs, cs)
        check(torch.equal(a, ra) and torch.equal(m, rm), f"{label}: the wide kernel is not bit-identical to the plain")
    gen_dev = torch.Generator(device=dev).manual_seed(0)
    for d in (129, 160, 256):
        px = torch.randn((4, 70_001, d), generator=gen_dev, device=dev) * 5
        pc = torch.randn((4, 20, d), generator=gen_dev, device=dev) * 5
        a, m = ops.kmeans_assign_sites(px, pc)
        ra, rm = ref.kmeans_assign_sites_ref(px, pc)
        check(torch.equal(a, ra) and torch.equal(m, rm), f"D={d}: the wide kernel is not bit-identical to the plain")
        t_bytes, t_ops, _, _ = kmeans_bound(px, pc)
        wide_rows.append({
            "shape": {"S": 4, "N": 70_001, "K": 20, "D": d}, "max_abs_err": 0.0,
            "ms": median_ms(lambda: ops.kmeans_assign_sites(px, pc), reps=30),
            "plain_ms": median_ms(lambda: ref.kmeans_assign_sites_ref(px, pc), reps=5, warmup=1),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": median_ms(lambda: torch.cdist(px, pc, compute_mode="use_mm_for_euclid_dist").min(-1),
                                    reps=5, warmup=1),
        })
        log(json.dumps({"kernel": "kmeans_assign_wide", **wide_rows[-1], "card": card}))
        del px, pc

    # the wide kernel on a path: vclustering at D = 160 (8 sites of 25,000
    # points of a 12-component mixture), every launch counted and held
    from repro_torch.data.synthetic import gaussian_mixture, split_sites

    pts, comp = gaussian_mixture(11, 200_000, 160, n_components=CL_COMPONENTS, spread=20.0, sigma=0.8)
    xw = torch.from_numpy(split_sites(pts, 8, seed=1)).to(dev)
    truth_w = comp[np.random.default_rng(1).permutation(len(pts))[: xw.shape[0] * xw.shape[1]]]
    ops.reset_launches()
    out_w = []
    t0 = time.perf_counter()
    calls = record_kmeans_launches(ops, lambda: out_w.append(GridRuntime(device=dev).run("vclustering", xw, CL_PARAMS)))
    torch.cuda.synchronize()
    wide_wall = time.perf_counter() - t0  # with the recorder's copies of the centres
    res_w = out_w[0].result
    wide_launches = ops.LAUNCHES["kmeans_assign_sites"] + ops.LAUNCHES["kmeans_assign"]
    check(wide_launches == CL_PARAMS["iters"] + 1 == len(calls),
          f"vclustering at D=160 launched kmeans {wide_launches} times, {len(calls)} recorded")
    purity_w = purity_of(res_w.labels.cpu().numpy().reshape(-1), truth_w, res_w.merged.labels.shape[0])
    for px, pc in calls:
        a, m = ops.kmeans_assign_sites(px, pc)
        ra, rm = ref.kmeans_assign_sites_ref(px, pc)
        check(torch.equal(a, ra) and torch.equal(m, rm), "vclustering at D=160: a launch differs from the plain")
    px, pc = calls[-1]
    t_bytes, t_ops, _, _ = kmeans_bound(px, pc)
    wide_kernel = {
        "name": "kmeans_assign_wide", "route": "cuda", "source": "src/repro_torch/kernels/csrc/kmeans_assign.cuh",
        "replaces": "src/repro/kernels/kmeans_assign.py:45", "launches": wide_launches, "max_abs_err": 0.0,
        "ms": median_ms(lambda: ops.kmeans_assign_sites(px, pc), reps=30),
        "plain_ms": median_ms(lambda: ref.kmeans_assign_sites_ref(px, pc), reps=5, warmup=1),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": median_ms(lambda: torch.cdist(px, pc, compute_mode="use_mm_for_euclid_dist").min(-1),
                                reps=5, warmup=1),
        "library": "torch.cdist(compute_mode='use_mm_for_euclid_dist').min(-1)",
        "at": "vclustering at D=160, final assignment", "shape": dict(zip("SNKD", (*px.shape[:2], pc.shape[1], 160))),
        "launches_by_path": {"vclustering D=160": wide_launches}, "wide": wide_rows,
    }
    log(f"clustering at D=160 (8 x 25,000 points, wide kernel): {wide_wall:.3f} s host wall, {wide_launches} "
        f"launches, each bit-identical to the plain version; n_global {res_w.merged.n_global}, purity {purity_w:.6f}")
    log(json.dumps({"kernel": "kmeans_assign_wide", **{k: v for k, v in wide_kernel.items() if k != "wide"},
                    "card": card}))
    check(purity_w >= CL_PURITY, f"vclustering at D=160: purity {purity_w:.6f}, want >= {CL_PURITY}")
    del xw, pts, comp, calls, px, pc, res_w, out_w

    # ---- phase 6: the clustering main path, at full size -------------------
    t0 = time.perf_counter()
    th, box = points
    th.join()
    if "error" in box:
        raise box["error"]
    waited_s = time.perf_counter() - t0
    xs_np, truth, pooled, comp = box.pop("points")
    t0 = time.perf_counter()
    xs = torch.from_numpy(xs_np).to(dev)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    del xs_np
    n_total = xs.shape[0] * xs.shape[1]
    log(f"clustering data: {tuple(xs.shape)} f32, {xs.numel() * 4 / 1e9:.3f} GB; generated in {box['generate_s']:.3f} s "
        f"on a thread from the end of the build, then written for phase 22 in {box['write_s']:.3f} s; phase 6 waited "
        f"{waited_s:.3f} s for it; host to device {h2d_s:.3f} s")

    def run_once(data=xs, **kw):
        return GridRuntime(device=dev, **kw).run("vclustering", data, CL_PARAMS)

    def timed_run(label, data=xs, **kw):
        t0 = time.perf_counter()
        out = run_once(data, **kw)
        torch.cuda.synchronize()
        log(f"clustering {label}: {time.perf_counter() - t0:.3f} s host wall")
        return out.result

    ops.reset_launches()
    t0 = time.perf_counter()
    run = run_once()
    torch.cuda.synchronize()
    wall = WALLS["vclustering"] = time.perf_counter() - t0
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
    purity = purity_of(lab, truth, m)
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

    # inline + async over the first CL_INLINE_SITES sites, at the same size a
    # site: over all 200 its 4,200 single-site launches took about 50 s
    sub = xs[:CL_INLINE_SITES]
    batched = timed_run(f"batched + staged run of the first {CL_INLINE_SITES} sites", sub)
    ops.reset_launches()
    inline = timed_run(f"inline + async run of the first {CL_INLINE_SITES} sites", sub, backend="inline",
                       schedule="async")
    inline_launches = {k: v for k, v in ops.LAUNCHES.items() if k.startswith("kmeans")}
    log(f"clustering inline + async launches {inline_launches}")
    want_inline = (CL_PARAMS["iters"] + 1) * CL_INLINE_SITES
    check(inline_launches == {"kmeans_assign": want_inline, "kmeans_assign_sites": 0},
          f"inline + async launched {inline_launches}, want kmeans_assign {want_inline} times")
    check(torch.equal(inline.labels, batched.labels) and (inline.merged.n_global, inline.merged.n_merges)
          == (batched.merged.n_global, batched.merged.n_merges), "inline + async differs from batched + staged")
    del inline, batched, sub
    log(f"clustering: batched + staged == inline + async on the first {CL_INLINE_SITES} sites")
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
    # the profile's untraced run is the second batched run: it must repeat
    # the first bit for bit
    again = []

    def run_kept():
        out = run_once()
        if not again:
            again.append(out.result)
        return out

    profile_main_path(run_kept, path="vclustering", phases=[
        (tkm, "kmeans_plus_plus_sites", "seeding"), (tkm, "lloyd_sites", "lloyd"),
        (tvc, "merge_subclusters", "merge loop"), (tvc, "perturb_sites", "perturbation loop"),
    ])
    check(torch.equal(again[0].labels, labels) and (again[0].merged.n_global, again[0].merged.n_merges)
          == (res.merged.n_global, res.merged.n_merges), "a second batched run (the profile's untraced one) differs")
    log("clustering: the profile's untraced run, a second batched run, repeats the first bit for bit")
    del again

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
    TUNE_AT["vclustering"] = ("kmeans", px, pc)
    VC_POINTS["xs"] = xs
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
    refs = {"points": pooled, "components": comp,
            "labels": {sd: labels_digest(r) for sd, r in zip(CL_FUSE_SEEDS, (res, serial1))}}
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
    TUNE_AT["run_many vclustering"] = ("kmeans", *last)
    fused_ms = median_ms(lambda: ops.kmeans_assign_sites(*last), reps=30)
    log(f"clustering run_many kmeans_assign_sites, final assignment {tuple(last[0].shape)}: {fused_ms:.4f} ms "
        f"(median of 30), bound {max(kmeans_bound(*last)[:2]):.4f} ms; the serial path's {launch_ms[-1]:.4f} ms at "
        f"{CL_SITES} sites; {card}")
    del fused, serial1, last
    torch.cuda.empty_cache()
    row["launches_by_path"] = {"vclustering": n_launch, "run_many vclustering": fused_launches}
    row["wide"] = wide_rows  # D > 128: the wide kernel, its own entry of the kernels line
    refs["wide_kernel"] = wide_kernel
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

    def play(svc, items=None, start: int = 0) -> tuple:
        """The trace's items ``start`` to ``items`` (all when None) through
        ``svc``: (request ids, wall s, fairness violations, the wall s at the
        end of each item)."""
        rids, unfair, marks = [], [], []
        t0 = time.perf_counter()
        for item in trace[start:items]:
            if item[0] == "append":
                (svc.append_transactions if item[1] == "tx" else svc.append_points)(item[1], item[2])
                marks.append(time.perf_counter() - t0)
                continue
            for tenant, app, dataset, params in item[1]:
                rids.append(svc.submit(tenant, app, dataset, params))
            # every tenant is backlogged: audit the round-robin bound over the
            # picks that drain this burst's guaranteed backlog (as the CLI does)
            window = len(svc.pick_log) + min(svc.queues.depth(t) for t in tenants) * len(tenants)
            svc.drain(max_requests=SV_MAX_PER_STEP)
            unfair.extend(fairness_violations(svc.pick_log[:window], tenants, window))
            torch.cuda.synchronize()
            marks.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return rids, time.perf_counter() - t0, unfair, marks

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
    (rids, fused_s, unfair, fused_marks), sc_calls = played[0], played[1]
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
    start = [i for i, item in enumerate(trace) if item[0] == "burst"][SV_REPLAY_BURST]
    check(all(item[0] == "burst" for item in trace[:start]), "an append precedes the replayed burst")
    offset = sum(len(item[1]) for item in trace[:start])
    svc_serial, _ = build(fuse=False)
    rids_s, serial_s, unfair_s, _ = play(svc_serial, start + 1, start)
    fused_span_s = fused_marks[start] - (fused_marks[start - 1] if start else 0.0)
    check(len(rids_s) == len(trace[start][1]) and not unfair_s, "the serial replay admitted other requests")
    in_fused = dict(zip(rids_s, rids[offset : offset + len(rids_s)]))  # the same request in the fused run
    led_s = svc_serial.ledger()
    check(len(led_s["requests"]) == len(rids_s) and all(r["status"] == "done" for r in led_s["requests"]),
          "a request of the serial replay failed")
    memo = {}
    fused_app = {r["request_id"]: (r["tenant"], r["app"]) for r in records}
    for r in led_s["requests"]:
        check(fused_app[in_fused[r["request_id"]]] == (r["tenant"], r["app"]),
              f"request {r['request_id']}: the replay's request is not the fused run's in its place")
        check(result_digest(r["app"], svc_serial.result(r["request_id"]), memo) == digests[in_fused[r["request_id"]]],
              f"request {r['request_id']} ({r['app']}): the serial replay served another result")
    numbers = {
        "requests": n_requests, "by_app": apps, "wall_s": fused_s, "requests_per_s": n_requests / fused_s,
        "service_p50_s": float(np.percentile(lat, 50)), "service_p95_s": float(np.percentile(lat, 95)),
        "per_tenant": per_tenant, "replayed_requests": len(rids_s), "serial_wall_s": serial_s,
        "fused_wall_s_of_the_replayed": fused_span_s, "fused_over_serial": fused_span_s / serial_s,
        "cache_hit_rate": led["cache"]["hit_rate"], "cache_hits": led["cache"]["hits"],
        "executions": led["executions"], "coalesced": led["coalesced"], "exec_groups": led["exec_groups"],
        "device_dispatches": led["device_dispatches"], "fused_requests": led["fused_requests"],
        "serial_device_dispatches": led_s["device_dispatches"],
        "compute_s": sum(r["compute_s"] for r in records), "queue_wait_s": sum(r["queue_wait_s"] for r in records),
        "card": card,
    }
    log(json.dumps({"service": numbers}))
    log(f"service: the mixed burst's {len(rids_s)} requests fused {fused_span_s:.3f} s against "
        f"serial {serial_s:.3f} s ({fused_span_s / serial_s:.3f}x); every request of the serial replay served the "
        f"same digest; fused_requests {led['fused_requests']} == the requests of "
        f"{len(fused_sizes)} multi-group buckets; no hidden exception")
    del svc_serial, led_s, memo

    # ---- every recorded launch held against the plain versions; the largest
    # of each kernel timed
    n_held, largest = hold_support_launches([("service", sc_calls)], hold, dev)
    timed_rows = time_largest_launches(largest, measure)
    TUNE_AT["service largest"] = ("support_count", *largest["support_count"][1:3], None)
    del sc_calls, largest
    km_errs, km_largest = [], None
    for j, (px, pc) in enumerate(km_calls):
        err, _ = hold_kmeans_launch(ops, ref, px, pc, f"service, kmeans launch {j + 1}")
        km_errs.append(err)
        if px.shape[0] == 1 and (km_largest is None or px.shape[1] > km_largest[0].shape[1]):
            km_largest = (px, pc, j + 1)
    px, pc, j = km_largest
    TUNE_AT["service kmeans"] = ("kmeans", px, pc)
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

    def recorder(wx, r, bias, state0):  # R and bias are parameters: held as plain tensors, no graph
        calls.append((wx.clone(), r.detach(), bias.detach(), tuple(t.clone() for t in state0)))
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
    # (no untraced run in the serving profiles: the serving runs above timed
    # each path warm)
    profile_main_path(
        lambda: prefill_step(model, {"tokens": tokens}, T.init_cache(cfg, XL_BATCH, XL_PROMPT, dev)),
        path="xlstm-1.3b prefill", bare=False)
    _, cache0 = prefill_step(model, {"tokens": tokens}, T.init_cache(cfg, XL_BATCH, XL_PROMPT + XL_DECODE, dev))

    def decode_all():  # LM_PROFILE_DECODE of the XL_DECODE steps (profiling all 64 took 30 s)
        cache, tok = cache0, gen_tokens[:, :1]
        for i in range(LM_PROFILE_DECODE):
            lg, cache = decode_step(model, {"token": tok, "pos": XL_PROMPT + i}, cache)
            tok = lg[:, -1].argmax(-1, keepdim=True)

    profile_main_path(decode_all, path=f"xlstm-1.3b decode ({LM_PROFILE_DECODE} steps)", bare=False)
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


def visible_pairs(sq: int, window: int, causal: bool = True, skv: int | None = None) -> int:
    """(query, key) pairs a launch sees, positions from 0 on both axes (Skv
    = Sq unless given): key j is visible to row i when j <= i (causal) and
    i - j < window (with a window).  A causal Sq = Skv launch: min(i + 1,
    window) keys for row i (i + 1 without a window); a non-causal one
    without a window: Sq·Skv."""
    skv = sq if skv is None else skv
    if causal and skv == sq:
        if not window or window >= sq:
            return sq * (sq + 1) // 2
        return window * (window + 1) // 2 + (sq - window) * window
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound(q, k, v, window: int, cap: float, peak: float = BF16_TC_FLOPS_PER_S, causal: bool = True):
    """(bytes bound ms, operations bound ms, sfu floor ms, bytes, flop) of a
    launch (causal unless ``causal`` is False; Skv from k): q, k, v read
    once and the output written once; 4·Dh flop a visible pair at ``peak``
    (the bf16 tensor-core peak unless given); an exp (and a tanh with a
    softcap) a visible pair on the special-function units."""
    b, sq, h, dh = q.shape
    pairs = b * h * visible_pairs(sq, window, causal, k.shape[1])
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

        # the window is a tensor the mask captures (the whole sequence for a
        # full layer, where the causal mask alone binds), so a full and a
        # window layer of one dtype share one compiled kernel
        span = torch.tensor(window or sq, device=q.device)

        def mask_mod(b, h, qi, ki):
            return (qi >= ki) & (qi - ki < span)

        def score_mod(score, b, h, qi, ki):
            return torch.tanh(score / cap) * cap

        block_mask = create_block_mask(mask_mod, None, None, sq, sq, device=q.device)
        flex = torch.compile(flex_attention)

        def call():
            return flex(qt, kt, vt, score_mod=score_mod if cap else None, block_mask=block_mask, enable_gqa=True)

        t0 = time.perf_counter()
        out = call().transpose(1, 2)
        torch.cuda.synchronize()
        log(f"flex_attention's first call here (compiled unless a layer of this dtype compiled it) took "
            f"{time.perf_counter() - t0:.1f} s")
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


def flash_scale_rounding(q, k) -> torch.Tensor:
    """(B, Sq, H) f32: how far the tensor-core kernel's scores may lie from
    the plain version's where the scale 1/sqrt(Dh) is not a power of two
    (Dh 96 and 128 among the repo's archs): the kernel computes
    ``scale·(q·k)``, the plain version ``(q·scale)·k``, one more f32
    rounding, and the two lie within
    ``4·Dh·2⁻²⁴·Σ|q·k|·scale`` of each other
    (tests/test_torch_flash_attention.py,
    ``test_tensor_core_scores_keep_the_plain_versions_semantics``).  Here
    ``Σ_d |q_d·k_d| <= ‖q‖·max_j ‖k_j‖`` over the row's KV head.  Scores
    each within Δ of the plain ones move p_j by at most p_j·(e^{2Δ} − 1),
    so an output by at most (e^{2Δ} − 1) times the |v|-weighted mean."""
    b, sq, h, dh = q.shape
    qn = torch.linalg.vector_norm(q.float(), dim=-1)  # (B, Sq, H)
    kn = torch.linalg.vector_norm(k.float(), dim=-1).amax(dim=1)  # (B, Kv)
    kn = kn.repeat_interleave(h // k.shape[2], dim=1)  # (B, H)
    return 4 * dh * 2.0**-24 * (1.0 / dh**0.5) * qn * kn[:, None, :]


def hold_flash(ops, ref, q, k, v, causal, window, cap, label, scale_rounding=False):
    """The kernel against the plain version on the same inputs (the same
    key tiles), and against itself run again (bit for bit), within
    FLASH_F32_RTOL or FLASH_BF16_RTOL (see there); with ``scale_rounding``
    (bfloat16 at a scale that is not a power of two) also within
    ``flash_scale_rounding``'s bound.  Both launches go to
    the tensor-core kernel in bfloat16 and to the CUDA-core one in
    float32.  Returns the largest |difference|, the share of outputs more
    than one bf16 ulp of the value away (0 in float32), and the largest
    |difference| over the bound without the scale's rounding."""
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
        of_plain_bound = float((err / bound).max()) if err.numel() else 0.0
    else:
        spread = ref.flash_attention_ref(q, k, v.abs(), causal=causal, window=window, cap=cap).double()
        bound = FLASH_BF16_RTOL * (want.abs() + spread) + FLASH_ATOL
        of_plain_bound = float((err / bound).max()) if err.numel() else 0.0
        if scale_rounding:
            bound = bound + torch.expm1(2 * flash_scale_rounding(q, k)).double()[..., None] * spread
        beyond_ulp = float((err > FLASH_BF16_RTOL * want.abs() + FLASH_ATOL).double().mean())
        del spread
    worst = float(err.max()) if err.numel() else 0.0
    check(bool((err <= bound).all()), f"{label}: flash_attention differs from the plain version past the "
          f"bound (max {worst:.3g}, at {float((err / bound).max()):.3g} of the bound)")
    return worst, beyond_ulp, of_plain_bound


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
            err, _, _ = hold_flash(ops, ref, q, k, v, causal, window, cap,
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
            err, _, _ = hold_flash(ops, ref, q, k, v, causal, window, cap, label)
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
        err, share, _ = hold_flash(ops, ref, q, k, v, causal, window, cap,
                                   f"gemma2 scoring, launch {j + 1} (window {window})")
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
                                   kernel="flash_attention_wgmma_kernel", bare=False)
    prof_prefill = profile_main_path(
        lambda: prefill_step(model, {"tokens": prompt}, T.init_cache(cfg, GM_BATCH, GM_SEQ, dev)),
        path="gemma2-2b prefill", bare=False)
    _, cache0 = prefill_step(model, {"tokens": prompt}, T.init_cache(cfg, GM_BATCH, GM_SEQ, dev))

    def decode_all():  # writes positions GM_PROMPT.. of cache0 in place, the same values each run; the first
        # LM_PROFILE_DECODE of the GM_DECODE steps (profiling all 32 took 17 s)
        cache, tok = cache0, gen_tokens[:, :1]
        for i in range(LM_PROFILE_DECODE):
            lg, cache = decode_step(model, {"token": tok, "pos": GM_PROMPT + i}, cache)
            tok = lg[:, -1].argmax(-1, keepdim=True)

    prof_decode = profile_main_path(decode_all, path=f"gemma2-2b decode ({LM_PROFILE_DECODE} steps)", bare=False)
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
    check(prof_score["kernel"]["calls"] == FLASH_LAUNCHES,
          f"the profiled scoring run's flash kernels: {prof_score['kernel']['calls']} in the trace of "
          f"{ops.LAUNCHES['flash_attention_wgmma']} launched a run; [start ms, ms, correlation id] of each: "
          f"{prof_score['kernel']['events']}")
    del model, cache0
    torch.cuda.empty_cache()
    return row


def flash_sdpa(q, k, v, window: int, want, causal: bool = True):
    """The PyTorch call that computes the same function as a launch without
    a softcap: scaled_dot_product_attention with GQA, causal as the launch
    is (positions from 0 on both axes), or with the window as a boolean
    mask.  Timed only (the port never calls it).  Returns (ms, max |out -
    plain| or None, the failure or None)."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = None
    if window:
        d = torch.arange(q.shape[1], device=q.device)[:, None] - torch.arange(k.shape[1], device=q.device)[None, :]
        mask = (d < window) & (d >= 0) if causal else d < window

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)

    try:
        err = float((call().transpose(1, 2).double() - want.double()).abs().max())
        return median_ms(call, reps=10, warmup=1), err, None
    except Exception as e:  # the yardstick's failure is recorded, not fatal
        reason = f"{type(e).__name__}: {str(e)[:300]}"
        log(f"scaled_dot_product_attention yardstick failed: {reason}")
        return None, None, reason


def hold_and_time_flash(ops, ref, calls, label: str) -> dict:
    """Every recorded flash launch held to its plain version and to itself
    (``hold_flash``, with ``flash_scale_rounding`` where the scale is not a
    power of two) and timed beside the plain version and its bound; for the
    first launch of each shape (Sq, Skv, causal, window, cap, Dh) also
    scaled_dot_product_attention.  Returns the lists by launch and the
    rows by shape."""
    errs, beyond, of_plain, launch_ms, plain_ms, bound_ms, by_shape = [], [], [], [], [], [], {}
    for j, (q, k, v, causal, window, cap) in enumerate(calls):
        dh = q.shape[-1]
        rounding = not math.log2(dh**0.5).is_integer()  # the scale 1/sqrt(Dh) is not a power of two
        err, share, plain_ratio = hold_flash(
            ops, ref, q, k, v, causal, window, cap, f"{label}, launch {j + 1} (Dh {dh}, Sq {q.shape[1]}, Skv "
            f"{k.shape[1]}, causal {causal}, window {window})", scale_rounding=rounding)
        errs.append(err)
        beyond.append(share)
        of_plain.append(plain_ratio)
        launch_ms.append(median_ms(lambda: ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap),
                                   reps=10, warmup=1))
        plain_ms.append(median_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap),
                                  reps=3, warmup=0))
        t_bytes, t_ops = flash_bound(q, k, v, window, cap, causal=causal)[:2]
        bound_ms.append(max(t_bytes, t_ops))
        key = (q.shape[1], k.shape[1], causal, window, cap, dh)
        if key in by_shape:
            by_shape[key]["launches"] += 1
            by_shape[key]["max_abs_err"] = max(by_shape[key]["max_abs_err"], err)
            continue
        if cap:
            lib_ms, lib_err, lib_failed = None, None, "softcap"
        else:
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap)
            lib_ms, lib_err, lib_failed = flash_sdpa(q, k, v, window, want, causal=causal)
            del want
        bq, sq, h, _ = q.shape
        by_shape[key] = {
            "at": f"{label}, launch {j + 1}", "launches": 1, "ms": launch_ms[-1], "plain_ms": plain_ms[-1],
            "bound_ms": bound_ms[-1], "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "share_of_bound": bound_ms[-1] / launch_ms[-1], "library_ms": lib_ms,
            "library_max_abs_diff": lib_err, "library_failure": lib_failed, "max_abs_err": err,
            "shape": {"B": bq, "Sq": sq, "Skv": k.shape[1], "H": h, "Kv": k.shape[2], "Dh": dh, "causal": causal,
                      "window": window, "cap": cap, "dtype": str(q.dtype)},
        }
    log(f"{label} flash_attention, every launch held (max |err| {max(errs):.4g}; largest |err| over the bound "
        f"without the scale's rounding {max(of_plain):.4g}): ms (median of 10) {json.dumps(launch_ms)}; plain ms "
        f"(median of 3) {json.dumps(plain_ms)}; bound ms {json.dumps(bound_ms)}")
    return {"errs": errs, "beyond": beyond, "of_plain": of_plain, "ms": launch_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "by_shape": list(by_shape.values())}


def run_lm(dev, card, ops, ref, arch: str) -> dict:
    """Phase 25 (deepseek-moe-16b, mixtral-8x22b), 26 (zamba2-1.2b) or 27
    (seamless-m4t-large-v2, phi-3-vision-4.2b): the arch at its published
    widths (depth as LM_RUNS says) built on the card from seed 0; scoring
    (the mean next-token CE) through the bfloat16 flash kernel, twice,
    bit-identical; every flash launch of a third run held to its plain
    version and to itself run again, and timed beside the plain version,
    its bound and scaled_dot_product_attention; serving (prefill, greedy
    decode), every flash launch of the prefill held and timed the same way;
    in float32 at B = 1 (with a capacity factor that binds no expert,
    n_experts / top_k), prefill + teacher-forced decode against the
    forward's logits; where the time goes.  For the MoE archs, the share of
    (token, expert) routings each MoE layer's capacity dropped at the
    published factor.  The archs with a stub frontend take their tokens and
    its embeddings from ``TokenStream`` (seed 1, step 0): seamless's frames
    go through its encoder, phi-3-vision's patches in front of its tokens.
    Returns {"launches", "prefill_launches", "row"}, the flash kernel's row
    for this arch."""
    import dataclasses
    import gc

    from repro_torch.configs import get
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.train.losses import chunked_softmax_ce
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    run = LM_RUNS[arch]
    b, seq, prompt, n_dec = run["batch"], run["seq"], run["prompt"], run["decode"]
    cfg = get(arch).scaled(flash_kernel=True)
    if run["n_layers"]:
        cfg = cfg.scaled(n_layers=run["n_layers"])
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on: the MoE router's float32 product would route "
          "otherwise than the reference")
    check(cfg.moe is None or not cfg.moe_dispatch_groups, f"{arch}: the configs use the global dispatch")
    n_attn_layers = sum(k in ("full", "swa", "full_dense", "swa_dense") for k in cfg.blocks())
    # an encoder-decoder's attention layers also cross-attend; its encoder
    # layers attend too, in scoring and in prefill
    n_attn = n_attn_layers * (2 if cfg.is_encdec else 1) + cfg.n_enc_layers + T.n_shared_runs(cfg)
    n_prefill = n_attn_layers + cfg.n_enc_layers if cfg.is_encdec else 0
    check((n_attn, n_prefill) == (run["flash"], run["prefill_flash"]),
          f"{arch}: {n_attn} flash launches a scoring forward and {n_prefill} a prefill, want {run['flash']} and "
          f"{run['prefill_flash']}")
    # a decoder-only model's prefix counts in its positions and its cache
    prefix = cfg.frontend_len if cfg.frontend != "none" and not cfg.is_encdec else 0
    log(f"{arch}: {torch.cuda.memory_allocated() / 1e9:.3f} GB on the card before the build")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T.Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == T.param_count(cfg) == LM_PARAMS.get(cfg.name, n_params),
          f"{arch}: {n_params} parameters, want {LM_PARAMS.get(cfg.name, T.param_count(cfg))}")
    log(f"{arch}: {cfg.n_layers} layers ({run['n_layers'] and 'cut from ' + str(get(arch).n_layers) or 'all'}"
        f"{f', and {cfg.n_enc_layers} encoder layers' if cfg.is_encdec else ''}), {n_params} parameters (fp32, "
        f"active a token {T.active_param_count(cfg)}), built on the card in {build_s:.3f} s")
    frontend = None
    if cfg.frontend != "none":
        batch = TokenStream(cfg.vocab, b, seq, seed=1, frontend_len=cfg.frontend_len,
                            d_model=cfg.d_model).batch_at(0)
        tokens = torch.from_numpy(batch["tokens"]).long().to(dev)
        labels = torch.from_numpy(batch["labels"]).long().to(dev)
        frontend = torch.from_numpy(batch["frontend"]).to(dev)
        log(f"{arch}: TokenStream batch {b} x {seq} tokens and {cfg.frontend} embeddings "
            f"{tuple(frontend.shape)} ({cfg.frontend_len} a sequence)")
    else:
        tokens = torch.randint(0, cfg.vocab, (b, seq), generator=torch.Generator().manual_seed(1)).to(dev)
        labels = torch.roll(tokens, -1, dims=1)
        labels[:, -1] = -1  # the next token of each position; the last has none

    def front(bsz):
        return None if frontend is None else frontend[:bsz]

    def score(step_cfg, bsz=b):
        """(hidden, ce, n_tok, aux, (flash launches, of them on the tensor
        cores), host s) of forward_train(return_hidden=True) then
        chunked_softmax_ce over the first bsz sequences."""
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            hidden, aux = T.forward_train(step_cfg, model, tokens[:bsz], front(bsz), return_hidden=True)
            ce, n_tok = chunked_softmax_ce(step_cfg, model, hidden, labels[:bsz], chunk=GM_LOSS_CHUNK)
        torch.cuda.synchronize()
        launches = (ops.LAUNCHES["flash_attention"], ops.LAUNCHES["flash_attention_wgmma"])
        return hidden, ce, n_tok, aux, launches, time.perf_counter() - t0

    hidden, ce, n_tok, aux, (n_flash, n_wgmma), score_s = score(cfg)
    aux_f = {k: float(v) for k, v in aux.items()}
    log(f"{arch} scoring (flash_kernel=True): {b} x {seq} tokens {score_s:.3f} s ({b * seq / score_s:.1f} tokens/s), "
        f"mean CE {float(ce):.6f} over {int(n_tok)} tokens, aux {aux_f}; flash_attention launches {n_flash}, of "
        f"them on the tensor cores {n_wgmma}")
    check(n_flash == n_attn and n_wgmma == n_attn, f"{arch}: a bf16 scoring forward launched flash_attention "
          f"{n_flash} and flash_attention_wgmma {n_wgmma} times, want {n_attn} each")
    check(bool(torch.isfinite(ce)) and int(n_tok) == int((labels >= 0).sum()), f"{arch}: the scoring loss or count")
    check(hidden.shape == (b, seq, cfg.d_model) and bool(torch.isfinite(hidden).all()), f"{arch}: hidden states")
    check(all(np.isfinite(v) for v in aux_f.values()) and (cfg.moe is None) == (aux_f["aux_loss"] == 0.0),
          f"{arch}: aux losses {aux_f}")
    hidden2, ce2, _, aux2, _, score2_s = score(cfg)
    same = torch.equal(hidden2, hidden) and torch.equal(ce2, ce) and all(torch.equal(aux2[k], aux[k]) for k in aux)
    log(f"{arch} second scoring run: {score2_s:.3f} s, hidden states, CE and aux bit-identical {same}")
    check(same, f"{arch}: a second scoring run differs")
    del hidden, hidden2

    # a third run records every flash launch and, for the MoE archs, each
    # MoE layer's routings past its capacity at the published factor
    calls, dropped = [], []
    real_flash, real_route = ops.flash_attention, moe_mod.route

    def recorder(q, k, v, causal=True, window=0, cap=0.0):
        calls.append((q.clone(), k.clone(), v.clone(), causal, window, cap))
        return real_flash(q, k, v, causal=causal, window=window, cap=cap)

    def route_spy(step_cfg, p, xt):
        out = real_route(step_cfg, p, xt)
        m, t = step_cfg.moe, xt.shape[0]
        counts = torch.bincount(out[3].reshape(-1), minlength=m.n_experts)
        dropped.append(int((counts - moe_mod._capacity(t, m)).clamp(min=0).sum()) / (t * m.top_k))
        return out

    ops.flash_attention, moe_mod.route = recorder, route_spy
    try:
        _, ce3, _, _, launches3, _ = score(cfg)
    finally:
        ops.flash_attention, moe_mod.route = real_flash, real_route
    # no launch lost between the scoring forward and the recorded run: each
    # recorded call launched the kernel once, and as many as the forward's
    check(torch.equal(ce3, ce) and len(calls) == n_attn and launches3 == (n_attn, n_attn),
          f"{arch}: the recorded run ({len(calls)} calls, launches {launches3}, want {n_attn})")
    if cfg.moe is not None:
        n_moe = sum(1 for k in cfg.blocks() if not k.endswith("_dense"))
        check(len(dropped) == n_moe, f"{arch}: {len(dropped)} routed layers, want {n_moe}")
        log(f"{arch} capacity drops at the published factor {cfg.moe.capacity_factor} (capacity "
            f"{moe_mod._capacity(b * seq, cfg.moe)} a routed expert of {b * seq} tokens x top-{cfg.moe.top_k}): "
            f"share of (token, expert) routings dropped, by MoE layer: {json.dumps(dropped)}")
    held = hold_and_time_flash(ops, ref, calls, f"{arch} scoring")
    q, k, v, causal, window, cap = calls[0]
    first = held["by_shape"][0]
    t_bytes, t_ops, t_sfu, nbytes, flop = flash_bound(q, k, v, window, cap, causal=causal)
    row = {
        "launches": n_flash, "max_abs_err": max(held["errs"]), "ms": held["ms"][0], "plain_ms": held["plain_ms"][0],
        "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": first["library_ms"], "library": "scaled_dot_product_attention(enable_gqa=True), "
        + ("causal" if causal else "non-causal") + (" + the window as a boolean mask" if window else ""),
        "library_max_abs_diff": first["library_max_abs_diff"], "library_failure": first["library_failure"],
        "tflops_on_visible_pairs": flop / held["ms"][0] / 1e9, "share_of_bound": max(t_bytes, t_ops) / held["ms"][0],
        "at": f"{arch} scoring, launch 1", "path_ms": sum(held["ms"]), "path_plain_ms": sum(held["plain_ms"]),
        "path_bound_ms": sum(held["bound_ms"]), "outputs_beyond_one_bf16_ulp": max(held["beyond"]),
        "max_err_over_plain_bound": max(held["of_plain"]),
        "shape": {"B": q.shape[0], "Sq": q.shape[1], "Skv": k.shape[1], "H": q.shape[2], "Kv": k.shape[2],
                  "Dh": q.shape[3], "causal": causal, "window": window, "cap": cap, "dtype": str(q.dtype)},
        "by_shape": held["by_shape"],
    }
    log(json.dumps({"kernel": "flash_attention", **row, "bytes": nbytes, "flop": flop, "sfu_floor_ms": t_sfu,
                    "card": card}))
    del calls, q, k, v

    # serving: the first `prompt` tokens of each sequence (after the prefix
    # or with the frames), then greedy decode
    prefill_step, decode_step = make_prefill_step(cfg), make_decode_step(cfg)
    cache_len = prefix + seq

    def prompt_batch(bsz):
        out = {"tokens": tokens[:bsz, :prompt]}
        if frontend is not None:
            out["frontend"] = frontend[:bsz]
        return out

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_step(model, prompt_batch(b), T.init_cache(cfg, b, cache_len, dev))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre_n = ops.LAUNCHES["flash_attention"]
    finite = torch.isfinite(logits).all()
    out = [logits[:, -1].argmax(-1)]
    t0 = time.perf_counter()
    for i in range(n_dec):
        lg, cache = decode_step(model, {"token": out[-1][:, None], "pos": prefix + prompt + i}, cache)
        finite &= torch.isfinite(lg).all()
        out.append(lg[:, -1].argmax(-1))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    dec_n = ops.LAUNCHES["flash_attention"] - pre_n
    gen_tokens = torch.stack(out, 1)
    log(f"{arch} serving: prefill {b} x {prompt} tokens{f' after {prefix} prefix positions' if prefix else ''} "
        f"{prefill_s:.3f} s ({b * prompt / prefill_s:.1f} tokens/s), {n_dec} decode steps {decode_s:.3f} s "
        f"({decode_s / n_dec * 1e3:.3f} ms a step at B={b}); flash_attention launches: prefill {pre_n}, decode "
        f"{dec_n}")
    check(bool(finite), f"{arch}: a prefill or decode logit is not finite")
    check(pre_n == n_prefill and dec_n == 0, f"{arch}: prefill launched the flash kernel {pre_n} times (want "
          f"{n_prefill}) and decode {dec_n} (want 0)")
    check(logits.shape == (b, 1, cfg.vocab_padded), f"{arch}: prefill logits shape {tuple(logits.shape)}")
    del cache, logits
    prefill_held = None
    if n_prefill:  # an encoder-decoder's prefill: its encoder and cross launches, held and timed as scoring's
        calls = []
        ops.flash_attention = recorder
        try:
            ops.reset_launches()
            _, cache = prefill_step(model, prompt_batch(b), T.init_cache(cfg, b, cache_len, dev))
            torch.cuda.synchronize()
        finally:
            ops.flash_attention = real_flash
        check(len(calls) == n_prefill and ops.LAUNCHES["flash_attention"] == n_prefill,
              f"{arch}: the recorded prefill ({len(calls)} calls, {ops.LAUNCHES['flash_attention']} launches)")
        del cache
        held_pre = hold_and_time_flash(ops, ref, calls, f"{arch} prefill")
        prefill_held = {"launches": pre_n, "max_abs_err": max(held_pre["errs"]),
                        "max_err_over_plain_bound": max(held_pre["of_plain"]), "path_ms": sum(held_pre["ms"]),
                        "path_plain_ms": sum(held_pre["plain_ms"]), "path_bound_ms": sum(held_pre["bound_ms"]),
                        "by_shape": held_pre["by_shape"]}
        row["prefill"] = prefill_held
        del calls

    # float32 at B = 1: prefill + teacher-forced decode of the rest against
    # the forward's logits at those positions.  The MoE archs at a capacity
    # factor that binds no expert: decode never competes for capacity (C = T
    # at every step), so at the published factor a prefill that dropped
    # tokens cannot match it.  Their forward takes the chunked oracle, as
    # prefill does: the float32 flash kernel's sums in another order (1e-6)
    # flip routings that sit on a near-tie of the top-k, and a flipped
    # token's output moves by a whole expert's share, so through the layers
    # the flash forward drifts from the oracle's (reported beside it)
    cfg32 = cfg.scaled(dtype="float32")
    if cfg.moe is not None:
        cfg32 = cfg32.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k),
                             flash_kernel=False)

    def forward_logits(step_cfg):
        with torch.inference_mode():
            h32, _ = T.forward_train(step_cfg, model, tokens[:1], front(1), return_hidden=True)
            return T.logits_from(step_cfg, model, h32[:, prompt - 1 :])

    want = forward_logits(cfg32)
    flash_drift = None
    if cfg.moe is not None:
        flash_drift = float((forward_logits(cfg32.scaled(flash_kernel=True)) - want).abs().max())
    lg, cache = make_prefill_step(cfg32)(model, prompt_batch(1), T.init_cache(cfg32, 1, cache_len, dev))
    got = [lg[:, 0]]
    dec32 = make_decode_step(cfg32)
    for pos in range(prompt, seq):
        lg, cache = dec32(model, {"token": tokens[:1, pos : pos + 1], "pos": prefix + pos}, cache)
        got.append(lg[:, 0])
    got = torch.stack(got, 1)
    diff = (got - want).abs()
    parity_ok = bool((diff <= PARITY_TOL + PARITY_TOL * want.abs()).all())
    parity_f32 = float(diff.max())
    log(f"{arch} float32 prefill ({prompt}) + {seq - prompt} teacher-forced decode steps vs the forward's logits at "
        f"those {want.shape[1]} positions"
        + (f" (capacity factor {cfg32.moe.capacity_factor:.4g}, no expert's capacity binds; the forward through "
           f"the chunked oracle, as prefill; through the float32 flash kernel it lies {flash_drift:.4g} away, "
           f"reported only)" if cfg.moe else " (the forward through the float32 flash kernel)")
        + f": max |diff| {parity_f32:.4g} over logits up to {float(want[..., :cfg.vocab].abs().max()):.4g} (the "
        f"padded ids' -1e30 left out), within {PARITY_TOL} {parity_ok}")
    check(parity_ok, f"{arch}: float32 prefill/decode parity past {PARITY_TOL}")
    del cache, want, got, diff

    # where the time goes
    prof_score = profile_main_path(lambda: score(cfg), path=f"{arch} scoring", kernel="flash_attention_wgmma_kernel",
                                   bare=False)
    prof_prefill = profile_main_path(
        lambda: prefill_step(model, prompt_batch(b), T.init_cache(cfg, b, cache_len, dev)),
        path=f"{arch} prefill", kernel="flash_attention_wgmma_kernel", bare=False)
    _, cache0 = prefill_step(model, prompt_batch(b), T.init_cache(cfg, b, cache_len, dev))
    n_prof = min(n_dec, LM_PROFILE_DECODE)

    def decode_all():  # from the same prefill cache each run (decode writes K/V in place, the same values)
        cache, tok = cache0, gen_tokens[:, :1]
        for i in range(n_prof):
            lg, cache = decode_step(model, {"token": tok, "pos": prefix + prompt + i}, cache)
            tok = lg[:, -1].argmax(-1, keepdim=True)

    prof_decode = profile_main_path(decode_all, path=f"{arch} decode ({n_prof} steps)", bare=False)
    for prof, want_n, what in ((prof_score, n_attn, "scoring"), (prof_prefill, n_prefill, "prefill")):
        check(prof["kernel"]["calls"] == want_n,
              f"{arch}: the profiled {what} run's flash kernels: {prof['kernel']['calls']} in the trace, want "
              f"{want_n}; [start ms, ms, correlation id] of each: {prof['kernel']['events']}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(json.dumps({f"{arch}_scoring_serving": {
        "layers": cfg.n_layers, "encoder_layers": cfg.n_enc_layers, "frontend": cfg.frontend,
        "frontend_len": cfg.frontend_len, "parameters": n_params, "build_s": build_s, "batch": b, "seq": seq,
        "prompt": prompt, "prefix": prefix, "decode_steps": n_dec, "scoring_s": score_s,
        "scoring_tokens_per_s": b * seq / score_s,
        "scoring_s_second_run": score2_s, "mean_ce": float(ce), "aux": aux_f,
        "capacity_dropped_share_by_layer": dropped or None,
        "prefill_s": prefill_s, "prefill_tokens_per_s": b * prompt / prefill_s,
        "decode_ms_per_step": decode_s / n_dec * 1e3, "decode_tokens_per_s": b * n_dec / decode_s,
        "parity_f32_max_diff": parity_f32, "f32_flash_forward_drift": flash_drift,
        "flash_ms": held["ms"][0], "flash_plain_ms": held["plain_ms"][0],
        "flash_bound_ms": row["bound_ms"], "flash_path_ms": row["path_ms"],
        "flash_prefill_path_ms": prefill_held and prefill_held["path_ms"],
        "flash_share_of_scoring_device_busy": prof_score["kernel"]["share_of_device_busy"],
        "flash_share_of_prefill_device_busy": prof_prefill["kernel"]["share_of_device_busy"],
        "device_idle_share": {"scoring": prof_score["device_idle_share"],
                              "prefill": prof_prefill["device_idle_share"],
                              "decode": prof_decode["device_idle_share"]},
        "peak_memory_gb": peak_gb, "card": card,
    }}))
    del model, cache0
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": n_flash, "prefill_launches": pre_n, "row": row}


def at_perf_check(card: str, label: str, shape: dict, ms: float, row: tuple) -> dict:
    """The default's time at ``label`` against PERF.md §6's row (its
    shape, its ms): checked within AT_PERF_RTOL on a card at the rows'
    power limit and at the row's shape, logged otherwise (a card held below
    700 W runs slower under load)."""
    want_shape, want = row
    ratio = ms / want
    held = card.endswith(AT_PERF_CARD) and all(shape.get(k) == v for k, v in want_shape.items())
    if held:
        check(abs(ratio - 1.0) <= AT_PERF_RTOL,
              f"autotune {label}: the default takes {ms:.4f} ms, PERF.md §6 {want:.4f} ms ({ratio:.3f}x): "
              f"not the kernel PERF.md measured")
    return {"perf_md_ms": want, "default_over_perf_md": ratio, "perf_md_held": held}


def run_autotune(dev, card, ops, ref, sites, gfm_digest: dict, vc_digest: dict) -> dict:
    """Phase 23: the autotuner (``kernels.autotune``, full lattice) at the
    mining kernels' own launches that the phases above recorded in TUNE_AT.
    At each: the variants' attributes (shared memory against the formulas,
    spills, resident CTAs), the search (each candidate's median ms), every
    candidate's outputs bit for bit against the default's and the
    default's against the plain version, the winner and tuned/default
    (<= 1 by the margin rule), and the default's time against PERF.md §6.
    Then the table saved under build/, the memo cleared and the table
    loaded, and GFM (phase 3's path) and vclustering (phase 6's) run again
    under auto blocks: their digests must equal phases 3 and 6 with no
    search (no cache miss).  Returns, for the ``kernels`` line, each mining
    kernel's tuned config and times at its path's largest launch."""
    from repro_torch.kernels import autotune as at
    from repro_torch.runtime import GridRuntime
    from repro_torch.workflow.registry import get_workload

    t_phase = time.perf_counter()
    prev_smoke = at.set_smoke(False)  # the full lattice
    at.clear_cache()

    # the variants as built: shared memory equal to the formulas, spills,
    # resident CTAs; a variant that spills or fits no CTA is no candidate
    attrs = {"support_count": [], "kmeans_assign": {}}
    for v, variant in enumerate(at.SUPPORT_VARIANTS):
        info = ops.support_count_variant_info(v)
        check((info["threads"], info["u"], info["i"]) == variant, f"count variant {v}: {info}, want {variant}")
        check(info["shared_bytes"] == at.support_count_smem(variant[0]),
              f"count variant {v}: {info['shared_bytes']} B of shared memory, the formula {at.support_count_smem(variant[0])}")
        attrs["support_count"].append(dict(info, candidate=at.variant_fits(info)))
    for d in (1, 3, 4, 8, 9, 16, 17, 100):
        variants = at.KMEANS_VARIANTS[at.kmeans_maxd(d)]
        rows = []
        for v, variant in enumerate(variants):
            info = ops.kmeans_assign_variant_info(v, d)
            check(info["variants"] == len(variants) and (info["threads"], info["points"]) == variant,
                  f"kmeans variant {v} at D={d}: {info}, want {variant} of {len(variants)}")
            check(info["shared_bytes"] == at.kmeans_assign_smem(at.kmeans_maxd(d)),
                  f"kmeans variant {v} at D={d}: {info['shared_bytes']} B of shared memory, the formula "
                  f"{at.kmeans_assign_smem(at.kmeans_maxd(d))}")
            rows.append(dict(info, candidate=at.variant_fits(info)))
        check(rows[0]["candidate"], f"the default kmeans launch at D={d} spills or fits no CTA: {rows[0]}")
        attrs["kmeans_assign"][d] = rows
    check(attrs["support_count"][0]["candidate"], f"the default count launch spills: {attrs['support_count'][0]}")
    log(json.dumps({"autotune_variants": attrs, "card": card}))

    out, tuned_at = {}, {}
    for label, item in TUNE_AT.items():
        before = at.cache_stats()
        if item[0] == "kmeans":
            _, px, pc = item
            s, n, d = px.shape
            shape = {"S": s, "N": n, "K": pc.shape[1], "D": d}
            ent = at.tune_kmeans_assign(px, pc)
            a0, m0 = ops.kmeans_assign_sites(px, pc, block="default")
            ra, rm = ref.kmeans_assign_sites_ref(px, pc)
            torch.cuda.synchronize()
            check(torch.equal(a0, ra) and torch.equal(m0, rm), f"autotune {label}: the default differs from the plain version")
            del ra, rm
            configs = [tuple(ast.literal_eval(c)) for c in ent["timings"]]
            for cfg in configs:
                a, m = ops.kmeans_assign_sites(px, pc, block=cfg)
                torch.cuda.synchronize()
                check(torch.equal(a, a0) and torch.equal(m, m0), f"autotune {label}: config {cfg} differs from the default")
            del a, m, a0, m0
            default_fn = lambda: ops.kmeans_assign_sites(px, pc)  # noqa: E731
        else:
            form, tx, masks, mc = item
            s, n, w = tx.shape
            shape = {"S": s, "N": n, "C": masks.shape[1], "W": w}
            thr = mc if mc is not None else torch.tensor(
                [int(np.ceil(MINSUP * n))] * s, dtype=torch.int32, device=dev)
            ent = at.tune_support_count(tx, masks)
            c0 = ops.support_count_sites(tx, masks, block="default")
            p0, f0 = ops.support_count_prune_sites(tx, masks, thr, block="default")
            want = ref.support_count_sites_ref(tx, masks)
            torch.cuda.synchronize()
            check(torch.equal(c0, want) and torch.equal(p0, want) and torch.equal(f0, want >= thr[:, None]),
                  f"autotune {label}: the default differs from the plain version")
            configs = [tuple(ast.literal_eval(c)) for c in ent["timings"]]
            for cfg in configs:
                c = ops.support_count_sites(tx, masks, block=cfg)
                pc_, pf = ops.support_count_prune_sites(tx, masks, thr, block=cfg)
                torch.cuda.synchronize()
                check(torch.equal(c, c0) and torch.equal(pc_, c0) and torch.equal(pf, f0),
                      f"autotune {label}: config {cfg} differs from the default")
            if form == "support_count":
                default_fn = lambda: ops.support_count_sites(tx, masks)  # noqa: E731
            else:
                default_fn = lambda: ops.support_count_prune_sites(tx, masks, thr)  # noqa: E731
        after = at.cache_stats()
        check(ent["seconds_tuned"] <= ent["seconds_default"],
              f"autotune {label}: tuned {ent['seconds_tuned']} s > default {ent['seconds_default']} s")
        default_ms = median_ms(default_fn, reps=30)
        row = {
            "autotune": "kmeans_assign" if item[0] == "kmeans" else "support_count", "at": label, "form": item[0],
            "shape": shape, "key": list(ent["shape"]), "search": "miss" if after["misses"] > before["misses"] else "hit",
            "candidates_ms": {c: t * 1e3 for c, t in ent["timings"].items()}, "bit_identical": len(configs),
            "default": ent["config_default"], "winner": ent["config"], "tuned_ms": ent["seconds_tuned"] * 1e3,
            "default_search_ms": ent["seconds_default"] * 1e3,
            "tuned_over_default": ent["seconds_tuned"] / ent["seconds_default"],
            "default_ms": default_ms,
        }
        if label in AT_PERF_MS:
            row.update(at_perf_check(card, label, shape, default_ms, AT_PERF_MS[label]))
        log(json.dumps({**row, "card": card}))
        tuned_at[label] = row
    levels = [tuned_at[f"GFM level {lv}"] for lv in (2, 3, 4) if f"GFM level {lv}" in tuned_at]
    if len(levels) == 3:
        total = sum(r["default_ms"] for r in levels)
        out_levels = at_perf_check(card, "GFM levels 2-4", levels[-1]["shape"], total, AT_PERF_GFM_LEVELS)
        log(json.dumps({"autotune": "support_count", "at": "GFM levels 2-4 (sum of defaults)", "default_ms": total,
                        **out_levels, "card": card}))

    # the table through a file, then the two paths under auto blocks with no search
    os.makedirs(os.path.dirname(AT_TABLE), exist_ok=True)
    memo = {k: dict(v) for k, v in at._cache.items()}
    n_saved = at.save_table(AT_TABLE)
    at.clear_cache()
    n_loaded = at.load_table(AT_TABLE)
    check(n_saved == n_loaded == len(memo) and at._cache == memo, "the tuned table does not round-trip")
    prev_mode = ops.set_default_block("auto")
    try:
        ops.reset_launches()
        t0 = time.perf_counter()
        run = GridRuntime(device=dev).run("gfm", sites, {"k": K, "minsup": MINSUP})
        torch.cuda.synchronize()
        gfm_s = time.perf_counter() - t0
        gfm_cfg = {k: ops.LAST_CONFIG[k] for k in SITE_FORMS}
        check(get_workload("gfm").digest(run.result) == gfm_digest, "GFM under auto blocks differs from phase 3")
        check(all(ops.LAUNCHES[k] > 0 for k in SITE_FORMS), f"GFM under auto blocks launched {dict(ops.LAUNCHES)}")
        del run
        t0 = time.perf_counter()
        vc = GridRuntime(device=dev).run("vclustering", VC_POINTS.pop("xs"), CL_PARAMS).result
        torch.cuda.synchronize()
        vc_s = time.perf_counter() - t0
        check(labels_digest(vc) == vc_digest, "vclustering under auto blocks differs from phase 6")
        del vc
        stats = at.cache_stats()
        check(stats["misses"] == 0 and stats["hits"] > 0, f"the paths under auto blocks searched: {stats}")
    finally:
        ops.set_default_block(prev_mode)
        at.set_smoke(prev_smoke)
    log(json.dumps({
        "autotune_paths": {"table": os.path.relpath(AT_TABLE, ROOT), "entries": n_loaded, "cache": stats,
                           "gfm_auto_s": gfm_s, "gfm_phase3_s": WALLS.get("gfm"), "gfm_configs": gfm_cfg,
                           "vclustering_auto_s": vc_s, "vclustering_phase6_s": WALLS.get("vclustering"),
                           "vclustering_config": ops.LAST_CONFIG["kmeans_assign_sites"]},
        "card": card,
    }))
    log(f"autotune: {len(tuned_at)} launches tuned, every candidate bit-identical to the default and the default to "
        f"the plain version; GFM and vclustering under auto blocks == phases 3 and 6 with 0 searches; phase 23 "
        f"{time.perf_counter() - t_phase:.1f} s")
    for kernel, label in [("support_count", "GFM recount"), ("support_count_prune", "GFM level 4"),
                          ("kmeans_assign", "vclustering")]:
        row = tuned_at[label]
        out[kernel] = {"tuned_config": row["winner"], "tuned_ms": row["tuned_ms"],
                       "default_ms": row["default_search_ms"], "tuned_at": label}
    TUNE_AT.clear()
    torch.cuda.empty_cache()
    return out


# phase 22: multi-host execution (runtime.backends.MultiHostBackend) on the
# card: gloo groups of ranks that all compute on the one H100, each a run of
# this script in child mode.  Group A ships each ready wave in one
# collective and runs the three miners at configuration 1 and vclustering at
# configuration 2; group B ships once per job and runs the three miners.
MH_GROUPS = {
    "A": {"nprocs": 2, "fuse": 1, "alone": 0, "apps": ("gfm", "fdm", "cd_apriori", "vclustering")},
    "B": {"nprocs": 3, "fuse": 0, "alone": 1, "apps": ("gfm", "fdm", "cd_apriori")},
}
# group A's ranks skip their runs alone (held to the single-process runs of
# phases 3, 6 and 17 all the same): cut for the script's 1,200 s limit,
# about 18 s of its 60.0 s (vclustering alone twice, the ranks in turn)
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
    for name in ("--pid", "--nprocs", "--port", "--fuse", "--alone"):
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
        for turn in range(args.nprocs if args.alone else 0):
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


def run_multihost(card: str, dense: np.ndarray, refs: dict) -> dict:
    """Phase 22: the multi-host backend on the card.  The parent writes the
    data under build/, starts each gloo group (this script in child mode,
    one process a rank), and holds every rank to the single-process
    results of phases 3, 6 and 17 (``refs``: app -> digest), to site
    ownership (each site's jobs on exactly one rank), and to its launches
    (each kernel of its path launched on every rank, every launch held in
    the child).  Returns each kernel's launches on the multi-host runs,
    summed over ranks and groups."""
    data_dir = MH_DATA
    check(os.path.exists(os.path.join(data_dir, "points.npy")), "phase 6's points were not written for phase 22")
    t0 = time.perf_counter()
    np.save(os.path.join(data_dir, "dense.npy"), dense)
    log(f"multihost data written: {time.perf_counter() - t0:.3f} s (the points by phase 6's thread)")
    torch.cuda.empty_cache()
    totals = {"support_count": 0, "support_count_prune": 0, "kmeans_assign": 0}
    summary = {}
    for name, g in MH_GROUPS.items():
        nprocs, apps = g["nprocs"], g["apps"]
        with __import__("socket").socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        argv = [*MH_CHILD, "--multihost-child", "--nprocs", str(nprocs),
                "--port", str(port), "--fuse", str(g["fuse"]), "--alone", str(g["alone"]), "--apps", ",".join(apps),
                "--data", data_dir]
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
                "multihost_s": [r["multihost_s"] for r in rows], "alone_s": [r.get("alone_s") for r in rows],
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


# phase 24: the per-site mesh (launch.mesh) on the card: one gloo rank a site,
# MESH_POINTS of the Table 3 points split 4 ways, every rank a run of
# this script in child mode on the one H100.  Each rank runs
# vcluster_shard_map over its own shard and the SPMD-redundant
# GridRuntime.for_sites(MESH_SITES) over all of them, and is held bit for bit
# to the parent's pooled runs of the same split.
MESH_SITES = 4
# cut for the script's time: the first quarter of the Table 3 points (12.5M,
# 3.125M a site); the whole 5e7 took phase 24 57.1 s on an H100 80GB HBM3 at
# 700 W, 44.1 s of it the ranks
MESH_POINTS = 12_500_000
MESH_MARKER = "MESH_CHILD "
MESH_TIMEOUT_S = 300  # a rank's collectives, and the parent's wait for the group
MESH_CHILD = [sys.executable, os.path.abspath(__file__)]  # how a rank starts


def hold_kmeans_as_launched(ops, ref, run_once) -> dict:
    """Every K-Means launch during one call of ``run_once``, held bit for
    bit against the plain version on its own inputs the moment it returns
    (the mesh runs' outputs are too large to keep).  Returns the launches
    held, by wrapper."""
    held = dict.fromkeys(MH_KMEANS, 0)
    real = {name: getattr(ops, name) for name in MH_KMEANS}

    def holder(name):
        def fn(xs, cs):
            out = real[name](xs, cs)
            if xs.shape[-2] > 0:
                site = name.endswith("_sites")
                want = ref.kmeans_assign_sites_ref(xs if site else xs[None], cs if site else cs[None])
                if not site:
                    want = tuple(w[0] for w in want)
                check(all(torch.equal(o, w) for o, w in zip(out, want)),
                      f"{name}: a launch of the mesh run differs from the plain version")
                held[name] += 1
            return out
        return fn

    for name in MH_KMEANS:
        setattr(ops, name, holder(name))
    try:
        run_once()
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    return held


def mesh_child(argv) -> None:
    """One rank of phase 24: join the gloo group as site ``--pid`` of the
    mesh, run ``vcluster_shard_map`` and the SPMD-redundant ``GridRuntime``
    (each once timed, with its launches counted and its gathers spied, and
    once with every K-Means launch held against the plain version), and
    print one marker line of JSON.  Fails (exit 1) on any check."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh-child", action="store_true")
    for name in ("--pid", "--nprocs", "--port"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--data", required=True, help="the directory the parent wrote the data to")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the mesh child needs the CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist

    from repro_torch.core.vclustering import VClusterConfig, vcluster_shard_map
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh
    from repro_torch.runtime import GridRuntime
    from repro_torch.runtime.backends import MultiHostBackend

    check("jax" not in sys.modules, "the port imported jax")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.nprocs))
    dev = torch.device(DEVICE)
    be = MultiHostBackend(coordinator_address=f"127.0.0.1:{args.port}", num_processes=args.nprocs,
                          process_id=args.pid, partition_sites=False, timeout=MESH_TIMEOUT_S)
    topo = be.describe()
    check(topo["process_count"] == args.nprocs and topo["process_index"] == args.pid and topo["wire"] == "gloo"
          and topo["mesh_shape"] == {"sites": args.nprocs},
          f"rank {args.pid}: the group did not come up as a {args.nprocs}-site gloo mesh: {topo}")
    site_mesh = mesh.make_site_mesh(args.nprocs, device=dev)
    check(site_mesh.coordinate() == args.pid, f"rank {args.pid} is site {site_mesh.coordinate()} of the mesh")

    x_global = np.load(os.path.join(args.data, "points.npy"), mmap_mode="r")
    s, n, d = x_global.shape
    x_global = x_global.reshape(s * n, d)  # a view of the file: each rank reads its own rows
    truth = np.load(os.path.join(args.data, "truth.npy"))
    cfg = VClusterConfig(k_local=CL_PARAMS["k_local"], kmeans_iters=CL_PARAMS["iters"])

    # the gathers: the statistics (one a run) and the labels, each call's
    # seconds (the wait for the slowest rank included) and bytes
    wire = {}
    real_stats, real_shards = mesh.allgather_stats, mesh.allgather_shards
    inside = [False]

    def stats_spy(st, m):
        t0 = time.perf_counter()
        inside[0] = True
        try:
            out = real_stats(st, m)
        finally:
            inside[0] = False
        wire["stats_calls"] += 1
        wire["stats_s"] += time.perf_counter() - t0
        wire["stats_bytes_sent"] += sum(t.numel() * t.element_size() for t in st)
        wire["stats_bytes_gathered"] += sum(t.numel() * t.element_size() for t in out)
        return out

    def shards_spy(t, m):
        t0 = time.perf_counter()
        out = real_shards(t, m)
        if not inside[0]:
            wire["labels_calls"] += 1
            wire["labels_s"] += time.perf_counter() - t0
            wire["labels_bytes_gathered"] += out.numel() * out.element_size()
        return out

    mesh.allgather_stats, mesh.allgather_shards = stats_spy, shards_spy

    def timed(run_once) -> tuple:
        """One barrier-aligned run: its result, host wall, kmeans launches and gathers."""
        for key in ("stats_calls", "labels_calls", "stats_bytes_sent", "stats_bytes_gathered",
                    "labels_bytes_gathered"):
            wire[key] = 0
        wire["stats_s"] = wire["labels_s"] = 0.0
        dist.barrier()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = run_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, {k: ops.LAUNCHES[k] for k in MH_KMEANS}, dict(wire)

    def row_of(labels, merged, wall, launches, gathers, held) -> dict:
        lab = labels.contiguous().cpu().numpy().reshape(-1)
        return {"labels_sha256": hashlib.sha256(lab.tobytes()).hexdigest(), "n_global": int(merged.n_global),
                "n_merges": int(merged.n_merges), "purity": purity_of(lab, truth, merged.labels.shape[0]),
                "wall_s": wall, "launches": launches, "gathers": gathers, "held": held}

    report = {"pid": args.pid, "topology": topo}
    fn = vcluster_shard_map(site_mesh, "sites", cfg)
    (labels, merged), wall, launches, gathers = timed(lambda: fn(x_global, seed=CL_PARAMS["seed"]))
    out = []
    held = hold_kmeans_as_launched(ops, ref, lambda: out.append(fn(x_global, seed=CL_PARAMS["seed"])))
    check(torch.equal(out[0][0], labels), f"rank {args.pid}: a second vcluster_shard_map run differs")
    report["shard_map"] = row_of(labels, merged, wall, launches, gathers, held)
    report["shard_map"]["compute_s"] = wall - gathers["stats_s"] - gathers["labels_s"]
    del labels, merged, out

    xs = torch.from_numpy(np.ascontiguousarray(x_global).reshape(s, n, d)).to(dev)
    rt = GridRuntime.for_sites(args.nprocs, backend=be, device=dev)
    run, wall, launches, gathers = timed(lambda: rt.run("vclustering", xs, CL_PARAMS))
    check(run.sync_mode == "shard_map", f"rank {args.pid}: the runtime synchronised by {run.sync_mode}")
    out = []
    held = hold_kmeans_as_launched(ops, ref, lambda: out.append(rt.run("vclustering", xs, CL_PARAMS)))
    check(torch.equal(out[0].result.labels, run.result.labels), f"rank {args.pid}: a second runtime run differs")
    res = run.result
    report["runtime"] = row_of(res.labels, res.merged, wall, launches, gathers, held)
    report["runtime"].update(sync_mode=run.sync_mode, backend=run.backend, measured_s={
        kind: sum(v for k, v in run.measured.items() if k.split("_")[0] == kind)
        for kind in ("cluster", "merge", "perturb", "collect")})
    mesh.allgather_stats, mesh.allgather_shards = real_stats, real_shards
    print(MESH_MARKER + json.dumps(report), flush=True)
    dist.destroy_process_group()


def run_mesh(dev, card: str, pooled: np.ndarray, comp: np.ndarray) -> int:
    """Phase 24: the per-site mesh on the card.  The parent splits
    ``pooled`` (the first MESH_POINTS of the Table 3 points, ``comp`` their
    planted components) MESH_SITES ways, runs vcluster_pooled and the pooled
    runtime on the split (the reference), writes the split under build/,
    starts one gloo rank a site (this script in child mode) and holds every
    rank to the reference bit for bit: labels, n_global, n_merges, purity,
    one gather a run, every K-Means launch held.  Returns the ranks'
    K-Means launches on their timed runs, summed."""
    from repro_torch.core.vclustering import VClusterConfig, vcluster_pooled
    from repro_torch.data.synthetic import split_sites
    from repro_torch.runtime import GridRuntime

    t_phase = time.perf_counter()
    data_dir = os.path.join(ROOT, "build", "mesh_smoke")
    os.makedirs(data_dir, exist_ok=True)
    xs_np = split_sites(pooled, MESH_SITES, seed=1)
    truth = comp[np.random.default_rng(1).permutation(len(pooled))[: xs_np.shape[0] * xs_np.shape[1]]]
    np.save(os.path.join(data_dir, "points.npy"), xs_np)
    np.save(os.path.join(data_dir, "truth.npy"), truth.astype(np.int8))
    xs = torch.from_numpy(xs_np).to(dev)
    del xs_np
    log(f"mesh data: {tuple(xs.shape)} f32 written and on the card, {time.perf_counter() - t_phase:.3f} s")
    cfg = VClusterConfig(k_local=CL_PARAMS["k_local"], kmeans_iters=CL_PARAMS["iters"])
    t0 = time.perf_counter()
    pooled_res = vcluster_pooled(xs, cfg, seed=CL_PARAMS["seed"])
    torch.cuda.synchronize()
    pooled_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = GridRuntime(device=dev, sync="pooled").run("vclustering", xs, CL_PARAMS)
    torch.cuda.synchronize()
    runtime_s = time.perf_counter() - t0
    want = labels_digest(pooled_res)
    check(run.sync_mode == "pooled" and labels_digest(run.result) == want,
          "the pooled runtime differs from vcluster_pooled on the mesh's split")
    m = pooled_res.merged.labels.shape[0]
    want_purity = purity_of(pooled_res.labels.cpu().numpy().reshape(-1), truth, m)
    log(f"mesh reference (pooled, {MESH_SITES} sites): vcluster_pooled {pooled_s:.3f} s, GridRuntime(sync='pooled') "
        f"{runtime_s:.3f} s, n_global {want['n_global']}, n_merges {want['n_merges']}, purity {want_purity:.6f}")
    check(want_purity >= CL_PURITY, f"the pooled run of the mesh's split has purity {want_purity:.6f}")
    del xs, pooled_res, run
    torch.cuda.empty_cache()

    with __import__("socket").socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = [*MESH_CHILD, "--mesh-child", "--nprocs", str(MESH_SITES), "--port", str(port), "--data", data_dir]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv + ["--pid", str(pid)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(MESH_SITES)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_TIMEOUT_S))
    except subprocess.TimeoutExpired:
        fail(f"mesh: a rank did not finish in {MESH_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    group_s = time.perf_counter() - t0
    reports = []
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"mesh rank {pid} exited {p.returncode}:\n{err[-3000:]}")
        lines = [ln for ln in out.splitlines() if ln.startswith(MESH_MARKER)]
        check(len(lines) == 1, f"mesh rank {pid}: no report line")
        reports.append(json.loads(lines[0][len(MESH_MARKER):]))
    total = 0
    for path in ("shard_map", "runtime"):
        rows = [r[path] for r in reports]
        for pid, row in enumerate(rows):
            got = {k: row[k] for k in want}
            check(got == want, f"mesh rank {pid}, {path}: {got} differs from the pooled run {want}")
            check(row["purity"] >= CL_PURITY, f"mesh rank {pid}, {path}: purity {row['purity']:.6f}")
            check(row["gathers"]["stats_calls"] == 1,
                  f"mesh rank {pid}, {path}: {row['gathers']['stats_calls']} gathers")
            for name in MH_KMEANS:
                check(row["held"][name] == row["launches"][name],
                      f"mesh rank {pid}, {path}: {row['held'][name]} of {row['launches'][name]} {name} launches held")
            n_launch = sum(row["launches"].values())
            check(n_launch > 0, f"mesh rank {pid}, {path}: no kmeans_assign launch")
            total += n_launch
        log(json.dumps({"mesh": path, "ranks": MESH_SITES, "points_a_site": int(pooled.shape[0]) // MESH_SITES,
                        **{k: [r[k] for r in rows] for k in ("wall_s", "launches", "gathers")},
                        **({"compute_s": [r["compute_s"] for r in rows]} if path == "shard_map" else
                           {"measured_s": [r["measured_s"] for r in rows], "backend": rows[0]["backend"]}),
                        "purity": rows[0]["purity"], "card": card}))
    log(f"mesh: {MESH_SITES} gloo ranks on {reports[0]['topology']['device_name']}, {group_s:.3f} s with start-up; "
        f"every rank's vcluster_shard_map and GridRuntime (sync shard_map) == the pooled runs bit for bit, one "
        f"gather a run, every launch held; phase 24 {time.perf_counter() - t_phase:.1f} s")
    return total


# phase 28: the synchronous train step (train.steps.make_train_step),
# trained on launch/train.py's default arch, stablelm-1.6b
# (hf:stabilityai/stablelm-2-1_6b), at its published widths: 24 layers,
# d_model 2,048, 32 heads of 64, d_ff 5,632, an untied lm_head over 100,352
# ids, LayerNorm, 25% partial RoPE; bf16 compute, f32 parameters and
# moments, remat "full"; TokenStream(vocab, 4, 4,096, seed=0)'s batch 0 for
# every step, so the loss must fall; AdamWConfig(lr=3e-3, warmup=5,
# decay_steps=10) as launch/train.py builds it.  It runs in a child process
# of its own (this script with --train-child), the only one with
# CUBLAS_WORKSPACE_CONFIG set and torch.use_deterministic_algorithms(True):
# bit-identical runs need the embedding's backward (index_put_ with
# accumulate) in its deterministic form, and deterministic mode refuses
# cuBLAS without that workspace setting, which must precede torch's first
# cuBLAS call; no other phase runs with either.  The CE's gather backward
# adds one value into each zeroed slot (one gold id a row), so it is exact
# in any order.  Then, at a reduced width in float32, the card's step
# against the port's CPU step of the same state, remat "none" and "full".
TR_ARCH = "stablelm-1.6b"
TR_PARAMS = 1_644_367_872
# 2 steps a run, twice: the loss falls, the runs agree (3 until phase 33 needed the seconds)
TR_BATCH, TR_SEQ, TR_STEPS = 4, 4096, 2
TR_OPT = {"lr": 3e-3, "warmup": 5, "decay_steps": 10}
TR_SMALL = {"batch": 4, "seq": 64, "steps": 2}
TR_LOSS_RTOL = 1e-5
TR_TOL = 1e-4  # tests/test_torch_train.py: 1e-4 of a leaf's largest magnitude, the band rule for AdamW
TR_MARKER = "TRAIN_CHILD "
TR_TIMEOUT_S = 540  # 420 until phase 33 took xlstm-1.3b (~140 s more)
TR_CHILD = [sys.executable, os.path.abspath(__file__)]  # how the child starts
TR_WORKSPACE = ":4096:8"
# what the child's determinism costs: one step with the deterministic
# algorithms off, one with torch's NaN fill of new tensors on, and the bf16
# GEMM probe in both processes; measured by tools/lm_phases.py --phases 28,
# left out of the script's own run
TR_COSTS = False
TR_GEMMS = ((16_384, 2_048, 5_632), (16_384, 5_632, 2_048), (16_384, 2_048, 2_048))  # the step's (M, K, N)
TR_PHASES = (28, 29, 30, 31, 32, 33)  # what run_train runs; the train child runs 28-30 and 33, 32's traces run here
# phase 29: GridLocal (train.steps.make_gridlocal_train_step), the paper's
# single-aggregation pattern applied to training, over 2 pods of phase 28's
# model on the one card: phase 28's batch split into 2 x 4,096 tokens a pod,
# GL_STEPS global steps with a merge every 2, int8 deltas summed in int16
# (4 steps and 2 merges until phase 33 needed the seconds); then the reduced
# f32 GridLocal step on the card against the CPU in both merge modes
GL_PODS, GL_STEPS = 2, 2
GL_OUTER = {"h_steps": 2, "outer_lr": 0.7, "outer_momentum": 0.9, "compress": "int8"}
GL_SMALL = {"batch": 4, "seq": 64, "steps": 4}
# phase 30: the training entry (launch.train) at --reduced on the card, on
# a one-rank NCCL group made here (the entry's (1, 1) data mesh: the one
# card): --steps 6 unbroken against --steps 3 then --steps 6 --resume, and
# the unbroken step 6 against ENTRY_PLAIN plain make_train_step steps from
# the same seed saved through the checkpointer (the entry without a mesh)
ENTRY_ARGS = ["--reduced", "--ckpt-every", "3"]
ENTRY_PLAIN = {"steps": 6, "batch": 4, "seq": 64, "lr": 3e-3, "warmup": 5, "decay_steps": 10}
# phase 31: the one-card dry run (launch.dryrun) of phase 28's own cell on
# fake CUDA tensors at grad_accum 1 and 2, traced in this process while the
# train child runs, since the traces are host work (phase 28's timed steps
# run beside them): its estimated peak held within DR_PEAK_RTOL of
# phase 28's torch.cuda.max_memory_allocated at each; its counted FLOPs and
# model FLOPs over phase 28's measured step (hfu, mfu) and launch.mesh.HW's
# data-sheet roofline; the step's DR_TOP ops of most traffic; and the
# card's achieved bf16 matmul (DR_GEMM cubed) and device-to-device copy
# (DR_COPY_BYTES) rates beside the data sheet's
DR_PEAK_RTOL = 0.10
DR_GEMM = 8192
DR_COPY_BYTES = 4 * 10**9
DR_TOP = 10


# phase 33: the train step of three more archs at their published widths,
# in the train child after phases 28-30 and under its determinism:
# gemma2-2b (hf:google/gemma-2-2b; the oracle's tanh softcap of 50, its
# 4,096-token window on alternate layers and the final softcap of 30 over
# 256,000 ids, all in the backward pass) and zamba2-1.2b
# (hf:Zyphra/Zamba2-1.2B; Mamba-2's chunked scan and the shared attention
# block) at their published depth, and xlstm-1.3b (arXiv:2405.04517) cut to
# one period of its pattern, 8 layers (7 mLSTM, 1 sLSTM: the sLSTM's eager
# loop of 4,096 cell steps, twice forward under the remat and once
# backward, ~7.6e5 aten ops a step; its 48 layers take minutes a step and
# do not fit the card at 4 rows, so tools/xlstm_train_full_width.py trains
# them at 2); each with its published parameter count checked, phase 28's
# batch shape (TokenStream(vocab, 4, 4,096, seed=0)'s batch 0), AdamWConfig
# and remat "full", bf16 compute over f32 state: its steps a run twice from
# seed 0, bit-identical with finite losses, the last step of the second run
# traced (gemma2-2b, zamba2-1.2b); the peak held within DR_PEAK_RTOL of the one-card dry run's
# estimate of the same cell, read from the record committed under A33_DRYRUN
# (written by ``python -m repro_torch.launch.dryrun --arch A --shape
# train_4k --global-batch 4 --grad-accum 1 --device cpu``: zamba2's trace
# takes minutes of host time this script does not have), printed without a
# gate for a cut arch (no record counts its cut); and the reduced f32 step
# on the card against the CPU, as phase 28 holds stablelm's.
# arch: (parameters at the published depth, layers run (None: all), steps a
# run, whether the second run's last step is traced); xlstm-1.3b's one step
# a run is all the bit-identity needs, and its trace, ~50 s, is taken at the
# published depth by tools/xlstm_train_full_width.py
A33_ARCHS = {"gemma2-2b": (2_614_341_888, None, 2, True), "zamba2-1.2b": (1_104_777_344, None, 2, True),
             "xlstm-1.3b": (1_665_014_096, 8, 1, False)}
A33_DRYRUN = os.path.join(ROOT, "experiments", "dryrun_torch", "{arch}__train_4k__b4.json")


# phase 32: the sharded step on DTensors, in a process of its own (this
# script with --shard-child, deterministic as phase 28's child): a one-rank
# NCCL DeviceMesh (data 1, model 1) on the card, so every placement the
# sharding rules give is a shard of one; stablelm-1.6b at published widths
# and SH_LAYERS layers, SH_STEPS train steps sharded (train.steps.shard_state,
# sharding.activate) bit-identical to make_train_step's on the same state and
# batch; gemma2-2b's bf16 scoring forward through the flash kernel (SH_LAYERS
# layers) and xlstm-1.3b's prefill through the sLSTM kernel (SH_XLSTM_LAYERS)
# at published widths, sharded, each bit-identical to the unsharded run and
# launching its kernel from under DTensor as often.  In this process while
# the train child runs: the 16x16 dry run (launch.dryrun --mesh 16x16) of
# stablelm-1.6b train_4k on a fake 256-rank group with fake CUDA tensors,
# its per-device counts equal to the same count on fake CPU tensors.
SH_LAYERS = 2
# xlstm-1.3b's pattern is 7 mLSTM then 1 sLSTM: 2 layers hold no sLSTM, so
# its cut is one period of the published pattern
SH_XLSTM_LAYERS = 8
SH_STEPS = 2
SH_BATCH, SH_SEQ = 4, 4096
SH_SERVE = {"batch": 2, "seq": 4096}
SH_MARKER = "SHARD_CHILD "
SH_TIMEOUT_S = 300
SH_CHILD = [sys.executable, os.path.abspath(__file__)]  # how the child starts
SH_MESH_CELL = ("stablelm-1.6b", "train_4k", "16x16")


def local_digest(model) -> str:
    """``params_digest`` of a model whose parameters may be DTensors (their
    local shards: the whole tensor on a one-rank mesh)."""
    class _Local(torch.nn.Module):
        def named_parameters(self, *a, **k):
            for name, p in model.named_parameters():
                yield name, (p.to_local() if hasattr(p, "to_local") else p)

    return params_digest(_Local())


def shard_child(argv) -> None:
    """Phase 32's child (see above): prints its report lines and one marker
    line of JSON; fails (exit 1) on any check."""
    import dataclasses

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the shard child needs the CUDA card")
    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == TR_WORKSPACE, "the shard child needs CUBLAS_WORKSPACE_CONFIG")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStream, place_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_device_mesh, make_test_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import BASELINE, activate
    from repro_torch.train import steps

    wait_for_the_card(argv)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    dev = torch.device(DEVICE)
    port = int(argv[argv.index("--port") + 1])
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    mesh = make_device_mesh(make_test_mesh(1, 1), "cuda")
    out = {}
    try:
        # stablelm train: SH_STEPS steps unsharded, then from the same draw sharded
        cfg = dataclasses.replace(configs.get(TR_ARCH), n_layers=SH_LAYERS)
        batch_np = TokenStream(vocab=cfg.vocab, global_batch=SH_BATCH, seq_len=SH_SEQ, seed=0).batch_at(0)
        batch = {k: torch.from_numpy(v).long().to(dev) for k, v in batch_np.items()}
        opt = AdamWConfig(**TR_OPT)
        runs = {}
        for sharded in (False, True):
            torch.cuda.empty_cache()
            state = steps.materialize_state(cfg, torch.Generator(device=dev).manual_seed(0), dev)
            b = batch
            if sharded:
                state = steps.shard_state(cfg, state, mesh, BASELINE)
                b = place_batch(batch, mesh, BASELINE)
            step = steps.make_train_step(cfg, opt)
            losses, norms, ms = [], [], []
            for _ in range(SH_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if sharded:
                    with activate(mesh, BASELINE):
                        state, met = step(state, b)
                else:
                    state, met = step(state, b)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(met["loss"].full_tensor() if hasattr(met["loss"], "full_tensor") else met["loss"]))
                g = met["grad_norm"]
                norms.append(float(g.full_tensor() if hasattr(g, "full_tensor") else g))
            runs[sharded] = {"losses": losses, "grad_norms": norms, "step_ms": ms,
                             "digest": local_digest(state["params"])}
            del state, step
        check(runs[True]["losses"] == runs[False]["losses"] and runs[True]["grad_norms"] == runs[False]["grad_norms"]
              and runs[True]["digest"] == runs[False]["digest"],
              f"the sharded train steps are not bit-identical to make_train_step's: {runs}")
        out["train"] = {"layers": SH_LAYERS, "tokens": SH_BATCH * SH_SEQ, "plain": runs[False], "sharded": runs[True]}

        # the kernels under DTensor: gemma2 scoring (flash), xlstm prefill (sLSTM)
        def kernel_run(arch, flag, kernel, fn, layers):
            kcfg = dataclasses.replace(configs.get(arch), n_layers=layers, **{flag: True})
            model = T.Model(kcfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
            tok = torch.from_numpy(TokenStream(vocab=kcfg.vocab, global_batch=SH_SERVE["batch"],
                                               seq_len=SH_SERVE["seq"], seed=1).batch_at(0)["tokens"]).long().to(dev)
            row = {}
            for sharded in (False, True):
                if sharded:
                    steps.shard_model(kcfg, model, mesh, BASELINE)
                ops.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    if sharded:
                        with activate(mesh, BASELINE):
                            res = fn(kcfg, model, place_batch({"tokens": tok}, mesh, BASELINE)["tokens"],
                                     True)
                    else:
                        res = fn(kcfg, model, tok, False)
                torch.cuda.synchronize()
                res = [r.full_tensor() if hasattr(r, "full_tensor") else r for r in res]
                row[sharded] = {"ms": (time.perf_counter() - t0) * 1e3, "launches": ops.LAUNCHES.get(kernel, 0),
                                "res": res}
            same = all(torch.equal(a, b) for a, b in zip(row[False]["res"], row[True]["res"]))
            check(same, f"{arch}: the sharded {kernel} run is not bit-identical to the unsharded one")
            check(row[True]["launches"] == row[False]["launches"] > 0,
                  f"{arch}: {kernel} launched {row[True]['launches']} times sharded, {row[False]['launches']} unsharded")
            del model
            torch.cuda.empty_cache()
            return {"layers": layers, **SH_SERVE, "launches": row[True]["launches"],
                    "plain_ms": row[False]["ms"], "sharded_ms": row[True]["ms"]}

        def scoring(kcfg, model, tok, sharded):
            h, _ = T.forward_train(kcfg, model, tok, return_hidden=True)
            return [h]

        def prefill(kcfg, model, tok, sharded):
            cache = T.init_cache(kcfg, tok.shape[0], tok.shape[1], dev)
            if sharded:
                cache = steps.shard_cache(kcfg, cache, mesh, BASELINE)
            lg, cache = T.prefill(kcfg, model, tok, cache)
            return [lg] + [t for c in cache for t in c.values()]

        out["flash"] = kernel_run("gemma2-2b", "flash_kernel", "flash_attention", scoring, SH_LAYERS)
        out["slstm"] = kernel_run("xlstm-1.3b", "slstm_kernel", "slstm_scan", prefill, SH_XLSTM_LAYERS)
    finally:
        dist.destroy_process_group()
    print(SH_MARKER + json.dumps(out), flush=True)
    quick_exit()


def mesh_traces() -> dict:
    """Phase 32's traces: the 16x16 dry run of SH_MESH_CELL on a fake
    256-rank group, on fake CUDA tensors and on fake CPU tensors (each
    count makes the fake group and destroys it)."""
    from repro_torch.launch import dryrun

    arch, shape, mesh = SH_MESH_CELL
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, save=False, device=device, mesh=mesh)
        out[device] = {k: rec[k] for k in ("hlo_flops_per_device", "hlo_bytes_per_device", "collectives", "memory",
                                           "grad_accum", "roofline")}
        out[device]["trace_s"] = rec["timing"]["trace_s"]
        out[device]["wall_s"] = time.perf_counter() - t0
    check("jax" not in sys.modules, "the dry run imported jax")
    return out


def wait_for_the_card(argv) -> None:
    """A child started ahead of its turn (``--wait``) has imported torch
    and the port; it touches the card only once the parent writes "go" on
    its standard input, and exits at once if the parent closes it first."""
    if "--wait" in argv and sys.stdin.readline().strip() != "go":
        sys.exit(1)


def quick_exit() -> None:
    """End a child once its report is out, without the interpreter's
    teardown of the card's cached allocations."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


class Child:
    """A child process (``cmd``, this script, then ``argv``), started now
    with ``--wait``, its output into files under build/<name>/
    so that it never waits on this process; ``go`` hands it the card,
    ``finish`` waits for it and returns (return code, stdout, stderr), and
    ``stop`` ends it if it still runs."""

    def __init__(self, name: str, cmd: list, argv: list):
        logs = os.path.join(ROOT, "build", name)
        os.makedirs(logs, exist_ok=True)
        self.out = open(os.path.join(logs, "stdout"), "w+")
        self.err = open(os.path.join(logs, "stderr"), "w+")
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=TR_WORKSPACE)
        self.p = subprocess.Popen([*cmd, *argv, "--wait"], stdin=subprocess.PIPE, stdout=self.out, stderr=self.err,
                                  text=True, env=env)

    def go(self) -> None:
        self.p.stdin.write("go\n")
        self.p.stdin.close()

    def finish(self, timeout: float) -> tuple:
        try:
            self.p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            return None, "", ""
        self.out.seek(0)
        self.err.seek(0)
        out = (self.p.returncode, self.out.read(), self.err.read())
        self.out.close()
        self.err.close()
        return out

    def stop(self) -> None:
        if self.p.poll() is None:
            if not self.p.stdin.closed:
                self.p.stdin.close()
            self.p.kill()
            self.p.wait()


def start_train_children(phases=TR_PHASES) -> dict:
    """The train child (phases 28-30 and 33 of ``phases``) and phase 32's
    shard child, started ahead of their turn: each imports torch and the
    port beside the phases still running here, then waits for the card."""
    phases = set(phases) | ({28} if 31 in phases else set())
    child = sorted(phases - {31, 32})
    out = {}
    if child:
        out["train"] = Child("train_child", TR_CHILD, ["--train-child", "--phases", ",".join(map(str, child)),
                                                       *(["--costs"] if TR_COSTS else [])])
    if 32 in phases:
        with socket.socket() as so:
            so.bind(("localhost", 0))
            port = so.getsockname()[1]
        out["shard"] = Child("shard_child", SH_CHILD, ["--shard-child", "--port", str(port)])
    return out


def run_sharded(card: str, traces: dict, shard: Child) -> dict:
    """Phase 32 (see above) once the train child is done: the shard child,
    then the traces' check.  Returns the child's report."""
    t0 = time.perf_counter()
    shard.go()
    rc, stdout, stderr = shard.finish(SH_TIMEOUT_S)
    check(rc is not None, f"the shard child did not finish in {SH_TIMEOUT_S} s")
    sys.stderr.write(stderr[-6000:])
    rows = [json.loads(line[len(SH_MARKER):]) for line in stdout.splitlines() if line.startswith(SH_MARKER)]
    check(rc == 0 and len(rows) == 1, f"the shard child exited {rc}:\n{stderr[-3000:]}")
    out = rows[0]
    tr = out["train"]
    log(f"{TR_ARCH} sharded train ({tr['layers']} layers at published widths, {tr['tokens']:,} tokens a step, "
        f"one-rank NCCL mesh data 1 x model 1): losses {tr['sharded']['losses']}, bit-identical to make_train_step "
        f"(losses, grad norms, every parameter's bits); ms a step sharded {[round(x, 1) for x in tr['sharded']['step_ms']]}, "
        f"unsharded {[round(x, 1) for x in tr['plain']['step_ms']]}; {card}")
    for key, arch, what in (("flash", "gemma2-2b", "scoring"), ("slstm", "xlstm-1.3b", "prefill")):
        r = out[key]
        log(f"{arch} sharded {what} ({r['layers']} layers, {r['batch']} x {r['seq']}): {r['launches']} "
            f"{'flash_attention' if key == 'flash' else 'slstm_scan'} launches from under DTensor, as unsharded, "
            f"bit-identical; {r['sharded_ms']:.1f} ms sharded, {r['plain_ms']:.1f} ms unsharded (first runs); {card}")
    cuda, cpu = traces["cuda"], traces["cpu"]
    for k in ("hlo_flops_per_device", "hlo_bytes_per_device", "collectives", "memory", "grad_accum"):
        check(cuda[k] == cpu[k], f"the 16x16 dry run on fake CUDA tensors differs from the CPU's in {k}: "
                                 f"{cuda[k]} vs {cpu[k]}")
    arch, shape, mesh = SH_MESH_CELL
    log(f"{arch} {shape} on {mesh} (fake 256-rank group): per device {cuda['hlo_flops_per_device']:.4e} FLOPs, "
        f"{cuda['hlo_bytes_per_device']:.4e} B, collectives {cuda['collectives']['total_bytes']:.4e} B, peak "
        f"{cuda['memory']['peak_est_bytes'] / 1e9:.3f} GB at grad_accum {cuda['grad_accum']}, equal on fake CUDA "
        f"and CPU tensors; traces {cuda['trace_s']:.1f} s (CUDA) and {cpu['trace_s']:.1f} s (CPU) while the train "
        f"child ran")
    out["traces"] = traces
    log(f"phase 32: {time.perf_counter() - t0:.1f} s after the train child")
    return out


def gemm_probe(dev) -> dict:
    """Median ms of the step's three largest bf16 matmul shapes, in this
    process's cuBLAS setting (what the child's workspace setting costs)."""
    out = {}
    for m, k, n in TR_GEMMS:
        a = torch.randn((m, k), device=dev, dtype=torch.bfloat16)
        b = torch.randn((k, n), device=dev, dtype=torch.bfloat16)
        out[f"{m}x{k}x{n}"] = median_ms(lambda: a @ b, reps=20)
        del a, b
    return out


def params_digest(model) -> str:
    """sha256 over each parameter's (name, Σ bits, Σ bits·(i mod 65,521))
    as int64 on the card: any changed bit changes it."""
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        bits = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 65_521
        h.update(f"{name}:{int(bits.sum())}:{int((bits * w).sum())};".encode())
        del bits, w
    return h.hexdigest()


def band_close(got: dict, want: dict, band: dict, lr_sum: float, slack: dict | None = None) -> tuple:
    """The CPU parity tests' rule for parameters after train steps
    (tests/test_torch_train.py): each within TR_TOL of its leaf's largest
    magnitude plus 1% of Σlr (AdamW's normalised step turns a gradient's
    relative error into up to that share of a step), and within 2·Σlr more
    where a step's gradient was non-zero but inside 2·TR_TOL of its leaf's
    largest magnitude of zero (AdamW may then step either way), fewer than
    1 in 1,000 elements needing that band; ``slack`` adds to a leaf's
    bound (GridLocal's int8 quanta, tests/test_torch_gridlocal.py).
    Returns (ok, the largest error over its bound, elements that needed
    the band)."""
    worst, used, n_all = 0.0, 0, 0
    for k, w in want.items():
        g = got[k].detach().float().cpu()
        w = w.detach().float().cpu()
        strict = TR_TOL * float(w.abs().max()) + 1e-2 * lr_sum + (slack or {}).get(k, 0.0)
        err = (g - w).abs()
        bound = torch.where(band[k].cpu(), strict + 2 * lr_sum, torch.full_like(err, strict))
        worst = max(worst, float((err / bound.clamp(min=1e-30)).max()))
        used += int((band[k].cpu() & (err > strict)).sum())
        n_all += w.numel()
    return worst <= 1.0 and used * 1000 < n_all, worst, used


def train_child(argv) -> None:
    """Phases 28-30 and 33 in their own process (``--phases`` picks some:
    28, 29, 30 and 33 by default): stablelm-1.6b trained at published
    widths, twice from one seed, the step's time, memory and profile, and
    the reduced f32 step on the card against the CPU (28); GridLocal over
    two pods of it (29); the training entry resumed against unbroken (30);
    gemma2-2b and zamba2-1.2b trained as stablelm is, their peaks against
    the committed dry runs, and xlstm-1.3b at one period of its pattern
    (33).  Prints its report lines and one marker
    line of JSON; fails (exit 1) on any check."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the train child needs the CUDA card")
    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == TR_WORKSPACE, "the train child needs CUBLAS_WORKSPACE_CONFIG")
    sys.path.insert(0, os.path.join(ROOT, "src"))

    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig

    check("jax" not in sys.modules and not any(m == "repro" or m.startswith("repro.") for m in sys.modules),
          "the train child imported jax or the JAX package")
    wait_for_the_card(argv)
    torch.use_deterministic_algorithms(True)
    # deterministic mode also fills every new tensor with NaN, to expose
    # reads of memory never written; the train step reads none (the second
    # run's bits and the f32 card-against-CPU check would show it), and the
    # fills took 0.71 s of a 7.81 s step on an H100 80GB HBM3 at 700 W
    torch.utils.deterministic.fill_uninitialized_memory = False
    dev = torch.device(DEVICE)
    phases = {int(x) for x in argv[argv.index("--phases") + 1].split(",")} if "--phases" in argv else {28, 29, 30, 33}
    cfg = configs.get(TR_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.remat == "full" and not cfg.flash_kernel, f"{TR_ARCH}: {cfg}")
    n_params = T.param_count(cfg)
    check(n_params == TR_PARAMS, f"{TR_ARCH}: {n_params} parameters, want {TR_PARAMS}")
    batch_np = TokenStream(vocab=cfg.vocab, global_batch=TR_BATCH, seq_len=TR_SEQ, seed=0).batch_at(0)
    batch = {k: torch.from_numpy(v).long().to(dev) for k, v in batch_np.items()}
    opt = AdamWConfig(**TR_OPT)
    out = {"phases": sorted(phases), "params": n_params}
    if 28 in phases:
        t_phase = time.perf_counter()
        out.update(train_phase(dev, cfg, batch, opt, "--costs" in argv))
        out["phase_s"] = time.perf_counter() - t_phase
    if 29 in phases:
        out["gridlocal"] = gridlocal_phase(dev, cfg, batch, opt)
    if 30 in phases:
        out["entry"] = entry_phase()
    if 33 in phases:
        t_phase = time.perf_counter()
        out["archs"] = archs_train_phase(dev, opt)
        out["archs_phase_s"] = time.perf_counter() - t_phase
    print(TR_MARKER + json.dumps(out), flush=True)
    quick_exit()


def train_run(dev, cfg, batch, opt, n_steps: int, label: str, trace_last: bool = False,
              host_ops: bool = True, traced_with=None) -> tuple:
    """``n_steps`` train steps of ``cfg`` on ``batch`` from seed 0, each
    timed to a synchronize; with ``trace_last`` the last one under the
    profiler (one traced step, no bare or cProfiled one, the host's ops
    traced too unless ``host_ops`` is False, inside the context
    ``traced_with()`` when given), its time left out.  Returns (state,
    losses, grad norms, ms, peak GB, profile row)."""
    import contextlib

    from repro_torch.train import steps

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    holder = {"state": steps.materialize_state(cfg, torch.Generator(device=dev).manual_seed(0), dev)}
    step = steps.make_train_step(cfg, opt)
    losses, norms, ms, prof = [], [], [], None

    def one_step():
        holder["state"], holder["met"] = step(holder["state"], batch)

    for i in range(n_steps):
        if trace_last and i == n_steps - 1:
            with (traced_with or contextlib.nullcontext)():
                prof = profile_main_path(one_step, path=f"{cfg.name} train step", bare=False, host=False,
                                         host_ops=host_ops)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(holder["met"]["loss"]))
        norms.append(float(holder["met"]["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{cfg.name} train {label}: losses {losses}, grad norms {norms}, lr {float(holder['met']['lr'])}, "
        f"ms a step {[round(x, 1) for x in ms]}{' and one traced' if trace_last else ''}, peak {peak:.2f} GB, "
        f"n_tok {int(holder['met']['n_tok'])}")
    return holder["state"], losses, norms, ms, peak, prof


def f32_card_against_cpu(cfg, opt) -> dict:
    """The reduced width of ``cfg`` in f32: the card's step equals the
    CPU's from one state, TR_SMALL's steps at remat "none" and "full",
    the card at grad_accum 1 and 2 (the loss within TR_LOSS_RTOL at 1, the
    parameters by ``band_close``).  Fails past the tolerance; returns the
    errors by remat and grad_accum."""
    import copy

    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.train import steps

    small = configs.reduced(cfg)
    sb = TokenStream(vocab=small.vocab, global_batch=TR_SMALL["batch"], seq_len=TR_SMALL["seq"], seed=0,
                     frontend_len=small.frontend_len if small.frontend != "none" else 0,
                     d_model=small.d_model).batch_at(0)
    f32 = {}
    for remat in ("none", "full"):
        scfg = small.scaled(remat=remat)
        base = T.Model(scfg, device="cpu", generator=torch.Generator().manual_seed(0))
        runs = {}
        for where, accum in (("cpu", 1), (DEVICE, 1), (DEVICE, 2)):
            model = copy.deepcopy(base).to(where)
            st = {"params": model, "opt": steps.adamw_init(steps.named_params(scfg, model))}
            b = {k: (torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)).to(where)
                 for k, v in sb.items()}
            band, real = {}, steps.adamw_update

            def grab(c, g, s_, p):
                for k, v in g.items():
                    m = (v.abs() <= 2 * TR_TOL * v.abs().max()) & (v != 0)
                    band[k] = band[k] | m if k in band else m
                return real(c, g, s_, p)

            steps.adamw_update = grab
            try:
                fn = steps.make_train_step(scfg, opt, grad_accum=accum)
                mets = []
                for _ in range(TR_SMALL["steps"]):
                    st, met = fn(st, b)
                    mets.append({k: float(v) for k, v in met.items()})
            finally:
                steps.adamw_update = real
            runs[(where, accum)] = (mets, steps.named_params(scfg, st["params"]), band)
        cpu_m, cpu_p, cpu_band = runs[("cpu", 1)]
        lr_sum = sum(m["lr"] for m in cpu_m)
        row = {}
        for key in ((DEVICE, 1), (DEVICE, 2)):
            mets, params, _ = runs[key]
            loss_err = max(abs(a["loss"] - c["loss"]) / abs(c["loss"]) for a, c in zip(mets, cpu_m))
            ok, worst, used = band_close(params, cpu_p, cpu_band, lr_sum)
            row[f"accum{key[1]}"] = {"loss_rel_err": loss_err, "params_err_over_bound": worst, "band_used": used}
            if key[1] == 1:
                check(loss_err <= TR_LOSS_RTOL,
                      f"{cfg.name} f32 remat {remat}: the card's loss differs from the CPU's by {loss_err}")
            check(ok, f"{cfg.name} f32 remat {remat}, grad_accum {key[1]}: parameters past the tolerance "
                      f"({worst}, {used})")
        f32[remat] = row
        log(f"{cfg.name} reduced f32, remat {remat}: card vs CPU after {TR_SMALL['steps']} steps {json.dumps(row)}")
    return f32


def train_phase(dev, cfg, batch, opt, costs: bool) -> dict:
    """Phase 28 (see above): returns its report."""
    from repro_torch.models import transformer as T
    from repro_torch.train import steps

    out = {"gemm_ms": gemm_probe(dev)} if costs else {}
    n_params = T.param_count(cfg)
    tokens = TR_BATCH * TR_SEQ

    def run(label, trace_last=False):
        return train_run(dev, cfg, batch, opt, TR_STEPS, label, trace_last)

    state, losses, norms, ms1, peak1, _ = run("run 1")
    check(all(math.isfinite(x) for x in losses + norms), f"a loss or grad norm is not finite: {losses} {norms}")
    check(losses[-1] < losses[0], f"the loss did not fall from step 1 to step {TR_STEPS}: {losses}")
    digest1 = params_digest(state["params"])
    del state
    state, losses2, norms2, ms2, _, prof = run("run 2", trace_last=True)
    digest2 = params_digest(state["params"])
    check(losses2 == losses and norms2 == norms and digest2 == digest1,
          f"a second run from seed 0 differs: {losses2} {norms2} {digest2} vs {losses} {norms} {digest1}")
    timed = ms1[1:] + ms2  # the first step warms the process up; run 2 starts warm
    out.update(params=n_params, losses=losses, grad_norms=norms, digest=digest1, step_ms=ms1 + ms2,
               median_step_ms=statistics.median(timed), first_step_ms=ms1[0], peak_gb={"1": peak1},
               device_idle_share=prof["device_idle_share"], device_top=prof["device_top"],
               traced_step_ms=prof["traced_wall_ms"])
    out["tokens_per_s"] = tokens / (out["median_step_ms"] / 1e3)

    # grad_accum 2 (two microbatches of 2 x 4,096) from run 2's state, and
    # with TR_COSTS one step with the deterministic algorithms off
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step2 = steps.make_train_step(cfg, opt, grad_accum=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, met2 = step2(state, batch)
    torch.cuda.synchronize()
    out["accum2_ms"] = (time.perf_counter() - t0) * 1e3
    out["peak_gb"]["2"] = torch.cuda.max_memory_allocated() / 1e9
    check(math.isfinite(float(met2["loss"])), "grad_accum 2: the loss is not finite")
    if costs:
        step1 = steps.make_train_step(cfg, opt)
        torch.use_deterministic_algorithms(False)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step1(state, batch)
            torch.cuda.synchronize()
            out["nondeterministic_step_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = True  # and one step with the fills, as by default
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step1(state, batch)
            torch.cuda.synchronize()
            out["filled_step_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            torch.utils.deterministic.fill_uninitialized_memory = False
    del state, step2
    torch.cuda.empty_cache()

    out["f32"] = f32_card_against_cpu(cfg, opt)
    try:
        steps.make_train_step(cfg.scaled(flash_kernel=True))
        fail("make_train_step accepted flash_kernel=True")
    except ValueError as e:
        check("flash_kernel" in str(e), f"the refusal does not name the flag: {e}")
    return out


def archs_train_phase(dev, opt) -> dict:
    """Phase 33 (see above): returns its report by arch."""
    out = {}
    for arch, (want, layers, n_steps, traced) in A33_ARCHS.items():
        record = A33_DRYRUN.format(arch=arch) if layers is None else None
        out[arch] = arch_train(dev, opt, arch, want, n_steps, layers=layers, record=record, trace=traced)
    return out


def arch_train(dev, opt, arch: str, want: int, n_steps: int, layers=None, rows: int = TR_BATCH,
               record: str | None = None, f32: bool = True, trace: bool = True, traced_with=None) -> dict:
    """One arch of phase 33: ``arch`` at its published widths (``want``
    parameters at its published depth), cut to ``layers`` when given,
    ``rows`` x TR_SEQ tokens a step, ``n_steps`` steps twice from seed 0,
    bit-identical with finite losses, with ``trace`` the last step of the
    second run traced (device events only, inside the context
    ``traced_with`` makes, when given); the peak held within DR_PEAK_RTOL of ``record``'s estimate when a
    record of the same cell is given, else printed; with ``f32`` the reduced
    f32 step on the card against the CPU.  Returns the arch's row."""
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import transformer as T

    card = card_line()
    t_arch = time.perf_counter()
    cfg = configs.get(arch)
    check(cfg.dtype == "bfloat16" and cfg.remat == "full" and not cfg.flash_kernel and not cfg.slstm_kernel,
          f"{arch}: {cfg}")
    published = T.param_count(cfg)
    check(published == want, f"{arch}: {published} parameters, want {want}")
    if layers is not None:
        check(layers % cfg.pattern_period == 0, f"{arch}: {layers} layers cut the pattern's period")
        cfg = cfg.scaled(n_layers=layers)
    n_params = T.param_count(cfg)
    tokens = rows * TR_SEQ
    rec = None
    if record is not None:
        with open(record) as f:
            rec = json.load(f)
        cell = {k: rec.get(k) for k in ("arch", "kind", "global_batch", "seq_len", "grad_accum", "n_params")}
        check(cell == {"arch": arch, "kind": "train", "global_batch": rows, "seq_len": TR_SEQ, "grad_accum": 1,
                       "n_params": n_params}, f"{arch}: the committed dry run is of another cell: {cell}")
    batch_np = TokenStream(vocab=cfg.vocab, global_batch=rows, seq_len=TR_SEQ, seed=0).batch_at(0)
    batch = {k: torch.from_numpy(v).long().to(dev) for k, v in batch_np.items()}
    state, losses, norms, ms1, peak, _ = train_run(dev, cfg, batch, opt, n_steps, "run 1")
    check(all(math.isfinite(x) for x in losses + norms), f"{arch}: a loss or grad norm is not finite: "
                                                          f"{losses} {norms}")
    digest1 = params_digest(state["params"])
    del state
    state, losses2, norms2, ms2, _, prof = train_run(dev, cfg, batch, opt, n_steps, "run 2", trace_last=trace,
                                                     host_ops=False, traced_with=traced_with)
    digest2 = params_digest(state["params"])
    check(losses2 == losses and norms2 == norms and digest2 == digest1,
          f"{arch}: a second run from seed 0 differs: {losses2} {norms2} {digest2} vs {losses} {norms} {digest1}")
    del state
    torch.cuda.empty_cache()
    depth = f"{cfg.n_layers} layers" + (f" of {configs.get(arch).n_layers}" if layers is not None else "")
    row = {"params": n_params, "published_params": published, "layers": cfg.n_layers, "rows": rows,
           "tokens": tokens, "losses": losses, "grad_norms": norms, "digest": digest1, "step_ms": ms1 + ms2,
           "peak_gb": peak}
    if prof is not None:
        row.update(device_idle_share=prof["device_idle_share"], device_events=prof["device_events"],
                   device_busy_ms=prof["device_busy_ms"], device_top=prof["device_top"],
                   traced_step_ms=prof["traced_wall_ms"], trace_processing_s=prof["trace_processing_s"])
        if "marked" in prof:
            row["marked"] = prof["marked"]
    if rec is not None:
        est = rec["memory"]["peak_est_bytes"]
        row.update(peak_est_bytes=est, peak_rel_err=est / (peak * 1e9) - 1, dryrun_n_ops=rec["n_ops"],
                   dryrun_step_bound_s=rec["roofline"]["bound_s"])
        check(abs(row["peak_rel_err"]) <= DR_PEAK_RTOL,
              f"{arch}: the dry run's peak {est} B is not within {DR_PEAK_RTOL} of the measured {peak * 1e9} B")
        against = f"against the dry run's {est / 1e9:.3f} GB ({row['peak_rel_err']:+.4f})"
    else:
        against = "(no dry run of this cut: no gate)"
    # the first step warms the arch's path up; with one step a run, run 1's
    # only step is the one timed
    timed = (ms1[1:] + ms2) or ms1
    row.update(median_step_ms=statistics.median(timed), first_step_ms=ms1[0])
    row["tokens_per_s"] = tokens / (row["median_step_ms"] / 1e3)
    traced = (f"device idle {prof['device_idle_share']:.4f} over the traced step of {prof['traced_wall_ms']:.1f} ms, "
              f"{prof['device_events']} device events" if prof is not None else "no step traced")
    log(f"{arch} train ({n_params:,} parameters, {depth}, {rows} x {TR_SEQ} tokens a step, remat full, bf16): "
        f"{row['median_step_ms']:.1f} ms a step (median of {len(timed)}: {[round(x, 1) for x in timed]}; the first "
        f"{ms1[0]:.1f} ms), {row['tokens_per_s']:,.0f} tokens/s; losses {losses}, two runs bit-identical; peak "
        f"{peak:.2f} GB {against}; {traced}; {card}")
    if prof is not None:
        log(f"{arch} train step top device ops: {json.dumps(prof['device_top'])}; {card}")
    if f32:
        row["f32"] = f32_card_against_cpu(cfg, opt)
        log(f"{arch} reduced f32 card against CPU {json.dumps(row['f32'])}; {card}")
    row["phase_s"] = time.perf_counter() - t_arch
    return row


def gridlocal_gains(outer_lr: float, mu: float, n_merges: int) -> list:
    """How much of merge j's error reaches the anchor after n_merges
    Nesterov outer steps, j = 1..n_merges: ``outer_lr·(1 + Σ_{t=1}^{M−j+1}
    μ^t)`` (tests/test_torch_gridlocal.py)."""
    return [outer_lr * (1 + sum(mu**t for t in range(1, n_merges - j + 2))) for j in range(1, n_merges + 1)]


def gridlocal_phase(dev, cfg, batch, opt) -> dict:
    """Phase 29: GridLocal over GL_PODS pods of ``cfg`` at published
    widths, GL_STEPS global steps on ``batch`` (each pod its contiguous
    block), every step and merge timed to a synchronize; the pods apart
    after each step without a merge and bit for bit equal to each other and
    to the anchor after each merge; the loss falling.  Then the reduced f32
    GridLocal step on the card against the CPU's, in both merge modes.
    Returns the report."""
    from repro_torch import configs, convert
    from repro_torch.core.gridlocal import param_bytes
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.optim import outer as outer_opt
    from repro_torch.train import steps

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    free_b, total_b = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    oc = outer_opt.OuterConfig(**GL_OUTER)
    state = steps.gridlocal_init(cfg, torch.Generator(device=dev).manual_seed(0), GL_PODS, dev)
    step = steps.make_gridlocal_train_step(cfg, GL_PODS, opt, oc)
    merge_ms, real_merge = [], steps.gridlocal_merge

    def timed_merge(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_merge(*a, **kw)
        torch.cuda.synchronize()
        merge_ms.append((time.perf_counter() - t0) * 1e3)

    losses, norms, ms = [], [], []
    steps.gridlocal_merge = timed_merge
    try:
        for i in range(GL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            pods = [steps.named_params(cfg, m) for m in state["params"]]
            same = all(torch.equal(pods[0][k], p[k]) for p in pods[1:] for k in pods[0])
            if (i + 1) % oc.h_steps:
                check(not same, f"gridlocal step {i + 1}: the pods' parameters are equal before a merge")
            else:
                check(same and all(torch.equal(pods[0][k], a) for k, a in state["outer"]["anchor"].items()),
                      f"gridlocal step {i + 1}: after the merge the pods or the anchor differ")
            del pods
    finally:
        steps.gridlocal_merge = real_merge
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in losses + norms), f"gridlocal: a loss or grad norm is not finite: {losses}")
    check(losses[-1] < losses[0], f"gridlocal: the loss did not fall from step 1 to step {GL_STEPS}: {losses}")
    check(len(merge_ms) == GL_STEPS // oc.h_steps, f"gridlocal: {len(merge_ms)} merges in {GL_STEPS} steps")
    named = steps.named_params(cfg, state["params"][0])
    n_leaves = len({convert.reference_path(cfg, k)[0] for k in named})
    out = {"pods": GL_PODS, "tokens_a_pod": TR_BATCH // GL_PODS * TR_SEQ, "outer": GL_OUTER, "losses": losses,
           "grad_norms": norms, "step_ms": ms, "median_step_ms": statistics.median(ms), "merge_ms": merge_ms,
           "peak_gb": peak, "mem_get_info_gb": [free_b / 1e9, total_b / 1e9],
           "merge_bytes": {"float32": GL_PODS * param_bytes(named),
                           "int8": GL_PODS * (sum(p.numel() for p in named.values()) + 4 * n_leaves)},
           "reference_leaves": n_leaves}
    del state, step, named, met
    torch.cuda.empty_cache()
    log(f"{TR_ARCH} gridlocal ({GL_PODS} pods, {json.dumps(GL_OUTER)}): losses {losses}, grad norms {norms}, "
        f"ms a step {[round(x, 1) for x in ms]}, ms a merge {[round(x, 1) for x in merge_ms]}, peak {peak:.2f} GB, "
        f"free at the start {free_b / 1e9:.2f} of {total_b / 1e9:.2f} GB, merge bytes {json.dumps(out['merge_bytes'])}")

    # the reduced width in f32: the card's GridLocal steps equal the CPU's
    # from one state, both merge modes, by the band rule carried through the
    # outer steps (tests/test_torch_gridlocal.py)
    small = configs.reduced(cfg)
    base = convert.state_to_reference(small, steps.gridlocal_init(small, torch.Generator().manual_seed(0),
                                                                  GL_PODS, "cpu"))
    stream = TokenStream(vocab=small.vocab, global_batch=GL_SMALL["batch"], seq_len=GL_SMALL["seq"], seed=0)
    host = [stream.batch_at(i) for i in range(GL_SMALL["steps"])]
    n_merges = GL_SMALL["steps"] // oc.h_steps
    f32 = {}
    for compress in ("none", "int8"):
        soc = oc._replace(compress=compress)
        runs = {}
        for where in ("cpu", DEVICE):
            st = convert.state_from_reference(small, base, where)
            fn = steps.make_gridlocal_train_step(small, GL_PODS, opt, soc)
            band, scales, mets = {}, [], []
            real_u, real_q = steps.adamw_update, outer_opt.quantize_delta

            def grab(c, g, s_, p, band=band):
                for k, v in g.items():
                    m = (v.abs() <= 2 * TR_TOL * v.abs().max()) & (v != 0)
                    band[k] = band[k] | m if k in band else m
                return real_u(c, g, s_, p)

            def spy(delta, scale=None, scales=scales):
                q, sc = real_q(delta, scale)
                scales.append(float(sc))
                return q, sc

            steps.adamw_update, outer_opt.quantize_delta = grab, spy
            try:
                for b in host:
                    st, met = fn(st, {k: torch.from_numpy(v).long().to(where) for k, v in b.items()})
                    mets.append({k: float(v) for k, v in met.items()})
            finally:
                steps.adamw_update, outer_opt.quantize_delta = real_u, real_q
            got = {f"pod{i}/{k}": v for i, m in enumerate(st["params"]) for k, v in steps.named_params(small, m).items()}
            got.update({f"{part}/{k}": v for part in ("anchor", "momentum") for k, v in st["outer"][part].items()})
            runs[where] = (mets, got, band, scales)
        cpu_m, cpu_got, cpu_band, cpu_scales = runs["cpu"]
        mets, got, _, _ = runs[DEVICE]
        names = list(steps.named_params(small, st["params"][0]))
        g = gridlocal_gains(soc.outer_lr, soc.outer_momentum, n_merges)
        lr_eff = sum(g[j] * sum(m["lr"] for m in cpu_m[j * soc.h_steps:(j + 1) * soc.h_steps]) for j in range(n_merges))
        per_name = {k: 0.0 for k in names}
        if compress == "int8":
            check(len(cpu_scales) == n_merges * len(names), f"gridlocal int8: {len(cpu_scales)} scales")
            for j in range(n_merges):
                for k, sc in zip(names, cpu_scales[j * len(names):(j + 1) * len(names)]):
                    per_name[k] += g[j] * sc / 127
        key_name = {key: key.split("/", 1)[1] for key in cpu_got}
        ok, worst, used = band_close(got, cpu_got, {key: cpu_band[n] for key, n in key_name.items()}, lr_eff,
                                     {key: per_name[n] for key, n in key_name.items()})
        loss_err = max(abs(a["loss"] - c["loss"]) / abs(c["loss"]) for a, c in zip(mets, cpu_m))
        f32[compress] = {"loss_rel_err": loss_err, "params_err_over_bound": worst, "band_used": used,
                         "lr_eff": lr_eff}
        check(loss_err <= TR_LOSS_RTOL, f"gridlocal f32 {compress}: the card's loss differs from the CPU's by {loss_err}")
        check(ok, f"gridlocal f32 {compress}: parameters past the tolerance ({worst}, {used})")
        log(f"{TR_ARCH} reduced f32 gridlocal, compress {compress}: card vs CPU after {GL_SMALL['steps']} steps "
            f"{json.dumps(f32[compress])}")
    out["f32"] = f32
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def same_npy_files(a: str, b: str, what: str) -> tuple:
    """Two ``proc_00000`` directories hold the same ``.npy`` files byte for
    byte (fails otherwise); returns (files, bytes)."""
    names = sorted(os.listdir(a))
    check(bool(names) and names == sorted(os.listdir(b)), f"{what}: the two directories differ in files")
    nbytes = 0
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            da, db = fa.read(), fb.read()
        check(da == db, f"{what}: {n} differs")
        nbytes += len(da)
    return len(names), nbytes


def entry_phase() -> dict:
    """Phase 30: ``launch.train.main`` on the card at ``--reduced``, on a
    one-rank group made here (NCCL on the card) that the entry uses and
    leaves in place: ``--steps 6`` unbroken and ``--steps 3`` then
    ``--steps 6 --resume``, each in a directory of its own under build/;
    the two ``step_0000000006`` directories must hold the same ``.npy``
    files byte for byte, and so must the unbroken one and ``ENTRY_PLAIN``
    plain ``make_train_step`` steps from the same seed saved through the
    checkpointer.  Returns the report."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs, convert
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_step, materialize_state

    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "train entry: the train child already has a process group")
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1)
    t_group = time.perf_counter() - t_phase
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_entry_", dir=os.path.join(ROOT, "build"))
    try:
        unbroken, resumed, plain = (os.path.join(tmp, d) for d in ("unbroken", "resumed", "plain"))
        args = [*ENTRY_ARGS, "--device", DEVICE]
        t0 = time.perf_counter()
        train.main([*args, "--steps", "6", "--ckpt-dir", unbroken])
        t_unbroken = time.perf_counter() - t0
        train.main([*args, "--steps", "3", "--ckpt-dir", resumed])
        train.main([*args, "--steps", "6", "--ckpt-dir", resumed, "--resume"])
        check(dist.is_initialized() and dist.get_world_size() == 1, "train entry: the entry did not keep the group")
        step6 = (os.path.join(d, "step_0000000006", "proc_00000") for d in (unbroken, resumed))
        files, nbytes = same_npy_files(*step6, "train entry, step 6 resumed from step 3 against unbroken")

        p = ENTRY_PLAIN
        t0 = time.perf_counter()
        cfg = configs.reduced(configs.get(TR_ARCH))
        dev = torch.device(DEVICE)
        stream = TokenStream(vocab=cfg.vocab, global_batch=p["batch"], seq_len=p["seq"], seed=0)
        step_fn = make_train_step(cfg, AdamWConfig(lr=p["lr"], warmup=p["warmup"], decay_steps=p["decay_steps"]),
                                  loss_chunk=min(512, p["seq"]))
        state = materialize_state(cfg, device=dev)
        for s in range(p["steps"]):
            state, _ = step_fn(state, {k: torch.from_numpy(v).long().to(dev) for k, v in stream.batch_at(s).items()})
        Checkpointer(plain).save(p["steps"], convert.state_to_reference(cfg, state), wait=True)
        t_plain = time.perf_counter() - t0
        same_npy_files(os.path.join(unbroken, "step_0000000006", "proc_00000"),
                       os.path.join(plain, f"step_{p['steps']:010d}", "proc_00000"),
                       "train entry on its one-rank mesh against plain make_train_step steps")
        procs = sorted({e for d in (unbroken, resumed) for s in os.listdir(d) for e in os.listdir(os.path.join(d, s))
                        if e != "manifest.json"})
        check(procs == ["proc_00000"], f"train entry: step directories hold {procs}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()
    out = {"files": files, "bytes": nbytes, "group_s": t_group, "unbroken_s": t_unbroken, "plain_s": t_plain,
           "backend": "nccl" if DEVICE == "cuda" else "gloo", "phase_s": time.perf_counter() - t_phase}
    log(f"train entry (launch.train --reduced on {DEVICE}, a one-rank {out['backend']} mesh): step 6 resumed from "
        f"step 3 equals unbroken, and unbroken equals {p['steps']} plain make_train_step steps, {files} .npy files, "
        f"{nbytes:,} bytes, byte for byte; group {t_group:.2f} s, the unbroken run {t_unbroken:.2f} s, the plain "
        f"steps {t_plain:.2f} s")
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def dryrun_traces() -> dict:
    """Phase 31's traces: the dry run of phase 28's cell (its config, batch
    and AdamWConfig) on fake CUDA tensors at grad_accum 1 (its ops
    recorded) and 2.  Returns both records by grad_accum, the first with
    its DR_TOP ops of most traffic."""
    from repro_torch import configs
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline.breakdown import top_traffic

    cfg = configs.get(TR_ARCH)
    cell = Shape(f"{TR_BATCH}x{TR_SEQ}", TR_SEQ, TR_BATCH, "train")  # phase 28's batch
    out = {}
    for ga in (1, 2):
        rec = dryrun._run_cell_once(TR_ARCH, cell, False, ga, DEVICE, cfg=cfg, opt_cfg=AdamWConfig(**TR_OPT),
                                    record_ops=ga == 1)
        if ga == 1:
            rec["top_traffic"] = [list(r) for r in top_traffic(rec.pop("_costs"), DR_TOP)]
        out[str(ga)] = rec
    check("jax" not in sys.modules, "the dry run imported jax")
    return out


def dryrun_phase(dev, card: str, measured: dict, recs: dict) -> dict:
    """Phase 31 (see above), once the train child is done: ``measured`` is
    phase 28's report, ``recs`` what ``dryrun_traces`` returned.  Returns
    the phase's report."""
    from repro_torch.launch.mesh import HW

    t_phase = time.perf_counter()
    step_s = measured["median_step_ms"] / 1e3
    out = {"step_s": step_s, "grad_accum": {}, "top_traffic": recs["1"]["top_traffic"]}
    for ga in ("1", "2"):
        rec = recs[ga]
        est, meas = rec["memory"]["peak_est_bytes"], measured["peak_gb"][ga] * 1e9
        row = {"peak_est_bytes": est, "measured_peak_bytes": meas, "peak_rel_err": est / meas - 1,
               "state_bytes": rec["memory"]["state_bytes"], "flops": rec["flops"], "model_flops": rec["model_flops"],
               "traffic_bytes": rec["traffic_bytes"], "n_ops": rec["n_ops"], "roofline": rec["roofline"],
               "trace_s": rec["timing"]["trace_s"]}
        if ga == "1":
            row["mfu"] = rec["model_flops"] / (step_s * HW["peak_flops_bf16"])
            row["hfu"] = rec["flops"] / (step_s * HW["peak_flops_bf16"])
            row["step_over_bound"] = step_s / rec["roofline"]["bound_s"]
        out["grad_accum"][ga] = row
        r = rec["roofline"]
        log(f"{TR_ARCH} dry run of phase 28's cell ({rec['shape']}, grad_accum {ga}, fake {rec['device']} tensors): "
            f"peak_est {est / 1e9:.3f} GB against measured {meas / 1e9:.3f} GB ({row['peak_rel_err']:+.4f}); "
            f"flops {rec['flops']:.4e}, model_flops {rec['model_flops']:.4e}"
            + (f", mfu {row['mfu']:.4f}, hfu {row['hfu']:.4f} over the measured {step_s:.4f} s step" if ga == "1"
               else "")
            + f"; traffic {rec['traffic_bytes']:.4e} B; roofline t_compute {r['t_compute_s']:.4f} s, t_memory "
            f"{r['t_memory_s']:.4f} s, t_collective {r['t_collective_s']:.4f} s, dominant {r['dominant']}, bound "
            f"{r['bound_s']:.4f} s; trace {row['trace_s']:.2f} s; {card}")
        check(abs(row["peak_rel_err"]) <= DR_PEAK_RTOL,
              f"grad_accum {ga}: the dry run's peak {est} B is not within {DR_PEAK_RTOL} of the measured {meas} B")
    log(f"{TR_ARCH} step, the {DR_TOP} ops of most traffic (bytes, count, op, result, where, autograd node): "
        + json.dumps(out["top_traffic"]))

    # the card's achieved rates beside the data sheet's peaks
    a = torch.randn((DR_GEMM, DR_GEMM), device=dev, dtype=torch.bfloat16)
    b = torch.randn((DR_GEMM, DR_GEMM), device=dev, dtype=torch.bfloat16)
    mm_ms = median_ms(lambda: a @ b, reps=10)
    del a, b
    src = torch.empty(DR_COPY_BYTES // 4, device=dev, dtype=torch.float32)
    dst = torch.empty_like(src)
    cp_ms = median_ms(lambda: dst.copy_(src), reps=10)
    del src, dst
    torch.cuda.empty_cache()
    out["achieved"] = {"bf16_matmul_ms": mm_ms, "bf16_matmul_flops_per_s": 2 * DR_GEMM**3 / (mm_ms / 1e3),
                       "copy_ms": cp_ms, "copy_bytes_per_s": 2 * DR_COPY_BYTES / (cp_ms / 1e3),
                       "data_sheet": {"peak_flops_bf16": HW["peak_flops_bf16"], "hbm_bw": HW["hbm_bw"]}}
    ach = out["achieved"]
    log(f"data sheet against achieved: bf16 matmul {DR_GEMM}^3 {mm_ms:.4f} ms, "
        f"{ach['bf16_matmul_flops_per_s'] / 1e12:.1f} TFLOP/s against {HW['peak_flops_bf16'] / 1e12:.0f}; "
        f"copy of {DR_COPY_BYTES / 1e9:.0f} GB {cp_ms:.4f} ms, {ach['copy_bytes_per_s'] / 1e12:.3f} TB/s read + "
        f"written against {HW['hbm_bw'] / 1e12:.2f}; {card}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def run_train(dev, card: str, phases=TR_PHASES, children=None) -> dict:
    """Phases 28-33 (``phases``, all by default; 31 brings 28): the GEMM
    probe here, then the train child (its report lines relayed) with phase
    31's and 32's traces run here while it runs, their results checked and
    summarised, then phase 32's shard child.  ``children`` are the ones
    ``start_train_children`` started ahead (started here when None).  Each
    child writes into files under build/, so that its output never waits
    on this process.  Returns the train child's report."""
    t0 = time.perf_counter()
    phases = set(phases) | ({28} if 31 in phases else set())
    parent_gemm = gemm_probe(dev) if TR_COSTS and 28 in phases else None
    torch.cuda.empty_cache()
    child = sorted(phases - {31, 32})
    children = children if children is not None else start_train_children(phases)
    try:
        if not child:  # phase 32 alone: its traces, then its child
            mesh_recs = mesh_traces()
            return {"phases": [], "sharded": run_sharded(card, mesh_recs, children["shard"])}
        children["train"].go()
        recs = dryrun_traces() if 31 in phases else None
        mesh_recs = mesh_traces() if 32 in phases else None
        rc, stdout, stderr = children["train"].finish(max(1.0, TR_TIMEOUT_S - (time.perf_counter() - t0)))
        check(rc is not None, f"the train child did not finish in {TR_TIMEOUT_S} s")
    except BaseException:  # a trace or a check failed: no child outlives this process
        for c in children.values():
            c.stop()
        raise
    sys.stderr.write(stderr)
    rows = []
    for line in stdout.splitlines():
        if line.startswith(TR_MARKER):
            rows.append(json.loads(line[len(TR_MARKER):]))
        elif line.strip():
            print(line, flush=True)
    check(rc == 0, f"the train child exited {rc}:\n{stderr[-3000:]}")
    check(len(rows) == 1, "the train child printed no report line")
    out = rows[0]
    check(out["phases"] == child, f"the train child ran phases {out['phases']}, not {child}")
    if recs is not None:
        out["dryrun"] = dryrun_phase(dev, card, out, recs)
    if mesh_recs is not None:
        out["sharded"] = run_sharded(card, mesh_recs, children["shard"])
    if 28 in phases:
        out["parent_gemm_ms"] = parent_gemm
        log(f"{TR_ARCH} train ({out['params']:,} parameters, {TR_BATCH} x {TR_SEQ} tokens a step, remat full, bf16): "
            f"{out['median_step_ms']:.1f} ms a step (median of {2 * TR_STEPS - 2}), {out['tokens_per_s']:,.0f} "
            f"tokens/s; losses {out['losses']} (falling), two runs bit-identical; grad_accum 2 "
            f"{out['accum2_ms']:.1f} ms; peak {out['peak_gb']['1']:.2f} GB (grad_accum 1), {out['peak_gb']['2']:.2f} "
            f"GB (2); device idle {out['device_idle_share']:.4f}; {card}")
        if TR_COSTS:
            log(f"{TR_ARCH} train, what determinism costs: a step with the deterministic algorithms off "
                f"{out['nondeterministic_step_ms']:.1f} ms against {out['median_step_ms']:.1f} ms on, "
                f"{out['filled_step_ms']:.1f} ms on with torch's NaN fill of new tensors; bf16 GEMM ms with "
                f"CUBLAS_WORKSPACE_CONFIG={TR_WORKSPACE} {json.dumps(out['gemm_ms'])}, without "
                f"{json.dumps(parent_gemm)}; {card}")
        log(f"{TR_ARCH} train step top device ops: " + json.dumps(out["device_top"]))
        log(f"phase 28, {TR_ARCH} train: {out['phase_s']:.1f} s in the child")
    if 29 in phases:
        gl = out["gridlocal"]
        log(f"{TR_ARCH} gridlocal ({gl['pods']} pods of {gl['tokens_a_pod']:,} tokens, {json.dumps(gl['outer'])}): "
            f"{gl['median_step_ms']:.1f} ms a global step (median of {len(gl['step_ms'])}: "
            f"{[round(x, 1) for x in gl['step_ms']]}), {[round(x, 1) for x in gl['merge_ms']]} ms a merge; losses "
            f"{gl['losses']} (falling), the pods equal after each merge; peak {gl['peak_gb']:.2f} GB; merge bytes "
            f"{json.dumps(gl['merge_bytes'])}; reduced f32 card vs CPU {json.dumps(gl['f32'])}; {card}")
        log(f"phase 29, {TR_ARCH} gridlocal: {gl['phase_s']:.1f} s in the child")
    if 30 in phases:
        log(f"phase 30, the train entry on a one-rank {out['entry']['backend']} mesh, resumed equals unbroken "
            f"equals plain steps ({out['entry']['files']} files): {out['entry']['phase_s']:.1f} s in the child; "
            f"{card}")
    if 33 in phases:
        for arch, r in out["archs"].items():
            peak = (f"{r['peak_rel_err']:+.4f} from the dry run's estimate" if "peak_rel_err" in r
                    else "no dry run of this cut")
            traced = (f"device idle {r['device_idle_share']:.4f}, {r['device_events']} device events a step"
                      if "device_events" in r else "not traced")
            log(f"{arch} train ({r['params']:,} parameters, {r['layers']} layers, {r['rows']} x {TR_SEQ} tokens a "
                f"step, remat full, bf16): {r['median_step_ms']:.1f} ms a step, {r['tokens_per_s']:,.0f} tokens/s; "
                f"two runs bit-identical, losses {r['losses']}; peak {r['peak_gb']:.2f} GB, {peak}; {traced}; the "
                f"reduced f32 step on the card holds to the CPU's; {r['phase_s']:.1f} s; {card}")
        log(f"phase 33, {', '.join(out['archs'])} train: {out['archs_phase_s']:.1f} s in the child; {card}")
    if 31 in phases:
        d = out["dryrun"]
        log(f"phase 31, {TR_ARCH} dry run against phase 28: peak within "
            f"{json.dumps({k: round(v['peak_rel_err'], 5) for k, v in d['grad_accum'].items()})} of the measured "
            f"(grad_accum 1, 2), mfu {d['grad_accum']['1']['mfu']:.4f}, hfu {d['grad_accum']['1']['hfu']:.4f}; "
            f"{d['phase_s']:.1f} s after the train child, the traces {d['grad_accum']['1']['trace_s']:.1f} + "
            f"{d['grad_accum']['2']['trace_s']:.1f} s while it ran; {card}")
    log(json.dumps({"train": {k: ({a: {x: y for x, y in r.items() if x != "device_top"} for a, r in v.items()}
                               if k == "archs" else v)
                           for k, v in out.items() if k not in ("device_top", "sharded")}, "card": card}))
    log(f"phases {', '.join(map(str, sorted(phases)))} (the train child and the dry run): "
        f"{time.perf_counter() - t0:.1f} s")
    return out


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
    card = card_line()
    log(f"card: {card}")
    props = torch.cuda.get_device_properties(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} sms {props.multi_processor_count}")
    t0 = time.perf_counter()
    built = {}

    def build():
        try:
            built["reports"] = _build.build_all()
        except BaseException as e:  # raised in this thread below
            built["error"] = e
        built["s"] = time.perf_counter() - t0

    nvcc = threading.Thread(target=build, name="nvcc", daemon=True)
    nvcc.start()  # the nvcc processes run while this thread draws the GFM data
    dense, sites = gfm_sites(dev)
    data_s = time.perf_counter() - t0
    nvcc.join()
    if "error" in built:
        raise built["error"]
    points = start_clustering_points()  # phases 2-5 run while it draws
    reports = built["reports"]
    log(f"build_s: {built['s']:.3f} ({', '.join(reports) or 'cached'})")
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

    log(f"data_s: {data_s:.3f} (while the kernels built) sites {[db.n_tx for db in sites]}")

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

    # F2: past 32 words (1,024 items) the count loops over 32-word groups.
    # W = 33, 35 and 64, masks of 1-3 items and two of more than 1,024
    # (rows of all ones give them counts), every wrapper and the transpose
    # held exactly; then every launch variant and word split of the
    # autotuner's full lattice at W = 35
    def wide_masks(s, c, w, big):
        out = masks_of(s, c, w)
        rng = np.random.default_rng(w)
        for j, n_items in enumerate(big):
            bits = np.zeros((s, 32 * w), dtype=np.uint32)
            for i in range(s):
                bits[i, rng.permutation(32 * w)[:n_items]] = 1
            words = (bits.reshape(s, w, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
            out[:, 2 + j] = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
        return out

    from repro_torch.kernels import autotune as at

    for s, n, c, w, big in [(1, 700, 37, 33, (1000,)), (2, 700, 40, 35, (1100, 1120)), (3, 3000, 60, 64, (1500, 2048)),
                            (2, 33, 9, 64, (2000,)), (3, 25_000, 18, 35, (1100,))]:
        mc = torch.tensor([1 + 150 * i for i in range(s)], dtype=torch.int32, device=dev)
        tx = words((s, n, w))
        tx[:, : min(n, 5)] = -1  # every item: the large masks count these rows
        tx[:, n - min(n, 2) :] = 0
        masks = wide_masks(s, c, w, big)
        hold(tx, masks, mc, f"S{s}-N{n}-C{c}-W{w}-items{max(big)}")
        check(bool((ref.support_count_sites_ref(tx, masks)[:, 2 : 2 + len(big)] >= min(n, 5) - 2).all()),
              f"W{w}: the large masks count none of the all-ones rows")
    tx = words((2, 3000, 35))
    tx[:, :5] = -1
    masks = wide_masks(2, 70, 35, (1100, 1024, 1025))
    want = ref.support_count_sites_ref(tx, masks)
    cands = at.support_count_candidates(2, 35, 3000, 70, smoke=False)
    for cfg in cands:
        got, _ = ops.count_with_config(tx, masks, None, cfg)
        check(torch.equal(got, want), f"W35: count variant {cfg} differs from the plain version")
    log(f"kernel check W35 autotuner lattice: {len(cands)} configs exact ({tuple(tx.shape)} x {tuple(masks.shape)})")

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
        p_ms = median_ms(pfn, reps=3, warmup=1)  # 5 until phase 33 needed the seconds
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
    # the same level-2 candidates over 1,120 and 2,048 items (W = 35, 64):
    # the words of the first 1,000 items as they are, the rest random
    # (density 0.01), timed on the wide path
    wide_rows = {"support_count": [], "support_count_prune": []}
    for w_wide in (35, 64):
        extra = (torch.rand((N_SITES, n_max, 32 * (w_wide - w) ), generator=gen) < 0.01).to(torch.int64)
        extra = (extra.reshape(N_SITES, n_max, w_wide - w, 32) << torch.arange(32)).sum(-1)
        tx_w = torch.cat([tx_l2, torch.where(extra >= 2**31, extra - 2**32, extra).to(torch.int32).to(dev)], dim=2)
        masks_w = torch.cat([masks_l2, torch.zeros((N_SITES, MAIN_C, w_wide - w), dtype=torch.int32, device=dev)],
                            dim=2)
        masks_w[:, -64:, -1] = 1 << 5  # a third item past the first 1,024 in the last 64 candidates
        label_w = f"level 2, C={MAIN_C}, W={w_wide}"
        hold(tx_w.contiguous(), masks_w.contiguous(), mc_sites, label_w)
        for name in ("support_count", "support_count_prune"):
            wide_rows[name].append(measure(name, tx_w.contiguous(), masks_w.contiguous(), mc_sites, label_w))
        del tx_w, masks_w, extra
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
    wall = WALLS["gfm"] = time.perf_counter() - t0
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
        TUNE_AT[f"GFM level {j + 2}"] = ("support_count_prune", tx, masks, mc)
    for tx, masks in calls["support_count_sites"]:
        label = "main path, recount"
        hold(tx, masks, mc_sites[: tx.shape[0]], label)
        rows["support_count"].append(measure("support_count", tx, masks, None, label))
        TUNE_AT["GFM recount"] = ("support_count", tx, masks, None)
    for name, wrapper in [("support_count", "support_count_sites"),
                          ("support_count_prune", "support_count_prune_sites")]:
        check(len(rows[name]) == main_launches[wrapper],
              f"{wrapper}: {len(rows[name])} recorded calls, {main_launches[wrapper]} launches on the main path")

    launches_by_path, itemset_refs = run_itemset_family(dev, card, ops, dense, sites, res, hold, measure, bound,
                                                        GridRuntime)
    launches_by_path = {"gfm": kernel_launches, **launches_by_path}

    kmeans_row, cluster_refs = run_clustering(dev, card, ops, ref, tkm, tvc, GridRuntime, points)
    kmeans_wide = cluster_refs.pop("wide_kernel")

    # what phase 22 holds the multi-host runs to: phases 3, 17 and 6
    single = {app: json.loads(json.dumps(d)) for app, d in [("gfm", want_digest), *itemset_refs.pop("grid").items()]}
    single["vclustering"] = cluster_refs["labels"][CL_PARAMS["seed"]]
    pooled, comp = cluster_refs.pop("points"), cluster_refs.pop("components")

    # ---- phase 21: the mining service on both paths' data ------------------
    service = run_service(dev, card, ops, ref, dense, pooled, {**itemset_refs, **cluster_refs}, hold, measure)
    del itemset_refs, cluster_refs
    launches_by_path["service"] = {k: service["launches"][k] for k in ("support_count", "support_count_prune")}
    kmeans_row["launches_by_path"]["service"] = service["launches"]["kmeans_assign"]
    kmeans_row["service"] = service["largest"]["kmeans_assign"]

    # ---- phase 23: the autotuner at the mining kernels' own launches -------
    tuned = run_autotune(dev, card, ops, ref, sites, want_digest, single["vclustering"])

    # ---- phase 22: multi-host execution, gloo ranks sharing the card -------
    multihost = run_multihost(card, dense, single)
    launches_by_path["multihost"] = {k: multihost[k] for k in ("support_count", "support_count_prune")}
    kmeans_row["launches_by_path"]["multihost"] = multihost["kmeans_assign"]

    # ---- phase 24: the per-site mesh, one gloo rank a site sharing the card -
    kmeans_row["launches_by_path"]["mesh"] = run_mesh(dev, card, pooled[:MESH_POINTS], comp[:MESH_POINTS])
    del pooled, comp

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
            "wide": wide_rows[name],
            **tuned[name],
        })
    kernels.append({**kmeans_row, **tuned["kmeans_assign"]})
    kernels.append(kmeans_wide)
    kernels.append(run_xlstm(dev, card, ops, ref))
    flash_row = run_gemma2(dev, card, ops, ref)
    flash_row["launches_by_path"] = {"gemma2-2b scoring": flash_row["launches"]}
    flash_row["models"] = {}
    # ---- phases 25 (the MoE archs), 26 (zamba2) and 27 (seamless and
    # phi-3-vision): the flash kernel at Dh 128, 64 and 96 inside whole
    # models, non-causal and at Sq != Skv in the encoder-decoder, and their
    # serving (seamless's prefill launches it too)
    children = None
    for arch in LM_RUNS:
        if arch == list(LM_RUNS)[-1]:  # the train and shard children import beside the last arch's phase
            children = start_train_children()
        t0 = time.perf_counter()
        lm = run_lm(dev, card, ops, ref, arch)
        log(f"phase {LM_PHASE[arch]}, {arch}: {time.perf_counter() - t0:.1f} s")
        flash_row["launches_by_path"][f"{arch} scoring"] = lm["launches"]
        if lm["prefill_launches"]:
            flash_row["launches_by_path"][f"{arch} prefill"] = lm["prefill_launches"]
        flash_row["models"][arch] = lm["row"]
    kernels.append(flash_row)
    # ---- phases 28-31: the synchronous train step, stablelm-1.6b at
    # published widths; GridLocal over two pods of it; the training entry;
    # the dry run of phase 28's cell against its measured step
    # ---- phase 32 (run_train, after the train child): the sharded step on
    # DTensors on a one-rank NCCL mesh, and the 16x16 dry run
    # ---- phase 33 (in the train child, after phase 30): gemma2-2b and
    # zamba2-1.2b trained at published widths
    sharded = run_train(dev, card, children=children)["sharded"]
    flash_row["launches_by_path"]["gemma2-2b sharded scoring (phase 32)"] = sharded["flash"]["launches"]
    xlstm_row = next(k for k in kernels if k["name"] == "slstm_scan")
    xlstm_row.setdefault("launches_by_path", {})["xlstm-1.3b sharded prefill (phase 32)"] = sharded["slstm"]["launches"]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    if "--multihost-child" in sys.argv[1:]:
        multihost_child(sys.argv[1:])
    elif "--mesh-child" in sys.argv[1:]:
        mesh_child(sys.argv[1:])
    elif "--train-child" in sys.argv[1:]:
        train_child(sys.argv[1:])
    elif "--shard-child" in sys.argv[1:]:
        shard_child(sys.argv[1:])
    else:
        main()
