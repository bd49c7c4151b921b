"""Deterministic launch-variant autotuner for the two CUDA mining kernels.

The support count (``csrc/support_count.cu``) and the K-Means assignment
(``csrc/kmeans_assign.cu``) ship with one launch each that is an educated
guess: a 256-thread count CTA whose warps take 4 words and 4 items at once,
with a heuristic word split; a 256-thread assignment CTA with 4 points a
thread at D = 8.  The right launch depends on the shape (sites, rows,
candidates, centres), the card and the build, none of which the call site
knows.  Each kernel is built in a few launch variants, and this module picks
among them:

  * a small **candidate lattice** per kernel: the compiled variants (and,
    for the count, a few forced word splits), filtered to the feasible ones:
    static shared memory within the 48 KB a static array may take and the
    227 KB a CTA may use (:func:`support_count_smem`,
    :func:`kmeans_assign_smem`), and on the card no variant whose build
    spills to local memory or fits no CTA on an SM;
  * each candidate is **timed** on the real inputs: on the card with CUDA
    events on the current stream, the median of ``repeats`` after
    ``warmup`` behind a spin kernel (as ``chip_smoke.median_ms`` times);
    on the CPU with the wall clock, the plain version splitting its work
    as the config says;
  * the winner is **memoized in-process** by ``(kernel, shape bucket,
    dtype, platform)`` (:func:`support_count_key`, :func:`kmeans_assign_key`);
  * the table is **persisted and loaded as JSON** (:func:`save_table`,
    :func:`load_table`), so a process reuses tuning instead of searching.

Determinism and safety: candidates come in a fixed order with the default
first, and the default stays the winner unless a candidate beats it by more
than ``MARGIN`` (2%), so a tuned config is never a noise artifact that loses
to the default.  No config changes a result: every variant and split gives
the same counts, flags, assignments and minimum distances, bit for bit.  A
candidate that fails to launch raises; it is not skipped.

A config is a tuple: ``(threads, u, i, split)`` for the count (the count
CTA's threads, the words and the items a lane takes at once, and the word
shares asked for, 0 for the heuristic), ``(threads, points)`` for the
assignment (the CTA's threads and the points a thread).

The ``ops`` wrappers consult this module when called with ``block="auto"``,
or with ``block=None`` once the mode is flipped (``ops.set_default_block``,
``REPRO_KERNEL_BLOCKS=auto``).  A call made while a CUDA graph is being
captured cannot time, so it gets the memoized winner when one exists and
the default otherwise: tune first, or load a table, to feed captured paths.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from collections.abc import Callable

import torch

from repro_torch.kernels import _build

# the count's compiled launch variants, (threads, u, i), in the order of
# csrc/support_count.cu's kCountVariants; the first is the default
SUPPORT_VARIANTS = (
    (256, 4, 4), (128, 4, 4), (512, 4, 4), (256, 2, 4), (256, 8, 4),
    (256, 4, 2), (256, 4, 8), (128, 8, 4), (512, 2, 4),
)
# the assignment's compiled launch variants, (threads, points), by its
# build's MAXD, in the order of csrc/kmeans_assign.cuh's Variants<MAXD>;
# wider D has its default alone
KMEANS_VARIANTS = {
    4: ((256, 8), (128, 8), (512, 8), (256, 4), (256, 16), (128, 16)),
    8: ((256, 4), (128, 4), (512, 4), (256, 2), (256, 8), (128, 8)),
    16: ((256, 2), (128, 2), (512, 2), (256, 1), (256, 4), (128, 4)),
    32: ((256, 1),),
    64: ((256, 1),),
    128: ((256, 1),),
}

# the launches the kernels shipped with: always searched, and kept unless a
# candidate is a real (beyond-noise) improvement
DEFAULT_SUPPORT_CONFIG = SUPPORT_VARIANTS[0] + (0,)
DEFAULT_KMEANS_CONFIG = {maxd: variants[0] for maxd, variants in KMEANS_VARIANTS.items()}

# shared memory: a static __shared__ array may take 48 KB, a CTA 227 KB
STATIC_SMEM_BYTES = 48 * 1024
CTA_SMEM_BYTES = 227 * 1024
KMEANS_TILE_FLOATS = 4096  # csrc/kmeans_assign.cuh's kTileFloats

# forced word splits of the count (0 is the heuristic)
_SPLITS = (0, 1, 2, 4, 8)
# the tiny lattice for CI and the CPU tests: the default and one
# alternative on each axis, so the search runs every time at little cost
_SMOKE_SUPPORT_VARIANTS = SUPPORT_VARIANTS[:2]
_SMOKE_SPLITS = (0, 2)
_SMOKE_KMEANS = (0, 1, 3)  # indices into KMEANS_VARIANTS[maxd]

MARGIN = 0.02  # a candidate must beat the default by > 2% to replace it

# card timing: the median of REPEATS after WARMUP, behind a spin kernel of
# SPIN_CYCLES (~10 ms at the H100's boost clock) that holds the card while
# the host enqueues them, so each event pair brackets one call's device work
CUDA_REPEATS, CUDA_WARMUP = 20, 3
CPU_REPEATS, CPU_WARMUP = 3, 1
SPIN_CYCLES = 20_000_000

_smoke_default = os.environ.get("REPRO_AUTOTUNE_SMOKE", "") not in ("", "0")

# in-process memo: key tuple -> entry dict (see _entry below)
_cache: dict[tuple, dict] = {}
_hits = 0
_misses = 0


def set_smoke(on: bool) -> bool:
    """Flip the module-wide tiny-lattice mode (returns the previous
    value).  Also settable via ``REPRO_AUTOTUNE_SMOKE=1``."""
    global _smoke_default
    prev = _smoke_default
    _smoke_default = bool(on)
    return prev


def clear_cache() -> None:
    """Drop every memoized winner (tests, fresh searches)."""
    global _hits, _misses
    _cache.clear()
    _hits = 0
    _misses = 0


def cache_stats() -> dict:
    """{'entries': n, 'hits': h, 'misses': m} for the in-process memo."""
    return {"entries": len(_cache), "hits": _hits, "misses": _misses}


_platforms: dict[tuple[torch.device, str], str] = {}


def platform(device: torch.device, kernel: str) -> str:
    """Where a timing was taken: ``"cpu+plain"`` for the plain versions on
    the CPU; ``"cuda:<device name>:<library hash>"`` on the card, the hash
    that names ``csrc/<kernel>.cu``'s build (``_build.source_hash``), so a
    tuned entry never outlives the kernel it tuned.  Read once per process,
    as the library is loaded once."""
    if device.type == "cpu":
        return "cpu+plain"
    name = _platforms.get((device, kernel))
    if name is None:
        name = _platforms[(device, kernel)] = (
            f"cuda:{torch.cuda.get_device_name(device)}:{_build.source_hash(kernel)}")
    return name


def capturing() -> bool:
    """True while a CUDA graph is being captured on the current stream:
    nothing may be timed, so the wrappers only look up."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _timeit(fn: Callable[[], object], device: torch.device, repeats: int | None = None,
            warmup: int | None = None) -> float:
    """Median seconds of one call of ``fn``.  On the card: CUDA events on
    the current stream around each call, the calls enqueued back to back
    behind a spin kernel (so the host's launch overhead is not timed), after
    ``warmup`` calls.  On the CPU: the wall clock (the warmup absorbs the
    first call's allocations; the median damps host noise)."""
    if device.type == "cuda":
        repeats = CUDA_REPEATS if repeats is None else repeats
        warmup = CUDA_WARMUP if warmup is None else warmup
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize(device)
        torch.cuda._sleep(SPIN_CYCLES)
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(repeats)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(repeats)]
        for a, b in zip(starts, ends):
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize(device)
        return statistics.median(a.elapsed_time(b) for a, b in zip(starts, ends)) / 1e3
    repeats = CPU_REPEATS if repeats is None else repeats
    warmup = CPU_WARMUP if warmup is None else warmup
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# ---------------------------------------------------------------------------
# Candidate lattices (shared-memory feasibility from the kernels' formulas)
# ---------------------------------------------------------------------------


def support_count_smem(threads: int) -> int:
    """Static shared memory of one count CTA: each warp's mask as a list of
    up to 32 × 32 items, 2 bytes each."""
    return threads // 32 * 32 * 32 * 2


def kmeans_assign_smem(maxd: int) -> int:
    """Static shared memory of one assignment CTA at its build's MAXD: a
    tile of ``KMEANS_TILE_FLOATS`` centre floats and one norm a centre of
    the tile, whatever the threads and points."""
    return 4 * (KMEANS_TILE_FLOATS + KMEANS_TILE_FLOATS // maxd)


def smem_fits(nbytes: int) -> bool:
    return nbytes <= min(STATIC_SMEM_BYTES, CTA_SMEM_BYTES)


def variant_fits(info: dict) -> bool:
    """A launch variant is a candidate on the card only if its build spills
    nothing to local memory and at least one CTA fits on an SM (``info``:
    ``ops.support_count_variant_info`` or ``ops.kmeans_assign_variant_info``)."""
    return info["local_bytes"] == 0 and info["ctas_per_sm"] > 0


def kmeans_maxd(d: int) -> int:
    """The register build of the assignment kernel that runs at D
    (csrc/kmeans_assign.cuh), and the widest, 128, past it: there
    ``wide_kernel`` runs, whose one launch (256 threads, one point a
    thread) is that build's default, (256, 1).  Past D = 128 the autotuner
    therefore has one candidate and leaves the launch at its default."""
    return next((m for m in KMEANS_VARIANTS if d <= m), max(KMEANS_VARIANTS))


def kmeans_wide_smem() -> int:
    """Static shared memory of one ``wide_kernel`` CTA (D > 128): its 256
    points' and 32 centres' chunks of 32 floats, rows padded to 33, and 32
    norms."""
    return 4 * ((256 + 32) * 33 + 32)


def kmeans_default_config(d: int) -> tuple[int, int]:
    return DEFAULT_KMEANS_CONFIG[kmeans_maxd(d)]


def max_count_shares(n: int) -> int:
    """Most word shares the count can take over N rows: one word a lane."""
    return max(1, -(-(-(-n // 32)) // 32))


def _smoke(smoke: bool | None) -> bool:
    return _smoke_default if smoke is None else smoke


def support_count_candidates(s: int, w: int, n: int, c: int, smoke: bool | None = None) -> list[tuple]:
    """Deterministically ordered count configs for one shape: the default
    first, then each variant with each split, in the lattice's order, where
    the variant's shared memory fits and a forced split does not exceed
    :func:`max_count_shares`."""
    variants = _SMOKE_SUPPORT_VARIANTS if _smoke(smoke) else SUPPORT_VARIANTS
    splits = _SMOKE_SPLITS if _smoke(smoke) else _SPLITS
    out = [DEFAULT_SUPPORT_CONFIG]
    for variant in variants:
        for split in splits:
            cfg = variant + (split,)
            if cfg in out or split > max_count_shares(n) or not smem_fits(support_count_smem(variant[0])):
                continue
            out.append(cfg)
    return out


def kmeans_assign_candidates(s: int, n: int, k: int, d: int, smoke: bool | None = None) -> list[tuple]:
    """Deterministically ordered assignment configs for one shape: the
    default first, then the other variants of D's build; past D = 128 the
    default alone (``wide_kernel``'s one launch)."""
    if d > max(KMEANS_VARIANTS):
        return [kmeans_default_config(d)]
    maxd = kmeans_maxd(d)
    variants = KMEANS_VARIANTS[maxd]
    if _smoke(smoke):
        variants = tuple(variants[i] for i in _SMOKE_KMEANS if i < len(variants))
    return [v for v in variants if smem_fits(kmeans_assign_smem(maxd))]


# ---------------------------------------------------------------------------
# Keys and the search itself
# ---------------------------------------------------------------------------


def bucket(x: int) -> int:
    """``x`` rounded up to three significant bits: the next multiple of
    2^(bit_length(x - 1) - 3), and x itself up to 8.  Shapes within one
    bucket are within 25% of each other and share one search."""
    x = max(int(x), 1)
    step = 1 << max(0, (x - 1).bit_length() - 3)
    return -(-x // step) * step


def support_count_key(s: int, w: int, n: int, c: int, dtype, platform_: str) -> tuple:
    """Memo key of a count launch (site form; a single-DB launch has S = 1):
    ``("support_count", (S, W, bucket(N), bucket(C)), dtype, platform)``.
    S and W stay exact: the grid spans the sites, and W sets the mask
    words a warp reads."""
    return ("support_count", (int(s), int(w), bucket(n), bucket(c)), str(dtype), platform_)


def kmeans_assign_key(s: int, n: int, k: int, d: int, dtype, platform_: str) -> tuple:
    """Memo key of an assignment launch: ``("kmeans_assign", (S,
    bucket(N), K, D), dtype, platform)``; S, K and D stay exact."""
    return ("kmeans_assign", (int(s), bucket(n), int(k), int(d)), str(dtype), platform_)


def _entry(kernel: str, key: tuple, default, config, timings: dict) -> dict:
    """One tuned-table entry.  ``config`` is the winner; ``timings`` maps
    the stringified config to its median seconds (default included)."""
    return {
        "kernel": kernel,
        "shape": list(key[1]),
        "dtype": key[2],
        "platform": key[3],
        "config": list(config),
        "config_default": list(default),
        "seconds_tuned": timings[str(tuple(config))],
        "seconds_default": timings[str(tuple(default))],
        "timings": timings,
    }


def _pick(timed: list[tuple[object, float]]) -> object:
    """The winner of one search: the fastest config, except the default
    (always ``timed[0]``) is kept unless a candidate beats it by more
    than ``MARGIN``: ties and noise never dethrone the default."""
    default_cfg, default_t = timed[0]
    best_cfg, best_t = min(timed, key=lambda ct: ct[1])
    if best_t >= default_t * (1.0 - MARGIN):
        return default_cfg
    return best_cfg


def lookup(key: tuple):
    """The memoized winner for ``key`` or None: the only autotune entry
    point legal during a CUDA graph capture (no timing, just the table)."""
    ent = _cache.get(key)
    return None if ent is None else _config_of(ent)


def _config_of(ent: dict) -> tuple:
    return tuple(ent["config"])


def _search(kernel: str, key: tuple, candidates: Callable[[], list[tuple]], run: Callable[[tuple], object],
            device: torch.device) -> dict:
    """The memoized entry for ``key``; on a miss, every config of
    ``candidates()`` timed by ``run(config)`` on ``device`` (the first is
    the default), the winner picked and memoized."""
    global _hits, _misses
    if key in _cache:
        _hits += 1
        return _cache[key]
    _misses += 1
    timings: dict[str, float] = {}
    timed = []
    configs = candidates()
    for cfg in configs:
        t = _timeit(lambda cfg=cfg: run(cfg), device)
        timings[str(cfg)] = t
        timed.append((cfg, t))
    ent = _entry(kernel, key, configs[0], _pick(timed), timings)
    _cache[key] = ent
    return ent


def tune_support_count(tx: torch.Tensor, masks: torch.Tensor, smoke: bool | None = None) -> dict:
    """Search the count's launch config for this shape: tx (S, N, W) and
    masks (S, C, W) int32, all sizes >= 1, on the CPU or one card.  Returns
    the tuned-table entry (``entry['config']`` is the winner).  Memoized:
    a second call with a shape of the same key is a cache hit and runs
    nothing.  The count and the count with thresholds share one search:
    their launches differ only in the flags they write."""
    from repro_torch.kernels import ops

    s, n, w = tx.shape
    c = masks.shape[1]
    key = support_count_key(s, w, n, c, tx.dtype, platform(tx.device, "support_count"))

    def candidates() -> list[tuple]:
        out = support_count_candidates(s, w, n, c, smoke=smoke)
        if tx.device.type == "cuda":
            out = [cfg for cfg in out if cfg == DEFAULT_SUPPORT_CONFIG
                   or variant_fits(ops.support_count_variant_info(SUPPORT_VARIANTS.index(cfg[:3]), tx.device))]
        return out

    return _search("support_count", key, candidates, lambda cfg: ops.count_with_config(tx, masks, None, cfg),
                   tx.device)


def tune_kmeans_assign(xs: torch.Tensor, centers: torch.Tensor, smoke: bool | None = None) -> dict:
    """Search the assignment's launch config for this shape: xs (S, N, D)
    and centers (S, K, D) float32, N >= 1, on the CPU or one card.
    Returns the tuned-table entry; memoized like :func:`tune_support_count`."""
    from repro_torch.kernels import ops

    s, n, d = xs.shape
    k = centers.shape[1]
    key = kmeans_assign_key(s, n, k, d, xs.dtype, platform(xs.device, "kmeans_assign"))

    def candidates() -> list[tuple]:
        out = kmeans_assign_candidates(s, n, k, d, smoke=smoke)
        if xs.device.type == "cuda":
            variants = KMEANS_VARIANTS[kmeans_maxd(d)]
            out = [cfg for cfg in out if cfg == variants[0]
                   or variant_fits(ops.kmeans_assign_variant_info(variants.index(cfg), d, xs.device))]
        return out

    return _search("kmeans_assign", key, candidates, lambda cfg: ops.assign_with_config(xs, centers, cfg),
                   xs.device)


# ---------------------------------------------------------------------------
# Persisted tuned tables (JSON)
# ---------------------------------------------------------------------------


def _key_of(ent: dict) -> tuple:
    return (ent["kernel"], tuple(ent["shape"]), ent["dtype"], ent["platform"])


def save_table(path: str) -> int:
    """Write every memoized entry as a JSON tuned table; returns the entry
    count.  Load it at process start and every covered shape skips its
    search."""
    entries = [_cache[k] for k in sorted(_cache)]
    with open(path, "w") as fh:
        json.dump({"version": 1, "entries": entries}, fh, indent=2, sort_keys=True)
    return len(entries)


def load_table(path: str, replace: bool = False) -> int:
    """Merge (or, with ``replace=True``, reset to) a persisted tuned
    table; returns the number of entries loaded.  Entries round-trip
    exactly: ``save_table`` then ``load_table`` reproduces the memo."""
    with open(path) as fh:
        data = json.load(fh)
    if data.get("version") != 1:
        raise ValueError(f"{path}: tuned table version {data.get('version')!r}, want 1")
    if replace:
        clear_cache()
    n = 0
    for ent in data.get("entries", []):
        _cache[_key_of(ent)] = ent
        n += 1
    return n
