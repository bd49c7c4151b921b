"""Wrappers around the hand-written kernels: support counting, the
K-Means assignment, the sLSTM scan and flash attention.

Callers pass natural shapes: packed transactions ``(N, W)`` or
``(S, N, W)`` and candidate masks ``(C, W)`` or ``(S, C, W)``, as int32 bit
views of the uint32 words; points ``(N, D)`` or ``(S, N, D)`` and centres
``(K, D)`` or ``(S, K, D)``; sLSTM input projections ``(B, S, H, 4P)``;
attention q ``(B, Sq, H, Dh)`` and k/v ``(B, Skv, Kv, Dh)``.  A tensor on
the CPU goes to the plain version in ``ref``; a CUDA tensor goes to the
CUDA kernel (``csrc/support_count.cu``, ``csrc/kmeans_assign.cu``,
``csrc/slstm_scan.cu``; for attention ``csrc/flash_attention_wgmma.cu`` in
bfloat16 and ``csrc/flash_attention.cu`` in float32), or the wrapper
raises.  The kernels pick their own tiles.  Zero candidates, transactions
or points return empty or zero results without a launch.

Flash attention replaces the TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py:84``).  Operations bound it: at
gemma2-2b's full layer (B 4, S 8,192, H 8, Kv 4, Dh 256, causal) its
1.10e12 flop take 1.11 ms at the 989 TFLOP/s bf16 tensor-core peak.  The
bfloat16 kernel therefore runs both products on the tensor cores (wgmma,
operands brought by TMA, a producer warpgroup and two consumers); a
product of two bf16 values is exact in f32, so it keeps the plain
version's f32 scores.  Float32 stays on the CUDA cores' f32 FMA: on the
tensor cores it would be TF32, another function.

``LAUNCHES`` counts, per wrapper, the calls that launched the CUDA kernel,
so a run can show that its counting went through the kernel;
``flash_attention`` counts every flash launch and ``flash_attention_wgmma``
the tensor-core ones among them.

Launch-config seam: the six mining wrappers (``support_count``,
``support_count_prune``, their ``_sites`` forms, ``kmeans_assign`` and
``kmeans_assign_sites``) take ``block=`` —

  * ``None`` (the default): the module's mode, :func:`default_block` —
    ``"default"`` (today's launch) unless flipped to ``"auto"`` by
    :func:`set_default_block` or ``REPRO_KERNEL_BLOCKS=auto``;
  * ``"default"``: the launch the kernels shipped with;
  * ``"auto"``: ask :mod:`repro_torch.kernels.autotune` for the memoized
    winner of this shape, searching (and memoizing) on first sight; while a
    CUDA graph is being captured, the memoized winner or the default;
  * an explicit config, ``(threads, u, i, split)`` for the count and
    ``(threads, points)`` for the assignment (``autotune``'s lattices).

A site form resolves one config for its whole launch.  No config changes a
result, so the seam changes speed and nothing else; with ``block=None`` in
the default mode every wrapper launches exactly the kernel it launched
before the seam.  ``LAST_CONFIG`` holds, per wrapper, the config its last
launch ran with (on the CPU, the config its plain version split its work by).
"""

from __future__ import annotations

import ctypes
import math
import os
from collections.abc import Sequence

import torch

from repro_torch.kernels import _build, autotune, ref
from repro_torch.sharding import local_heads

LAUNCHES: dict[str, int] = {
    "support_count": 0,
    "support_count_prune": 0,
    "support_count_sites": 0,
    "support_count_prune_sites": 0,
    "kmeans_assign": 0,
    "kmeans_assign_sites": 0,
    "slstm_scan": 0,
    "flash_attention": 0,
    "flash_attention_wgmma": 0,
}


MINING_WRAPPERS = (
    "support_count", "support_count_prune", "support_count_sites", "support_count_prune_sites",
    "kmeans_assign", "kmeans_assign_sites",
)
LAST_CONFIG: dict[str, tuple | None] = dict.fromkeys(MINING_WRAPPERS)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_BLOCK_MODE = "auto" if os.environ.get("REPRO_KERNEL_BLOCKS", "default") == "auto" else "default"


def set_default_block(mode: str) -> str:
    """Flip the module-wide block mode (``"default"`` | ``"auto"``);
    returns the previous mode.  ``"auto"`` makes every mining wrapper
    called with ``block=None`` consult the autotuner."""
    global _BLOCK_MODE
    if mode not in ("default", "auto"):
        raise ValueError(f"unknown block mode {mode!r} (want 'default' or 'auto')")
    prev = _BLOCK_MODE
    _BLOCK_MODE = mode
    return prev


def default_block() -> str:
    """The current module-wide block mode."""
    return _BLOCK_MODE


def _auto(block) -> bool:
    """Whether ``block`` asks the autotuner (else the default or an explicit config)."""
    if block is None:
        return _BLOCK_MODE == "auto"
    if isinstance(block, str) and block not in ("auto", "default"):
        raise ValueError(f"unknown block {block!r} (want None, 'default', 'auto' or a config)")
    return block == "auto"


def _support_config(tx: torch.Tensor, masks: torch.Tensor, block) -> tuple:
    """The config of one count launch over tx (S, N, W), masks (S, C, W),
    every size >= 1: an explicit config as given, then the autotuner when
    auto is asked (lookup only during a graph capture), else the default."""
    if block is not None and not isinstance(block, str):
        cfg = tuple(int(v) for v in block)
        if len(cfg) != 4 or cfg[:3] not in autotune.SUPPORT_VARIANTS or cfg[3] < 0:
            raise ValueError(f"a support-count config is (threads, u, i, split) with (threads, u, i) one of "
                             f"{autotune.SUPPORT_VARIANTS} and split >= 0, got {block!r}")
        return cfg
    if not _auto(block):
        return autotune.DEFAULT_SUPPORT_CONFIG
    if autotune.capturing():
        s, n, w = tx.shape
        platform = autotune.platform(tx.device, "support_count")
        key = autotune.support_count_key(s, w, n, masks.shape[1], tx.dtype, platform)
        return autotune.lookup(key) or autotune.DEFAULT_SUPPORT_CONFIG
    return tuple(autotune.tune_support_count(tx, masks)["config"])


def _kmeans_config(xs: torch.Tensor, centers_s: torch.Tensor, block) -> tuple:
    """The config of one assignment launch over xs (S, N, D), centers
    (S, K, D), S and N >= 1; resolved as :func:`_support_config`."""
    d = xs.shape[2]
    variants = autotune.KMEANS_VARIANTS[autotune.kmeans_maxd(d)]
    if block is not None and not isinstance(block, str):
        cfg = tuple(int(v) for v in block)
        if cfg not in variants:
            raise ValueError(f"a K-Means config at D={d} is (threads, points), one of {variants}, got {block!r}")
        return cfg
    if not _auto(block):
        return variants[0]
    if autotune.capturing():
        s, n, _ = xs.shape
        key = autotune.kmeans_assign_key(s, n, centers_s.shape[1], d, xs.dtype,
                                         autotune.platform(xs.device, "kmeans_assign"))
        return autotune.lookup(key) or variants[0]
    return tuple(autotune.tune_kmeans_assign(xs, centers_s)["config"])


_ENTRY: dict = {}
_KMEANS_ENTRY: dict = {}
_KMEANS_FLOOR_ENTRY = None
_SLSTM_ENTRY: dict = {}
_FLASH_ENTRY: dict = {}
_FLASH_WGMMA_ENTRY = None

# the K-Means kernel's limits (csrc/kmeans_assign.cu); the wrapper raises past
# them.  Any D >= 1: the register builds take D <= 128, wide_kernel wider D
KMEANS_MAX_REGISTER_D = 128
KMEANS_MAX_K = 65_536
KMEANS_MAX_S = 65_535
# the support count's limit (csrc/support_count.cu): W in groups of 32
# words, at most 65,535 groups (the transpose grid's z axis)
SUPPORT_MAX_W = 32 * 65_535


def _entry(name: str = "support_count_sites_launch"):
    """A C entry point of ``csrc/support_count.cu``: both stages
    (``support_count_sites_launch``, the path's default launch, and
    ``support_count_sites_variant_launch``), one of them
    (``support_count_transpose_launch``, ``support_count_vertical_launch``),
    or a count variant's attributes (``support_count_variant_info``)."""
    fn = _ENTRY.get(name)
    if fn is None:
        fn = getattr(_build.load("support_count"), name)
        fn.argtypes = {
            "support_count_sites_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
            "support_count_sites_variant_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
            "support_count_transpose_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            "support_count_vertical_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
            "support_count_variant_info": [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 7,
        }[name]
        fn.restype = ctypes.c_int
        _ENTRY[name] = fn
    return fn


def _refuse_dtensor(name: str, *ts) -> None:
    """A DTensor is a wrapper whose ``data_ptr()`` is no shard's: a kernel
    must get each rank's local tensors (``flash_attention_sharded``, or
    ``sharding.local_by_roles`` as the sLSTM layer calls ``slstm_scan``)."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError(f"{name} takes plain tensors, got a DTensor: run it on each rank's local shards "
                        f"(flash_attention_sharded, sharding.local_by_roles)")


def _on_cpu(*ts: torch.Tensor) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"the kernels need all tensors on the CPU or on one CUDA device, got {kinds}")


def _check_sites(tx: torch.Tensor, masks: torch.Tensor) -> None:
    if tx.dim() != 3 or masks.dim() != 3:
        raise ValueError(f"want tx (S, N, W) and masks (S, C, W), got {tuple(tx.shape)}, {tuple(masks.shape)}")
    if tx.shape[0] != masks.shape[0] or tx.shape[2] != masks.shape[2]:
        raise ValueError(f"shape mismatch: tx {tuple(tx.shape)} vs masks {tuple(masks.shape)}")
    for name, t in (("tx", tx), ("masks", masks)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (a bit view of the packed uint32 words), got {t.dtype}")


def _vt_shape(s: int, n: int, w: int) -> tuple[int, int, int]:
    """The vertical bitmap's shape: (S, 32·W, ceil(N/32))."""
    return (s, 32 * w, -(-n // 32))


def _launch(tx: torch.Tensor, masks: torch.Tensor, min_counts: torch.Tensor | None, config: tuple | None = None):
    """Both stages of the CUDA count over the site axis, one call: the
    transpose into a vertical bitmap from PyTorch's caching allocator, then
    the count, as launch ``config`` (None or the default: the default
    launch, through ``support_count_sites_launch``).  Returns (counts,
    flags|None)."""
    s, n, w = tx.shape
    c = masks.shape[1]
    check_support_kernel_limits(w)
    for name, t in (("tx", tx), ("masks", masks), ("min_counts", min_counts)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    counts = torch.empty((s, c), dtype=torch.int32, device=tx.device)
    flags = None if min_counts is None else torch.empty((s, c), dtype=torch.bool, device=tx.device)
    vt = torch.empty(_vt_shape(s, n, w), dtype=torch.int32, device=tx.device)
    args = (tx.data_ptr(), masks.data_ptr(), None if min_counts is None else min_counts.data_ptr(),
            counts.data_ptr(), None if flags is None else flags.data_ptr(), vt.data_ptr(), s, n, c, w, tx.device.index)
    with torch.cuda.device(tx.device):
        stream = torch.cuda.current_stream(tx.device).cuda_stream
        if config is None or config == autotune.DEFAULT_SUPPORT_CONFIG:
            err = _entry()(*args, stream)
        else:
            variant = autotune.SUPPORT_VARIANTS.index(tuple(config[:3]))
            err = _entry("support_count_sites_variant_launch")(*args, variant, config[3], stream)
    if err != 0:
        raise RuntimeError(f"support_count kernel launch failed (config {config}): CUDA error {err}")
    return counts, flags


def check_support_kernel_limits(w: int) -> None:
    """Raise past the CUDA count's limit: W <= 32 * 65,535 words (65,535
    groups of 32 words, the transpose grid's z axis)."""
    if w > SUPPORT_MAX_W:
        raise ValueError(f"the CUDA support_count kernel takes W <= {SUPPORT_MAX_W} words "
                         f"(65,535 groups of 32), got W={w}")


def count_with_config(
    tx: torch.Tensor, masks: torch.Tensor, min_counts: torch.Tensor | None, config: tuple
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One count over tx (S, N, W), masks (S, C, W) (every size >= 1) with
    launch ``config``: the CUDA kernel for CUDA tensors, the plain version
    splitting its work as the config says for CPU tensors.  (counts,
    flags or None); counts no launch in ``LAUNCHES`` (the autotuner times it)."""
    if _on_cpu(tx, masks):
        counts = ref.support_count_sites_ref(tx, masks, config=config)
        return counts, None if min_counts is None else counts >= min_counts.to(torch.int32)[:, None]
    return _launch(tx, masks, min_counts, config)


def support_count_variant_info(variant: int, device: torch.device | None = None) -> dict:
    """Count variant ``variant`` (an index into ``autotune.SUPPORT_VARIANTS``)
    on ``device`` (the current card if None): threads, u, i, and its
    build's static shared memory, local memory (spills) and registers a
    thread, and its resident CTAs an SM.  Needs the card."""
    out = [ctypes.c_int(0) for _ in range(7)]
    with torch.cuda.device(torch.cuda.current_device() if device is None else device):
        err = _entry("support_count_variant_info")(variant, *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"support_count_variant_info({variant}) failed: CUDA error {err}")
    return dict(zip(("threads", "u", "i", "shared_bytes", "local_bytes", "registers", "ctas_per_sm"),
                    (v.value for v in out)))


def vertical_bitmap(tx_packed_s: torch.Tensor) -> torch.Tensor:
    """The support count's first stage alone, for checks and timing: tx
    (S, N, W) int32 -> vt (S, 32·W, ceil(N/32)) int32, the semantics of
    ``ref.vertical_bitmap_ref``.  On the card it launches the transpose
    kernel (S, N >= 1, contiguous); counts no launch in ``LAUNCHES``."""
    _check_sites(tx_packed_s, tx_packed_s[:, :0])
    if _on_cpu(tx_packed_s):
        return ref.vertical_bitmap_ref(tx_packed_s)
    s, n, w = tx_packed_s.shape
    check_support_kernel_limits(w)
    if s == 0 or n == 0 or not tx_packed_s.is_contiguous():
        raise ValueError(f"the transpose kernel takes contiguous (S, N, W) with S, N >= 1, "
                         f"got {tuple(tx_packed_s.shape)}")
    vt = torch.empty(_vt_shape(s, n, w), dtype=torch.int32, device=tx_packed_s.device)
    with torch.cuda.device(tx_packed_s.device):
        err = _entry("support_count_transpose_launch")(
            tx_packed_s.data_ptr(), vt.data_ptr(), s, n, w, torch.cuda.current_stream(tx_packed_s.device).cuda_stream
        )
    if err != 0:
        raise RuntimeError(f"support_count transpose launch failed: CUDA error {err}")
    return vt


def support_count_vertical_sites(
    vt: torch.Tensor, masks_s: torch.Tensor, n: int, min_counts: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The support count's second stage alone, for checks and timing: vt
    from :func:`vertical_bitmap` of a tx with ``n`` rows, masks (S, C, W)
    int32, optional per-site thresholds (S,) int32 -> (counts (S, C) int32,
    flags (S, C) bool or None), the semantics of
    ``ref.support_count_vertical_sites_ref``.  On the card it launches the
    count kernel (S, n, C >= 1, contiguous); counts no launch in ``LAUNCHES``."""
    _check_sites(masks_s[:, :0], masks_s)
    s, c, w = masks_s.shape
    if tuple(vt.shape) != _vt_shape(s, n, w) or vt.dtype != torch.int32:
        raise ValueError(f"want vt int32 of shape {_vt_shape(s, n, w)}, got {vt.dtype} {tuple(vt.shape)}")
    if _on_cpu(vt, masks_s):
        counts = ref.support_count_vertical_sites_ref(vt, masks_s, n)
        return counts, None if min_counts is None else counts >= min_counts.to(torch.int32)[:, None]
    check_support_kernel_limits(w)
    if s == 0 or n == 0 or c == 0 or not (vt.is_contiguous() and masks_s.is_contiguous()):
        raise ValueError(f"the count kernel takes contiguous operands with S, N, C >= 1, "
                         f"got masks {tuple(masks_s.shape)}, n={n}")
    counts = torch.empty((s, c), dtype=torch.int32, device=vt.device)
    flags = None
    if min_counts is not None:
        min_counts = min_counts.to(torch.int32).contiguous()
        flags = torch.empty((s, c), dtype=torch.bool, device=vt.device)
    with torch.cuda.device(vt.device):
        err = _entry("support_count_vertical_launch")(
            vt.data_ptr(), masks_s.data_ptr(), None if min_counts is None else min_counts.data_ptr(),
            counts.data_ptr(), None if flags is None else flags.data_ptr(), s, n, c, w, vt.device.index,
            torch.cuda.current_stream(vt.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"support_count count launch failed: CUDA error {err}")
    return counts, flags


def _count(name: str, tx: torch.Tensor, masks: torch.Tensor, min_counts: torch.Tensor | None, block):
    """The count of wrapper ``name`` in site form, on checked operands:
    (counts, flags or None).  Zero sites, rows or candidates return zeros
    without a launch; otherwise the config is resolved once for the whole
    launch, recorded in ``LAST_CONFIG``, and run: the plain version on the
    CPU, the CUDA kernel (counted in ``LAUNCHES``) on the card."""
    s, n, _ = tx.shape
    c = masks.shape[1]
    cpu = _on_cpu(tx, masks)
    if 0 in (s, n, c):
        if cpu:
            counts = ref.support_count_sites_ref(tx, masks)
        else:
            counts = torch.zeros((s, c), dtype=torch.int32, device=tx.device)
        return counts, None if min_counts is None else counts >= min_counts[:, None]
    config = _support_config(tx, masks, block)
    LAST_CONFIG[name] = config
    if cpu:
        return count_with_config(tx, masks, min_counts, config)
    out = _launch(tx, masks, None if min_counts is None else min_counts.contiguous(), config)
    LAUNCHES[name] += 1
    return out


def support_count_sites(tx_packed_s: torch.Tensor, masks_s: torch.Tensor, block=None) -> torch.Tensor:
    """Site-axis support counts in ONE launch: tx (S, N, W), masks
    (S, C, W) -> (S, C) int32, each site counted against its own masks.
    ``block``: the launch config (module docstring)."""
    _check_sites(tx_packed_s, masks_s)
    return _count("support_count_sites", tx_packed_s, masks_s, None, block)[0]


def support_count_prune_sites(
    tx_packed_s: torch.Tensor,
    masks_s: torch.Tensor,
    min_counts: torch.Tensor | Sequence[int],
    block=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Site-axis count + threshold in ONE launch with PER-SITE thresholds:
    min_counts (S,) -> (counts (S, C) int32, frequent (S, C) bool) with
    ``frequent == counts >= min_counts[:, None]`` exactly.  ``block``: the
    launch config, shared with :func:`support_count_sites`."""
    _check_sites(tx_packed_s, masks_s)
    mc = torch.as_tensor(min_counts, dtype=torch.int32, device=tx_packed_s.device)
    if mc.shape != (tx_packed_s.shape[0],):
        raise ValueError(f"want one threshold per site, got min_counts of shape {tuple(mc.shape)}")
    return _count("support_count_prune_sites", tx_packed_s, masks_s, mc, block)


def support_count(tx_packed: torch.Tensor, masks: torch.Tensor, block=None) -> torch.Tensor:
    """Support counts: tx (N, W), masks (C, W) -> (C,) int32; the site form
    at S = 1 (its config is that shape's)."""
    if tx_packed.dim() != 2 or masks.dim() != 2:
        raise ValueError(f"want tx (N, W) and masks (C, W), got {tuple(tx_packed.shape)}, {tuple(masks.shape)}")
    _check_sites(tx_packed[None], masks[None])
    return _count("support_count", tx_packed[None], masks[None], None, block)[0][0]


def support_count_prune(
    tx_packed: torch.Tensor, masks: torch.Tensor, min_count: int, block=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused count + threshold: ``(counts (C,) int32, frequent (C,) bool)``
    with ``frequent == counts >= min_count`` exactly."""
    if tx_packed.dim() != 2 or masks.dim() != 2:
        raise ValueError(f"want tx (N, W) and masks (C, W), got {tuple(tx_packed.shape)}, {tuple(masks.shape)}")
    _check_sites(tx_packed[None], masks[None])
    mc = torch.tensor([int(min_count)], dtype=torch.int32, device=tx_packed.device)
    counts, flags = _count("support_count_prune", tx_packed[None], masks[None], mc, block)
    return counts[0], flags[0]


# ---------------------------------------------------------------------------
# K-Means assignment
# ---------------------------------------------------------------------------


def _kmeans_entry(name: str = "kmeans_assign_sites_launch"):
    """A C entry point of ``csrc/kmeans_assign.cu``: the default launch
    (``kmeans_assign_sites_launch``, the path's), a launch variant
    (``kmeans_assign_variant_launch``) or a variant's attributes
    (``kmeans_assign_variant_info``)."""
    fn = _KMEANS_ENTRY.get(name)
    if fn is None:
        fn = getattr(_build.load("kmeans_assign"), name)
        fn.argtypes = {
            "kmeans_assign_sites_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
            "kmeans_assign_variant_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
            "kmeans_assign_variant_info": [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 7,
        }[name]
        fn.restype = ctypes.c_int
        _KMEANS_ENTRY[name] = fn
    return fn


def kmeans_assign_variant_info(variant: int, d: int, device: torch.device | None = None) -> dict:
    """Launch variant ``variant`` (an index into ``autotune.KMEANS_VARIANTS``
    of D's build) at D on ``device`` (the current card if None): the
    variants at D, threads, points, and its build's static shared memory,
    local memory (spills) and registers a thread, and its resident CTAs an
    SM.  Needs the card."""
    out = [ctypes.c_int(0) for _ in range(7)]
    with torch.cuda.device(torch.cuda.current_device() if device is None else device):
        err = _kmeans_entry("kmeans_assign_variant_info")(variant, d, *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"kmeans_assign_variant_info({variant}, {d}) failed: CUDA error {err}")
    return dict(zip(("variants", "threads", "points", "shared_bytes", "local_bytes", "registers", "ctas_per_sm"),
                    (v.value for v in out)))


def check_kmeans_kernel_limits(s: int, k: int, d: int) -> None:
    """Raise past the CUDA kernel's limits: K <= 65,536 and S <= 65,535
    (the grid's y axis).  Any D >= 1 runs: D <= 128 in the register
    builds, wider D in ``wide_kernel``."""
    if k > KMEANS_MAX_K:
        raise ValueError(f"the CUDA kmeans_assign kernel takes K <= {KMEANS_MAX_K}, got K={k}")
    if s > KMEANS_MAX_S:
        raise ValueError(f"the CUDA kmeans_assign kernel takes S <= {KMEANS_MAX_S}, got S={s}")


def _kmeans_operands(xs: torch.Tensor, centers_s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if xs.dim() != 3 or centers_s.dim() != 3:
        raise ValueError(
            f"want xs (S, N, D) and centers (S, K, D), got {tuple(xs.shape)}, {tuple(centers_s.shape)}"
        )
    if xs.shape[0] != centers_s.shape[0] or xs.shape[2] != centers_s.shape[2]:
        raise ValueError(f"shape mismatch: xs {tuple(xs.shape)} vs centers {tuple(centers_s.shape)}")
    if xs.shape[2] < 1 or centers_s.shape[1] < 1:
        raise ValueError(f"want D >= 1 and K >= 1, got D={xs.shape[2]}, K={centers_s.shape[1]}")
    for name, t in (("xs", xs), ("centers", centers_s)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    return xs.to(torch.float32), centers_s.to(torch.float32)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernel reads rows as float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kmeans_run(xs: torch.Tensor, centers_s: torch.Tensor, config: tuple):
    """One CUDA launch over the site axis as launch ``config`` (the default:
    through ``kmeans_assign_sites_launch``), on checked operands with S and
    N >= 1; counts no launch."""
    s, n, d = xs.shape
    k = centers_s.shape[1]
    assign = torch.empty((s, n), dtype=torch.int32, device=xs.device)
    mind2 = torch.empty((s, n), dtype=torch.float32, device=xs.device)
    xs, centers_s = _aligned(xs), _aligned(centers_s)
    args = (xs.data_ptr(), centers_s.data_ptr(), assign.data_ptr(), mind2.data_ptr(), s, n, k, d)
    variants = autotune.KMEANS_VARIANTS[autotune.kmeans_maxd(d)]
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        if tuple(config) == variants[0]:
            err = _kmeans_entry()(*args, stream)
        else:
            err = _kmeans_entry("kmeans_assign_variant_launch")(*args, variants.index(tuple(config)), stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign kernel launch failed (config {config}): CUDA error {err}")
    return assign, mind2


def assign_with_config(xs: torch.Tensor, centers_s: torch.Tensor, config: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """One assignment over float32 xs (S, N, D), centers (S, K, D), S and
    N >= 1, with launch ``config``: the CUDA kernel for CUDA tensors, the
    plain version ``threads × points`` points at a time for CPU tensors
    (whole for the default).  Counts no launch in ``LAUNCHES`` (the
    autotuner times it)."""
    if _on_cpu(xs, centers_s):
        default = autotune.kmeans_default_config(xs.shape[2])
        return ref.kmeans_assign_sites_ref(xs, centers_s, config=None if tuple(config) == default else config)
    check_kmeans_kernel_limits(xs.shape[0], centers_s.shape[1], xs.shape[2])
    return _kmeans_run(xs, centers_s, config)


def _kmeans_plain(xs: torch.Tensor, centers_s: torch.Tensor, counter: str, block=None):
    """The CPU path of both wrappers: the plain version, as the config
    resolved for ``block`` says (recorded in ``LAST_CONFIG[counter]``)."""
    if xs.shape[0] == 0 or xs.shape[1] == 0:
        return ref.kmeans_assign_sites_ref(xs, centers_s)
    config = LAST_CONFIG[counter] = _kmeans_config(xs, centers_s, block)
    return assign_with_config(xs, centers_s, config)


def _kmeans_launch(xs: torch.Tensor, centers_s: torch.Tensor, counter: str, block=None):
    """The CUDA path of both wrappers: one launch over the site axis,
    counted under ``counter``, its config resolved once for the launch from
    ``block`` and recorded in ``LAST_CONFIG[counter]``; N = 0 returns empty
    outputs without one."""
    s, n, d = xs.shape
    check_kmeans_kernel_limits(s, centers_s.shape[1], d)
    if s == 0 or n == 0:
        return (torch.empty((s, n), dtype=torch.int32, device=xs.device),
                torch.empty((s, n), dtype=torch.float32, device=xs.device))
    config = LAST_CONFIG[counter] = _kmeans_config(xs, centers_s, block)
    out = _kmeans_run(xs, centers_s, config)
    LAUNCHES[counter] += 1
    return out


def _kmeans_path(xs: torch.Tensor, centers_s: torch.Tensor, counter: str, block):
    """Checked float32 operands to the plain version (CPU) or the kernel
    (card).  ``block`` reaches the launch only when given, so the launch
    keeps its (xs, centers, counter) form for the default mode."""
    if _on_cpu(xs, centers_s):
        return _kmeans_plain(xs, centers_s, counter, block)
    if block is None:
        return _kmeans_launch(xs, centers_s, counter)
    return _kmeans_launch(xs, centers_s, counter, block)


def kmeans_assign_sites(
    xs: torch.Tensor, centers_s: torch.Tensor, block=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Site-axis K-Means assignment in ONE launch: xs (S, N, D), centers
    (S, K, D) -> (assign (S, N) int32, min_d2 (S, N) f32), each site
    against its own centres.  ``d² = (‖x‖² + ‖c‖²) − 2·x·c`` in fp32; the
    argmin over the unclamped d² with ties to the lowest index; then
    ``max(min d², 0)``.  ``block``: the launch config (module docstring)."""
    xs, centers_s = _kmeans_operands(xs, centers_s)
    return _kmeans_path(xs, centers_s, "kmeans_assign_sites", block)


KMEANS_FLOORS = {"load_only": 1, "arith_only": 2}  # csrc/kmeans_assign.cuh's enum Mode


def kmeans_assign_floor(xs: torch.Tensor, centers_s: torch.Tensor, floor: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of a floor of the K-Means kernel (``csrc/kmeans_assign_floors.cu``),
    for measurement only: ``"load_only"`` reads every row of xs and writes
    both outputs from its bits, ``"arith_only"`` makes the points from their
    index and reads none.  Outputs as :func:`kmeans_assign_sites`, but not
    the assignment.  CUDA tensors with N >= 1 only; counts no launch in
    ``LAUNCHES``."""
    global _KMEANS_FLOOR_ENTRY
    xs, centers_s = _kmeans_operands(xs, centers_s)
    if _on_cpu(xs, centers_s) or xs.shape[1] == 0:
        raise ValueError("kmeans_assign_floor times the CUDA kernel: it takes CUDA tensors with N >= 1")
    s, n, d = xs.shape
    k = centers_s.shape[1]
    check_kmeans_kernel_limits(s, k, d)
    if d > KMEANS_MAX_REGISTER_D:
        raise ValueError(f"the K-Means floors are builds of the register kernel: D <= {KMEANS_MAX_REGISTER_D}, "
                         f"got D={d}")
    if _KMEANS_FLOOR_ENTRY is None:
        fn = _build.load("kmeans_assign_floors").kmeans_assign_floor_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _KMEANS_FLOOR_ENTRY = fn
    assign = torch.empty((s, n), dtype=torch.int32, device=xs.device)
    mind2 = torch.empty((s, n), dtype=torch.float32, device=xs.device)
    xs, centers_s = _aligned(xs), _aligned(centers_s)
    with torch.cuda.device(xs.device):
        err = _KMEANS_FLOOR_ENTRY(
            xs.data_ptr(), centers_s.data_ptr(), assign.data_ptr(), mind2.data_ptr(),
            s, n, k, d, KMEANS_FLOORS[floor], torch.cuda.current_stream(xs.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"kmeans_assign floor {floor} launch failed: CUDA error {err}")
    return assign, mind2


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor, block=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centre assignment: x (N, D), centers (K, D) ->
    (assign (N,) int32, min_d2 (N,) f32), as :func:`kmeans_assign_sites`
    for one site (its config is that shape's)."""
    if x.dim() != 2 or centers.dim() != 2:
        raise ValueError(f"want x (N, D) and centers (K, D), got {tuple(x.shape)}, {tuple(centers.shape)}")
    xs, cs = _kmeans_operands(x[None], centers[None])
    assign, mind2 = _kmeans_path(xs, cs, "kmeans_assign", block)
    return assign[0], mind2[0]


# ---------------------------------------------------------------------------
# sLSTM scan
# ---------------------------------------------------------------------------

# the sLSTM kernel's limits (csrc/slstm_scan.cu); the wrapper raises past them
SLSTM_UNITS = 16  # hidden units per CTA: P must be a multiple
SLSTM_MAX_P = 768  # R's columns of a CTA in shared memory
SLSTM_MAX_B = 8
SLSTM_PHASES = ("matvec", "cell", "publish", "wait", "reload")  # csrc/slstm_scan.cuh's enum Phase


def _slstm_entry(name: str = "slstm_scan"):
    """(launch, capacity, phases) of ``csrc/<name>.cu``: ``slstm_scan`` for
    the port's path, ``slstm_scan_timed`` for the phase timers."""
    entry = _SLSTM_ENTRY.get(name)
    if entry is None:
        lib = _build.load(name)
        launch = lib.slstm_scan_launch
        launch.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        capacity = lib.slstm_scan_capacity
        capacity.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        capacity.restype = ctypes.c_int
        timed = ctypes.c_int(0)
        phases = lib.slstm_scan_phases
        phases.argtypes = [ctypes.POINTER(ctypes.c_int)]
        phases.restype = ctypes.c_int
        n_phases = phases(ctypes.byref(timed))
        if bool(timed.value) != (name == "slstm_scan_timed"):
            raise RuntimeError(f"csrc/{name}.cu was built with SLSTM_PHASE_TIMERS={timed.value}")
        entry = _SLSTM_ENTRY[name] = (launch, capacity, n_phases)
    return entry


def slstm_scratch_shapes(b: int, h: int, p: int) -> dict[str, tuple[int, ...]]:
    """The shapes of the scratch one launch of the CUDA kernel takes from its
    wrapper: ``exchange``, the zeroed int64 words through which the CTAs of
    a head pass h (two steps, [parity][head][P][B padded to 1, 2, 4 or 8]),
    and ``cycles``, the int64 phase timers (CTAs, phases)."""
    nb = next(n for n in (1, 2, 4, 8) if n >= b)
    return {"exchange": (2, h, p, nb), "cycles": (h * (p // SLSTM_UNITS), len(SLSTM_PHASES))}


def check_slstm_kernel_limits(b: int, h: int, p: int, max_ctas: int | None = None) -> None:
    """Raise past the CUDA kernel's limits: P a positive multiple of 16 and
    at most 768, B at most 8, and (given the card's count of co-resident
    CTAs) the H·P/16 CTAs of one launch resident at once."""
    if p % SLSTM_UNITS or p < SLSTM_UNITS or p > SLSTM_MAX_P:
        raise ValueError(
            f"the CUDA slstm_scan kernel takes P a positive multiple of {SLSTM_UNITS} and at most {SLSTM_MAX_P}, "
            f"got P={p}"
        )
    if b > SLSTM_MAX_B:
        raise ValueError(f"the CUDA slstm_scan kernel takes B <= {SLSTM_MAX_B}, got B={b}")
    if max_ctas is not None and h * (p // SLSTM_UNITS) > max_ctas:
        raise ValueError(
            f"the CUDA slstm_scan kernel needs H*P/{SLSTM_UNITS} = {h * (p // SLSTM_UNITS)} co-resident CTAs, "
            f"the card holds {max_ctas}"
        )


def _slstm_operands(wx, r, bias, state0):
    if wx.dim() != 4 or wx.shape[-1] % 4:
        raise ValueError(f"want wx (B, S, H, 4P), got {tuple(wx.shape)}")
    b, _, h, p4 = wx.shape
    p = p4 // 4
    if tuple(r.shape) != (h, p, p4) or tuple(bias.shape) != (h, p4):
        raise ValueError(f"want R {(h, p, p4)} and bias {(h, p4)}, got {tuple(r.shape)}, {tuple(bias.shape)}")
    if len(state0) != 3 or any(tuple(t.shape) != (b, h, p) for t in state0):
        raise ValueError(f"want state0 = (c0, n0, h0) each {(b, h, p)}, got {[tuple(t.shape) for t in state0]}")
    if wx.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wx must be float32 or bfloat16, got {wx.dtype}")
    if r.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"R and bias must be float32, got {r.dtype}, {bias.dtype}")
    if any(t.dtype != wx.dtype for t in state0):
        raise TypeError(f"the initial state must be in wx's dtype {wx.dtype}, got {[t.dtype for t in state0]}")


def _slstm_run(wx, r, bias, state0, lib: str, exchange: torch.Tensor | None = None):
    """One launch of ``csrc/<lib>.cu`` on CUDA tensors already checked by
    ``_slstm_operands``: (hids, (cT, nT, hT), cycles), with cycles the
    (CTAs, phases) int64 timers (zeros unless ``lib`` is the timed build).
    ``exchange``, if given, is the int64 exchange buffer to use (of
    ``slstm_scratch_shapes``' shape, on wx's device); it is zeroed first,
    as a new one is."""
    c0, n0, h0 = state0
    b, s, h, p4 = wx.shape
    p = p4 // 4
    check_slstm_kernel_limits(b, h, p)
    for name, t in (("wx", wx), ("R", r), ("bias", bias), ("c0", c0), ("n0", n0), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    launch, capacity, n_phases = _slstm_entry(lib)
    is_bf16 = int(wx.dtype == torch.bfloat16)
    with torch.cuda.device(wx.device):
        max_ctas = ctypes.c_int(0)
        err = capacity(p, b, is_bf16, ctypes.byref(max_ctas))
        if err != 0:
            raise RuntimeError(f"slstm_scan occupancy query failed: CUDA error {err}")
        check_slstm_kernel_limits(b, h, p, max_ctas.value)
        hids = torch.empty((b, s, h, p), dtype=wx.dtype, device=wx.device)
        cT, nT, hT = (torch.empty_like(c0) for _ in range(3))
        shapes = slstm_scratch_shapes(b, h, p)
        if shapes["cycles"][1] != n_phases:
            raise RuntimeError(f"csrc/{lib}.cu has {n_phases} phases, ops.SLSTM_PHASES {len(SLSTM_PHASES)}")
        # zeroed on every call: no tag an earlier launch left in reused memory can match
        if exchange is None:
            xbuf = torch.zeros(shapes["exchange"], dtype=torch.int64, device=wx.device)
        else:
            if tuple(exchange.shape) != shapes["exchange"] or exchange.dtype != torch.int64 or (
                exchange.device != wx.device or not exchange.is_contiguous()
            ):
                raise ValueError(f"the exchange buffer must be contiguous int64 {shapes['exchange']} on {wx.device}")
            xbuf = exchange.zero_()
        cycles = torch.zeros(shapes["cycles"], dtype=torch.int64, device=wx.device)
        err = launch(
            wx.data_ptr(), r.data_ptr(), bias.data_ptr(), c0.data_ptr(), n0.data_ptr(), h0.data_ptr(),
            hids.data_ptr(), cT.data_ptr(), nT.data_ptr(), hT.data_ptr(), xbuf.data_ptr(), cycles.data_ptr(),
            b, s, h, p, is_bf16, torch.cuda.current_stream(wx.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{lib} kernel launch failed: CUDA error {err}")
    return hids, (cT, nT, hT), cycles


def _refuse_grad(name: str, *ts: torch.Tensor) -> None:
    """The CUDA launches read raw pointers, so their outputs carry no
    ``grad_fn``: under grad mode, inputs that require grad would have every
    gradient above the kernel dropped without an error.  Refuse them (the
    JAX package cannot differentiate its Pallas kernels either); serving
    and scoring run under ``torch.inference_mode()``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError(f"the CUDA {name} kernel has no backward: its inputs require grad under grad mode; "
                         f"run it under torch.inference_mode() or torch.no_grad()")


def slstm_scan(
    wx: torch.Tensor,
    r: torch.Tensor,
    bias: torch.Tensor,
    state0: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The sLSTM recurrence over the whole sequence in ONE launch: wx
    (B, S, H, 4P) batch-major in float32 or bfloat16, R (H, P, 4P) and bias
    (H, 4P) float32, state0 = (c0, n0, h0) each (B, H, P) in wx's dtype ->
    (hids (B, S, H, P), (cT, nT, hT)), all in wx's dtype; the semantics of
    ``ref.slstm_scan_ref`` (f32 state throughout).  Every tensor must be
    contiguous.  S = 0 or B = 0 returns empties without a launch.
    DTensors are refused (each rank passes its local shards)."""
    _refuse_dtensor("slstm_scan", wx, r, bias, *state0)
    _slstm_operands(wx, r, bias, state0)
    c0, n0, h0 = state0
    if _on_cpu(wx, r, bias, c0, n0, h0):
        return ref.slstm_scan_ref(wx, r, bias, state0)
    _refuse_grad("slstm_scan", wx, r, bias, c0, n0, h0)
    b, s, h, p4 = wx.shape
    if s == 0 or b == 0:
        return torch.empty((b, s, h, p4 // 4), dtype=wx.dtype, device=wx.device), (c0.clone(), n0.clone(), h0.clone())
    hids, state, _ = _slstm_run(wx, r, bias, state0, "slstm_scan")
    LAUNCHES["slstm_scan"] += 1
    return hids, state


def slstm_scan_phase_cycles(
    wx: torch.Tensor,
    r: torch.Tensor,
    bias: torch.Tensor,
    state0: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """``slstm_scan`` through the timed build (``csrc/slstm_scan_timed.cu``),
    for measurement only: (hids, (cT, nT, hT), cycles), cycles an int64
    (CTAs, len(SLSTM_PHASES)) tensor of the clock64() cycles that thread 0
    of each CTA spent in each phase, summed over the steps.  CUDA tensors
    only, S >= 1 and B >= 1; counts no launch in ``LAUNCHES``."""
    _slstm_operands(wx, r, bias, state0)
    if _on_cpu(wx, r, bias, *state0) or wx.shape[0] == 0 or wx.shape[1] == 0:
        raise ValueError("slstm_scan_phase_cycles times the CUDA kernel: it takes CUDA tensors with B, S >= 1")
    return _slstm_run(wx, r, bias, state0, "slstm_scan_timed")


def slstm_phase_split(cycles: torch.Tensor, steps: int, timed_ms: float) -> dict:
    """µs a step of each phase, the mean over CTAs, from the cycles of one
    timed launch of ``steps`` steps that took ``timed_ms``.  The SM clock is
    calibrated from that launch: each CTA's cycles over all phases span its
    whole step loop, so their mean over ``timed_ms`` is the clock (the
    phases then add up to the timed launch's µs a step).  Also gives the
    spread of the wait over CTAs (min, max) in µs a step."""
    cyc = cycles.double().cpu()
    per_cta = cyc.sum(1)
    hz = float(per_cta.mean()) / (timed_ms * 1e-3)
    us = cyc / hz * 1e6 / steps
    wait = us[:, SLSTM_PHASES.index("wait")]
    return {
        "us_per_step": {name: float(us[:, i].mean()) for i, name in enumerate(SLSTM_PHASES)},
        "wait_us_per_step_min_max": [float(wait.min()), float(wait.max())],
        "clock_mhz": hz / 1e6,
        "timed_us_per_step": timed_ms * 1e3 / steps,
        "ctas": int(cyc.shape[0]),
    }


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

# the flash kernels' limits (csrc/flash_attention.cu, csrc/flash_attention_wgmma.cu); the wrapper raises past them
FLASH_MAX_DH = 256
FLASH_DH_MULTIPLE = 8
FLASH_MAX_GRID_YZ = 65_535  # the grid's y and z axes: H and B (float32); Sq/128 and B (bfloat16)
FLASH_WGMMA_ROWS = 128  # query rows a CTA of the bfloat16 kernel


FLASH_PHASES = ("copy", "qk", "softmax", "pv", "barrier")  # csrc/flash_attention.cuh's enum Phase


def _flash_entry(name: str = "flash_attention"):
    """(launch, query rows a CTA) of the float32 kernel in ``csrc/<name>.cu``:
    ``flash_attention`` for the port's path, ``flash_attention_timed`` for
    the phase timers."""
    entry = _FLASH_ENTRY.get(name)
    if entry is None:
        lib = _build.load(name)
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        phases = lib.flash_attention_phases
        phases.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        phases.restype = ctypes.c_int
        timed, rows = ctypes.c_int(0), ctypes.c_int(0)
        n_phases = phases(ctypes.byref(timed), ctypes.byref(rows))
        if bool(timed.value) != (name == "flash_attention_timed") or n_phases != len(FLASH_PHASES):
            raise RuntimeError(f"csrc/{name}.cu was built with FLASH_PHASE_TIMERS={timed.value} and "
                               f"{n_phases} phases, ops.FLASH_PHASES has {len(FLASH_PHASES)}")
        entry = _FLASH_ENTRY[name] = (fn, rows.value)
    return entry


def _flash_wgmma_entry():
    global _FLASH_WGMMA_ENTRY
    if _FLASH_WGMMA_ENTRY is None:
        fn = _build.load("flash_attention_wgmma").flash_attention_wgmma_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FLASH_WGMMA_ENTRY = fn
    return _FLASH_WGMMA_ENTRY


def _flash_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, H, Dh) and k, v (B, Skv, Kv, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    kvh = k.shape[2]
    if kvh < 1 or h % kvh:
        raise ValueError(f"H={h} query heads must be a multiple of Kv={kvh} KV heads")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be all float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh % FLASH_DH_MULTIPLE or dh > FLASH_MAX_DH:
        raise ValueError(f"the flash kernel takes Dh a multiple of {FLASH_DH_MULTIPLE} and at most "
                         f"{FLASH_MAX_DH}, got Dh={dh}")


def _flash_cuda_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The CUDA kernels' own limits, past ``_flash_operands``' checks."""
    b, sq, h, _ = q.shape
    if b > FLASH_MAX_GRID_YZ or h > FLASH_MAX_GRID_YZ:
        raise ValueError(f"the flash kernel takes B and H at most {FLASH_MAX_GRID_YZ}, got B={b}, H={h}")
    if q.dtype == torch.bfloat16 and -(-sq // FLASH_WGMMA_ROWS) > FLASH_MAX_GRID_YZ:
        raise ValueError(f"the bfloat16 flash kernel takes Sq at most {FLASH_MAX_GRID_YZ * FLASH_WGMMA_ROWS}, "
                         f"got Sq={sq}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, window: int = 0, cap: float = 0.0
) -> torch.Tensor:
    """Forward attention with GQA, the causal and sliding-window masks and
    a tanh logit softcap, in ONE launch: q (B, Sq, H, Dh), k/v
    (B, Skv, Kv, Dh), all float32 or all bfloat16, H % Kv == 0, Dh a
    multiple of 8 and at most 256 -> (B, Sq, H, Dh) in q's dtype; the
    semantics of ``ref.flash_attention_ref`` (f32 scores and accumulator).
    On the card bfloat16 runs on the tensor cores
    (``csrc/flash_attention_wgmma.cu``) and float32 on the CUDA cores
    (``csrc/flash_attention.cu``).  Positions run from 0 on both axes.
    CUDA tensors must be contiguous.  An empty B, Sq or Skv returns without
    a launch (zeros for Skv = 0).  DTensors are refused: a sharded step
    calls ``flash_attention_sharded``."""
    _refuse_dtensor("flash_attention", q, k, v)
    _flash_operands(q, k, v)
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap)
    _flash_cuda_operands(q, k, v)
    _refuse_grad("flash_attention", q, k, v)
    if 0 in (q.shape[0], q.shape[1], k.shape[1]):
        return torch.zeros_like(q)
    out, _ = _flash_run(q, k, v, causal, window, cap, "flash_attention_wgmma" if q.dtype == torch.bfloat16
                        else "flash_attention")
    LAUNCHES["flash_attention"] += 1
    if q.dtype == torch.bfloat16:
        LAUNCHES["flash_attention_wgmma"] += 1
    return out


def flash_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                            window: int = 0, cap: float = 0.0) -> torch.Tensor:
    """``flash_attention`` of q (B, Sq, H, Dh), k/v (B, Skv, Kv, Dh) that
    may be DTensors: each rank launches the kernel on its own batch rows
    and heads (``sharding.local_heads``: batch on ``data``, heads on
    ``model``), with no collective, as the reference's attention runs on
    each device after its constraints; plain tensors go straight to
    ``flash_attention``.  The local operands are made contiguous."""
    return local_heads(lambda q, k, v: flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                                       causal=causal, window=window, cap=cap), q, k, v)


def _flash_run(q, k, v, causal, window, cap, lib: str):
    """One launch of ``csrc/<lib>.cu`` on non-empty contiguous CUDA tensors
    already checked: (out, cycles), cycles the (CTAs, len(FLASH_PHASES))
    int64 timers of the float32 kernel's timed build (None otherwise)."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    sizes = (b, sq, skv, h, kvh, dh, 1.0 / math.sqrt(dh), int(bool(causal)), int(window), float(cap))
    cycles = None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if lib == "flash_attention_wgmma":
            err = _flash_wgmma_entry()(*args, *sizes, stream)
        else:
            if lib == "flash_attention_timed":
                cycles = torch.zeros((flash_ctas(b, sq, h), len(FLASH_PHASES)), dtype=torch.int64, device=q.device)
            err = _flash_entry(lib)[0](*args, None if cycles is None else cycles.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"{lib} kernel launch failed: CUDA error {err}")
    return out, cycles


def flash_ctas(b: int, sq: int, h: int) -> int:
    """The CTAs of one launch of the float32 CUDA kernel (built on first
    use): one per (the kernel's query rows, head, batch row)."""
    return -(-sq // _flash_entry("flash_attention_timed")[1]) * h * b


def flash_attention_phase_cycles(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, window: int = 0, cap: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` in float32 through the timed build
    (``csrc/flash_attention_timed.cu``), for measurement only: (out,
    cycles), cycles an int64 (CTAs, len(FLASH_PHASES)) tensor of the
    clock64() cycles thread 0 of each CTA spent in each phase.  Non-empty
    contiguous CUDA float32 tensors only; counts no launch in ``LAUNCHES``."""
    _flash_operands(q, k, v)
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention_phase_cycles times the float32 kernel, got {q.dtype}")
    if _on_cpu(q, k, v) or 0 in (q.shape[0], q.shape[1], k.shape[1]):
        raise ValueError("flash_attention_phase_cycles times the CUDA kernel: it takes CUDA tensors with B, Sq, "
                         "Skv >= 1")
    _flash_cuda_operands(q, k, v)
    return _flash_run(q, k, v, causal, window, cap, "flash_attention_timed")


def flash_phase_split(cycles: torch.Tensor, timed_ms: float) -> dict:
    """Where one timed launch of ``timed_ms`` went: each phase's share of
    the cycles thread 0 of every CTA counted (summed over CTAs), and that
    share of ``timed_ms``; with the mean cycles a CTA and the CTAs."""
    cyc = cycles.double().cpu()
    per_phase = cyc.sum(0)
    total = float(per_phase.sum())
    shares = {name: float(per_phase[i]) / total for i, name in enumerate(FLASH_PHASES)}
    return {
        "share": shares,
        "phase_ms": {name: share * timed_ms for name, share in shares.items()},
        "cycles_per_cta_mean": total / cyc.shape[0],
        "timed_ms": timed_ms,
        "ctas": int(cyc.shape[0]),
    }
