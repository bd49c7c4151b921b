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
"""

from __future__ import annotations

import ctypes
import math
from collections.abc import Sequence

import torch

from repro_torch.kernels import _build, ref

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


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_ENTRY: dict = {}
_KMEANS_ENTRY = None
_KMEANS_FLOOR_ENTRY = None
_SLSTM_ENTRY: dict = {}
_FLASH_ENTRY: dict = {}
_FLASH_WGMMA_ENTRY = None

# the K-Means kernel's limits (csrc/kmeans_assign.cu); the wrapper raises past them
KMEANS_MAX_D = 128
KMEANS_MAX_K = 65_536
KMEANS_MAX_S = 65_535


def _entry(name: str = "support_count_sites_launch"):
    """A C entry point of ``csrc/support_count.cu``: both stages
    (``support_count_sites_launch``, the path's), or one of them
    (``support_count_transpose_launch``, ``support_count_vertical_launch``)."""
    fn = _ENTRY.get(name)
    if fn is None:
        fn = getattr(_build.load("support_count"), name)
        fn.argtypes = {
            "support_count_sites_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
            "support_count_transpose_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            "support_count_vertical_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        }[name]
        fn.restype = ctypes.c_int
        _ENTRY[name] = fn
    return fn


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


def _launch(tx: torch.Tensor, masks: torch.Tensor, min_counts: torch.Tensor | None):
    """Both stages of the CUDA count over the site axis, one call: the
    transpose into a vertical bitmap from PyTorch's caching allocator, then
    the count.  Returns (counts, flags|None)."""
    s, n, w = tx.shape
    c = masks.shape[1]
    if w > 32:
        raise ValueError(f"the CUDA kernel takes at most 32 words (1024 items), got W={w}")
    for name, t in (("tx", tx), ("masks", masks), ("min_counts", min_counts)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    counts = torch.empty((s, c), dtype=torch.int32, device=tx.device)
    flags = None if min_counts is None else torch.empty((s, c), dtype=torch.bool, device=tx.device)
    vt = torch.empty(_vt_shape(s, n, w), dtype=torch.int32, device=tx.device)
    with torch.cuda.device(tx.device):
        err = _entry()(
            tx.data_ptr(),
            masks.data_ptr(),
            None if min_counts is None else min_counts.data_ptr(),
            counts.data_ptr(),
            None if flags is None else flags.data_ptr(),
            vt.data_ptr(),
            s, n, c, w,
            tx.device.index,
            torch.cuda.current_stream(tx.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"support_count kernel launch failed: CUDA error {err}")
    return counts, flags


def vertical_bitmap(tx_packed_s: torch.Tensor) -> torch.Tensor:
    """The support count's first stage alone, for checks and timing: tx
    (S, N, W) int32 -> vt (S, 32·W, ceil(N/32)) int32, the semantics of
    ``ref.vertical_bitmap_ref``.  On the card it launches the transpose
    kernel (S, N >= 1, W <= 32, contiguous); counts no launch in ``LAUNCHES``."""
    _check_sites(tx_packed_s, tx_packed_s[:, :0])
    if _on_cpu(tx_packed_s):
        return ref.vertical_bitmap_ref(tx_packed_s)
    s, n, w = tx_packed_s.shape
    if s == 0 or n == 0 or w > 32 or not tx_packed_s.is_contiguous():
        raise ValueError(f"the transpose kernel takes contiguous (S, N, W) with S, N >= 1 and W <= 32, "
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
    if s == 0 or n == 0 or c == 0 or w > 32 or not (vt.is_contiguous() and masks_s.is_contiguous()):
        raise ValueError(f"the count kernel takes contiguous operands with S, N, C >= 1 and W <= 32, "
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


def support_count_sites(tx_packed_s: torch.Tensor, masks_s: torch.Tensor) -> torch.Tensor:
    """Site-axis support counts in ONE launch: tx (S, N, W), masks
    (S, C, W) -> (S, C) int32, each site counted against its own masks."""
    _check_sites(tx_packed_s, masks_s)
    if _on_cpu(tx_packed_s, masks_s):
        return ref.support_count_sites_ref(tx_packed_s, masks_s)
    s, n, _ = tx_packed_s.shape
    c = masks_s.shape[1]
    if s == 0 or n == 0 or c == 0:
        return torch.zeros((s, c), dtype=torch.int32, device=tx_packed_s.device)
    counts, _ = _launch(tx_packed_s, masks_s, None)
    LAUNCHES["support_count_sites"] += 1
    return counts


def support_count_prune_sites(
    tx_packed_s: torch.Tensor,
    masks_s: torch.Tensor,
    min_counts: torch.Tensor | Sequence[int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Site-axis count + threshold in ONE launch with PER-SITE thresholds:
    min_counts (S,) -> (counts (S, C) int32, frequent (S, C) bool) with
    ``frequent == counts >= min_counts[:, None]`` exactly."""
    _check_sites(tx_packed_s, masks_s)
    mc = torch.as_tensor(min_counts, dtype=torch.int32, device=tx_packed_s.device)
    if mc.shape != (tx_packed_s.shape[0],):
        raise ValueError(f"want one threshold per site, got min_counts of shape {tuple(mc.shape)}")
    if _on_cpu(tx_packed_s, masks_s):
        return ref.support_count_prune_sites_ref(tx_packed_s, masks_s, mc)
    s, n, _ = tx_packed_s.shape
    c = masks_s.shape[1]
    if s == 0 or n == 0 or c == 0:
        counts = torch.zeros((s, c), dtype=torch.int32, device=tx_packed_s.device)
        return counts, counts >= mc[:, None]
    counts, flags = _launch(tx_packed_s, masks_s, mc.contiguous())
    LAUNCHES["support_count_prune_sites"] += 1
    return counts, flags


def support_count(tx_packed: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Support counts: tx (N, W), masks (C, W) -> (C,) int32."""
    if tx_packed.dim() != 2 or masks.dim() != 2:
        raise ValueError(f"want tx (N, W) and masks (C, W), got {tuple(tx_packed.shape)}, {tuple(masks.shape)}")
    _check_sites(tx_packed[None], masks[None])
    if _on_cpu(tx_packed, masks):
        return ref.support_count_ref(tx_packed, masks)
    n, c = tx_packed.shape[0], masks.shape[0]
    if n == 0 or c == 0:
        return torch.zeros((c,), dtype=torch.int32, device=tx_packed.device)
    counts, _ = _launch(tx_packed[None], masks[None], None)
    LAUNCHES["support_count"] += 1
    return counts[0]


def support_count_prune(
    tx_packed: torch.Tensor, masks: torch.Tensor, min_count: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused count + threshold: ``(counts (C,) int32, frequent (C,) bool)``
    with ``frequent == counts >= min_count`` exactly."""
    if tx_packed.dim() != 2 or masks.dim() != 2:
        raise ValueError(f"want tx (N, W) and masks (C, W), got {tuple(tx_packed.shape)}, {tuple(masks.shape)}")
    _check_sites(tx_packed[None], masks[None])
    if _on_cpu(tx_packed, masks):
        return ref.support_count_prune_ref(tx_packed, masks, min_count)
    n, c = tx_packed.shape[0], masks.shape[0]
    if n == 0 or c == 0:
        counts = torch.zeros((c,), dtype=torch.int32, device=tx_packed.device)
        return counts, counts >= int(min_count)
    mc = torch.tensor([int(min_count)], dtype=torch.int32, device=tx_packed.device)
    counts, flags = _launch(tx_packed[None], masks[None], mc)
    LAUNCHES["support_count_prune"] += 1
    return counts[0], flags[0]


# ---------------------------------------------------------------------------
# K-Means assignment
# ---------------------------------------------------------------------------


def _kmeans_entry():
    global _KMEANS_ENTRY
    if _KMEANS_ENTRY is None:
        fn = _build.load("kmeans_assign").kmeans_assign_sites_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _KMEANS_ENTRY = fn
    return _KMEANS_ENTRY


def check_kmeans_kernel_limits(s: int, k: int, d: int) -> None:
    """Raise past the CUDA kernel's limits: 1 <= D <= 128, K <= 65,536,
    S <= 65,535 (the grid's y axis)."""
    if d > KMEANS_MAX_D:
        raise ValueError(f"the CUDA kmeans_assign kernel takes D <= {KMEANS_MAX_D}, got D={d}")
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


def _kmeans_launch(xs: torch.Tensor, centers_s: torch.Tensor, counter: str):
    """The CUDA path of both wrappers: one launch over the site axis,
    counted under ``counter``; N = 0 returns empty outputs without one."""
    s, n, d = xs.shape
    k = centers_s.shape[1]
    check_kmeans_kernel_limits(s, k, d)
    assign = torch.empty((s, n), dtype=torch.int32, device=xs.device)
    mind2 = torch.empty((s, n), dtype=torch.float32, device=xs.device)
    if s == 0 or n == 0:
        return assign, mind2
    xs, centers_s = _aligned(xs), _aligned(centers_s)
    with torch.cuda.device(xs.device):
        err = _kmeans_entry()(
            xs.data_ptr(), centers_s.data_ptr(), assign.data_ptr(), mind2.data_ptr(),
            s, n, k, d, torch.cuda.current_stream(xs.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"kmeans_assign kernel launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1
    return assign, mind2


def kmeans_assign_sites(xs: torch.Tensor, centers_s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Site-axis K-Means assignment in ONE launch: xs (S, N, D), centers
    (S, K, D) -> (assign (S, N) int32, min_d2 (S, N) f32), each site
    against its own centres.  ``d² = (‖x‖² + ‖c‖²) − 2·x·c`` in fp32; the
    argmin over the unclamped d² with ties to the lowest index; then
    ``max(min d², 0)``."""
    xs, centers_s = _kmeans_operands(xs, centers_s)
    if _on_cpu(xs, centers_s):
        return ref.kmeans_assign_sites_ref(xs, centers_s)
    return _kmeans_launch(xs, centers_s, "kmeans_assign_sites")


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


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centre assignment: x (N, D), centers (K, D) ->
    (assign (N,) int32, min_d2 (N,) f32), as :func:`kmeans_assign_sites`
    for one site."""
    if x.dim() != 2 or centers.dim() != 2:
        raise ValueError(f"want x (N, D) and centers (K, D), got {tuple(x.shape)}, {tuple(centers.shape)}")
    xs, cs = _kmeans_operands(x[None], centers[None])
    if _on_cpu(xs, cs):
        return ref.kmeans_assign_ref(xs[0], cs[0])
    assign, mind2 = _kmeans_launch(xs, cs, "kmeans_assign")
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
    contiguous.  S = 0 or B = 0 returns empties without a launch."""
    _slstm_operands(wx, r, bias, state0)
    c0, n0, h0 = state0
    if _on_cpu(wx, r, bias, c0, n0, h0):
        return ref.slstm_scan_ref(wx, r, bias, state0)
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
    a launch (zeros for Skv = 0)."""
    _flash_operands(q, k, v)
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap)
    _flash_cuda_operands(q, k, v)
    if 0 in (q.shape[0], q.shape[1], k.shape[1]):
        return torch.zeros_like(q)
    out, _ = _flash_run(q, k, v, causal, window, cap, "flash_attention_wgmma" if q.dtype == torch.bfloat16
                        else "flash_attention")
    LAUNCHES["flash_attention"] += 1
    if q.dtype == torch.bfloat16:
        LAUNCHES["flash_attention_wgmma"] += 1
    return out


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
