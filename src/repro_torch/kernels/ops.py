"""Wrappers around the hand-written kernels: support counting and the
K-Means assignment.

Callers pass natural shapes: packed transactions ``(N, W)`` or
``(S, N, W)`` and candidate masks ``(C, W)`` or ``(S, C, W)``, as int32 bit
views of the uint32 words; points ``(N, D)`` or ``(S, N, D)`` and centres
``(K, D)`` or ``(S, K, D)``.  A tensor on the CPU goes to the plain version
in ``ref``; a CUDA tensor goes to the CUDA kernel
(``csrc/support_count.cu``, ``csrc/kmeans_assign.cu``), or the wrapper
raises.  The kernels pick their own tiles.  Zero candidates, transactions
or points return empty or zero results without a launch.

``LAUNCHES`` counts, per wrapper, the calls that launched the CUDA kernel,
so a run can show that its counting went through the kernel.
"""

from __future__ import annotations

import ctypes
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
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_ENTRY = None
_KMEANS_ENTRY = None

# the K-Means kernel's limits (csrc/kmeans_assign.cu); the wrapper raises past them
KMEANS_MAX_D = 128
KMEANS_MAX_K = 65_536
KMEANS_MAX_S = 65_535


def _entry():
    global _ENTRY
    if _ENTRY is None:
        fn = _build.load("support_count").support_count_sites_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY = fn
    return _ENTRY


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


def _launch(tx: torch.Tensor, masks: torch.Tensor, min_counts: torch.Tensor | None):
    """One kernel launch over the site axis.  Returns (counts, flags|None)."""
    s, n, w = tx.shape
    c = masks.shape[1]
    if w > 32:
        raise ValueError(f"the CUDA kernel takes at most 32 words (1024 items), got W={w}")
    for name, t in (("tx", tx), ("masks", masks), ("min_counts", min_counts)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    counts = torch.empty((s, c), dtype=torch.int32, device=tx.device)
    flags = None if min_counts is None else torch.empty((s, c), dtype=torch.bool, device=tx.device)
    with torch.cuda.device(tx.device):
        err = _entry()(
            tx.data_ptr(),
            masks.data_ptr(),
            None if min_counts is None else min_counts.data_ptr(),
            counts.data_ptr(),
            None if flags is None else flags.data_ptr(),
            s, n, c, w,
            tx.device.index,
            torch.cuda.current_stream(tx.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"support_count kernel launch failed: CUDA error {err}")
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
