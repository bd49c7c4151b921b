"""Wrappers around the hand-written support-count kernels.

Callers pass natural shapes: packed transactions ``(N, W)`` or
``(S, N, W)`` and candidate masks ``(C, W)`` or ``(S, C, W)``, as int32 bit
views of the uint32 words.  A tensor on the CPU goes to the plain version
in ``ref``; a CUDA tensor goes to the CUDA kernel
(``csrc/support_count.cu``), or the wrapper raises.  The kernel picks its
own tile.  Zero candidates or zero transactions return zeros without a
launch.

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
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_ENTRY = None


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
    raise ValueError(f"support counting needs all tensors on the CPU or on one CUDA device, got {kinds}")


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
