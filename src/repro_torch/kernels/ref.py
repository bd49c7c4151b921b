"""Plain PyTorch versions of the hand-written kernels.

They define the semantics the CUDA kernels are held to (exact integer
equality), and they are what ``ops`` runs for tensors on the CPU.  Packed
words are int32 bit views of the uint32 bitmaps: ``(t & m) == m`` is
bit-exact on int32, and torch's uint32 lacks bitwise ops on the CPU.
"""

from __future__ import annotations

import torch

BLOCK_C = 512  # candidates per chunk: bounds the (S, N, C) intermediate


def support_count_sites_ref(
    tx: torch.Tensor, masks: torch.Tensor, block_c: int = BLOCK_C
) -> torch.Tensor:
    """tx (S, N, W), masks (S, C, W) int32 -> (S, C) int32 supports: for
    each site, the rows of ``tx`` that hold every bit of the mask."""
    s, n, w = tx.shape
    s2, c, w2 = masks.shape
    if s != s2 or w != w2:
        raise ValueError(f"shape mismatch: tx {tuple(tx.shape)} vs masks {tuple(masks.shape)}")
    out = torch.zeros((s, c), dtype=torch.int32, device=tx.device)
    for c0 in range(0, c, block_c):
        mk = masks[:, c0 : c0 + block_c]  # (S, Cb, W)
        hit = torch.ones((s, n, mk.shape[1]), dtype=torch.bool, device=tx.device)
        for ww in range(w):
            m = mk[:, None, :, ww]  # (S, 1, Cb)
            hit &= (tx[:, :, ww, None] & m) == m
        out[:, c0 : c0 + block_c] = hit.sum(dim=1, dtype=torch.int32)
    return out


def support_count_prune_sites_ref(
    tx: torch.Tensor, masks: torch.Tensor, min_counts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The site form plus per-site thresholds: min_counts (S,) int32 ->
    ``(counts (S, C) int32, counts >= min_counts[:, None])``."""
    counts = support_count_sites_ref(tx, masks)
    return counts, counts >= min_counts.to(counts.device, torch.int32)[:, None]


def support_count_ref(tx: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """tx (N, W), masks (C, W) int32 -> (C,) int32 supports."""
    return support_count_sites_ref(tx[None], masks[None])[0]


def support_count_prune_ref(
    tx: torch.Tensor, masks: torch.Tensor, min_count: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts (C,) int32, counts >= min_count)``."""
    counts = support_count_ref(tx, masks)
    return counts, counts >= int(min_count)
