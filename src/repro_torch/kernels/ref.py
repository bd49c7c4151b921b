"""Plain PyTorch versions of the hand-written kernels.

They define the semantics the CUDA kernels are held to, and they are what
``ops`` runs for tensors on the CPU.  Support counts are held to exact
integer equality.  Packed words are int32 bit views of the uint32 bitmaps:
``(t & m) == m`` is bit-exact on int32, and torch's uint32 lacks bitwise
ops on the CPU.

The K-Means assignment follows the TPU kernel
(``repro/kernels/kmeans_assign.py:_kernel``), not the JAX package's own
oracle: the argmin is taken over the UNCLAMPED ``d²`` (ties to the lowest
index) and only the minimum is clamped at 0.  Its dot products are summed
over ``d = 0 .. D-1`` in order, one rounding per product and per sum,
which is the order the CUDA kernel uses: the two agree bit for bit.
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


def dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Σ_d a[..., d] * b[..., d]`` (broadcast), summed over d in index
    order with one rounding per product and per sum (no fused
    multiply-add).  Every op is elementwise, so the result does not depend
    on the other dimensions' sizes: a site gets the same bits alone and in
    a batch of sites."""
    acc = a[..., 0] * b[..., 0]
    for d in range(1, a.shape[-1]):
        acc = acc + a[..., d] * b[..., d]
    return acc


def kmeans_assign_sites_ref(
    xs: torch.Tensor, centers_s: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """xs (S, N, D), centers (S, K, D) f32 -> (assign (S, N) int32,
    min_d2 (S, N) f32): ``d² = (‖x‖² + ‖c‖²) − 2·x·c`` per site, the
    argmin over the unclamped d² (first index on ties), then
    ``max(min d², 0)``."""
    x2 = dot_last(xs, xs)  # (S, N)
    c2 = dot_last(centers_s, centers_s)  # (S, K)
    xc = dot_last(xs[:, :, None, :], centers_s[:, None, :, :])  # (S, N, K)
    d2 = (x2[:, :, None] + c2[:, None, :]) - 2.0 * xc
    assign = torch.argmin(d2, dim=-1)
    mind2 = torch.gather(d2, -1, assign[..., None])[..., 0]
    return assign.to(torch.int32), mind2.clamp(min=0.0)


def kmeans_assign_ref(x: torch.Tensor, centers: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, D), centers (K, D) f32 -> (assign (N,) int32, min_d2 (N,) f32)."""
    assign, mind2 = kmeans_assign_sites_ref(x[None], centers[None])
    return assign[0], mind2[0]
