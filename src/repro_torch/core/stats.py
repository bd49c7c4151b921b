"""Sufficient statistics for variance-based distributed clustering.

The paper's key asymmetry: a site never ships data points, only the triple
(size N, center c, within-cluster SSE ``var``) per sub-cluster.  All global
decisions (merging, perturbation bookkeeping) are derivable from these.

Formulas (paper §3.1):

    N_new  = N_i + N_j
    c_new  = (N_i c_i + N_j c_j) / N_new
    var_new = var_i + var_j + s(i, j)
    s(i,j) = (N_i N_j) / (N_i + N_j) * d(c_i, c_j)^2

``var`` is the within-cluster *sum of squared distances* (SSE), which is
additive under the union formula above — this is what makes "logical
merging" possible with zero data movement.

Per-cluster sums are exact integer sums (:func:`segment_sums`), so they do
not depend on the order of the points, on the device, or on how many sites
are reduced together.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ref import dot_last


class SuffStats(NamedTuple):
    """Per-(sub)cluster sufficient statistics, vectorised over M slots
    (with optional leading site axes).

    sizes:   (M,)   float32 — number of points (0 marks a dead/empty slot)
    centers: (M, D) float32 — centroid
    sse:     (M,)   float32 — within-cluster sum of squared distances ("var")
    """

    sizes: torch.Tensor
    centers: torch.Tensor
    sse: torch.Tensor

    @property
    def n_slots(self) -> int:
        return self.sizes.shape[-1]

    @property
    def dim(self) -> int:
        return self.centers.shape[-1]


def fixed_point(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """v (S, N, C) float -> (int64 values, 2^-shift as f64 (S, 1, C)).

    Each (site, column) gets the largest power-of-two scale at which the
    sum of the magnitudes of all of that site's values in that column fits
    in 62 bits.  It is taken from the site's own data alone, so a site is
    quantized the same way alone and in a batch."""
    v = v.double()
    n = max(v.shape[1], 1)
    bound = v.abs().amax(dim=1, keepdim=True) * n  # (S, 1, C) >= any |partial sum|
    _, exp = torch.frexp(bound)  # bound < 2^exp
    scale = torch.exp2((62 - exp).clamp(-900, 900).to(torch.float64))
    return torch.round(v * scale).to(torch.int64), 1.0 / scale


def segment_sums(
    xs: torch.Tensor, assign: torch.Tensor, k: int, squares: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Per-site, per-cluster point counts and coordinate sums.

    xs (S, N, D) f32, assign (S, N) int in [0, k) -> (counts (S, k) int64,
    sums (S, k, D) f64, sqsums (S, k) f64 of ``‖x‖²`` if ``squares``).

    The reduction is an exact integer sum: each value is turned into a
    fixed-point int64 at a per-site, per-column power-of-two scale (a
    quantum of 2^-39 for coordinates of magnitude up to 32 at 250,000
    points a site, far below fp32's resolution) and summed with
    ``index_add_``.  Integer addition is associative, so the
    result does not depend on the order in which the card's atomics land,
    nor on the number of sites reduced together: a site alone (the inline
    backend) and a site in a batch of 200 (the batched backend) give the
    same bits.  A float sum (fp32 as in the JAX package, or fp64 atomics)
    changes with that order from run to run; fp64 with a fixed-order scan
    would depend on torch's internal scan order."""
    s, n, d = xs.shape
    cols = [xs]
    if squares:
        x64 = xs.double()
        cols.append(dot_last(x64, x64)[..., None])  # ‖x‖² per point, exact products, fixed order
    q, unscale = fixed_point(torch.cat(cols, dim=-1) if squares else xs)
    ones = torch.ones((s, n, 1), dtype=torch.int64, device=xs.device)
    src = torch.cat([ones, q], dim=-1).reshape(s * n, -1)
    idx = (assign.long() + k * torch.arange(s, device=xs.device)[:, None]).reshape(-1)
    acc = torch.zeros((s * k, src.shape[1]), dtype=torch.int64, device=xs.device)
    acc.index_add_(0, idx, src)
    acc = acc.reshape(s, k, -1)
    counts = acc[..., 0]
    vals = acc[..., 1:].double() * unscale  # (S, k, C) * (S, 1, C)
    sums = vals[..., :d]
    sq = vals[..., d] if squares else None
    return counts, sums, sq


def stats_from_assignment_sites(xs: torch.Tensor, assign: torch.Tensor, k: int) -> SuffStats:
    """Per-site sufficient statistics from an assignment: xs (S, N, D),
    assign (S, N) -> SuffStats with (S, k) sizes.  Empty clusters get size
    0, center 0, sse 0.  Centers and SSE are formed in fp64 from the exact
    sums and rounded to fp32 once; the SSE ``Σ‖x‖² − N‖c‖²`` would cancel
    badly in fp32 at thousands of points per cluster."""
    counts, sums, sq = segment_sums(xs, assign, k, squares=True)
    n = counts.double()
    centers = sums / n.clamp(min=1.0)[..., None]
    sse = (sq - n * dot_last(centers, centers)).clamp(min=0.0)
    return SuffStats(sizes=counts.float(), centers=centers.float(), sse=sse.float())


def stats_from_assignment(x: torch.Tensor, assign: torch.Tensor, k: int) -> SuffStats:
    """x (N, D); assign (N,) int in [0, k).  Returns SuffStats with M = k."""
    st = stats_from_assignment_sites(x[None], assign[None], k)
    return SuffStats(sizes=st.sizes[0], centers=st.centers[0], sse=st.sse[0])


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., Na, D), (..., Nb, D) -> (..., Na, Nb) squared euclidean
    distances in the matmul form |a|^2 + |b|^2 - 2 a.b^T (as the JAX
    package computes them), clamped at 0 against rounding.  fp32 matmuls
    stay in full fp32: the caller keeps ``allow_tf32`` off."""
    a = a.float()
    b = b.float()
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    d2 = a2 + b2 - 2.0 * (a @ b.transpose(-1, -2))
    return d2.clamp(min=0.0)


def merge_cost(stats: SuffStats) -> torch.Tensor:
    """Pairwise variance increase s(i,j) for every slot pair.

    Returns (M, M) float32; s(i,j) = N_i N_j/(N_i+N_j) * ||c_i - c_j||^2.
    Dead slots (size 0) produce +inf rows/cols; diagonal is +inf.
    """
    sizes, centers = stats.sizes, stats.centers
    m = sizes.shape[0]
    d2 = pairwise_sq_dists(centers, centers)
    denom = sizes[:, None] + sizes[None, :]
    inf = torch.tensor(float("inf"), device=sizes.device)
    s = torch.where(denom > 0, (sizes[:, None] * sizes[None, :]) / denom.clamp(min=1e-30) * d2, inf)
    alive = sizes > 0
    mask = alive[:, None] & alive[None, :] & ~torch.eye(m, dtype=torch.bool, device=sizes.device)
    return torch.where(mask, s, inf)


def merge_stats(stats: SuffStats, i: int | torch.Tensor, j: int | torch.Tensor) -> SuffStats:
    """Merge slot j into slot i (paper's update formulas); slot j dies.

    In place: ``stats``' tensors are updated and ``stats`` is returned (the
    merge loop calls this once per merge, ~4,000 times at the paper's
    size).  ``i`` and ``j`` may be ints or one-element index tensors, so a
    caller on the card need not read them back to the host."""
    dev = stats.sizes.device
    i = torch.as_tensor(i, device=dev).reshape(1)
    j = torch.as_tensor(j, device=dev).reshape(1)
    ni, nj = stats.sizes.index_select(0, i), stats.sizes.index_select(0, j)
    ci, cj = stats.centers.index_select(0, i), stats.centers.index_select(0, j)
    n_new = ni + nj
    w = torch.where(n_new > 0, 1.0 / n_new.clamp(min=1e-30), 0.0)
    c_new = (ni[:, None] * ci + nj[:, None] * cj) * w[:, None]
    s_ij = torch.where(n_new > 0, ni * nj * w * ((ci - cj) ** 2).sum(-1), 0.0)
    sse_new = stats.sse.index_select(0, i) + stats.sse.index_select(0, j) + s_ij
    for t, new in ((stats.sizes, n_new), (stats.centers, c_new), (stats.sse, sse_new)):
        t.index_copy_(0, i, new)
        t.index_fill_(0, j, 0.0)
    return stats


def stack_site_stats(per_site: SuffStats) -> SuffStats:
    """Flatten per-site stats (s, k, ...) into a single (s*k, ...) slot array.

    Slot index encodes the paper's ``cluster_{i,number}`` unique id:
    slot = site * k + number.
    """
    s, k = per_site.sizes.shape
    return SuffStats(
        sizes=per_site.sizes.reshape(s * k),
        centers=per_site.centers.reshape(s * k, -1),
        sse=per_site.sse.reshape(s * k),
    )


def total_sse(stats: SuffStats) -> torch.Tensor:
    """Global clustering objective: sum of within-cluster SSE over live slots."""
    return torch.where(stats.sizes > 0, stats.sse, 0.0).sum()


def stats_bytes(stats: SuffStats) -> int:
    """Communication payload of shipping these stats (paper's comm model).

    4 bytes/float: N + D (center) + SSE per slot.
    """
    m, d = stats.centers.shape
    return int(m * (1 + d + 1) * 4)
