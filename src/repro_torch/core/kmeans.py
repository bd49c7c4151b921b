"""Local K-Means (Lloyd) with k-means++ seeding.

This is the per-site "local clustering" stage of the paper's Algorithm 1.
The assignment step (pairwise distance + argmin) is the compute hot-spot:
``use_kernel=True`` sends it to the hand-written CUDA kernel through
``repro_torch.kernels.ops`` (whose wrappers run the plain version for CPU
tensors), ``False`` to the matmul form followed by argmin, as the JAX
package's ``_assign`` does.

Every function has a site-batched form over a leading site axis S, which
the batched execution backend calls: all S sites' Lloyd iterations run
together, with ONE ``kmeans_assign_sites`` launch per iteration.  A site
gets the same bits alone (S = 1, the inline backend) and in a batch: the
kernel computes each point on its own, the per-cluster sums are exact
integer sums (``core.stats.segment_sums``), and everything else is
elementwise or an argmin/argmax, which picks the first index on ties.

Seeding: ``jax.random`` streams cannot be reproduced in torch, so
``kmeans`` takes explicit ``init_centers`` (the seam through which tests
hand over the JAX package's k-means++ draws); without them it seeds
k-means++ from one ``torch.Generator`` per site, seeded from
``(seed, site)`` (:func:`site_generator`).  ``gap_statistic`` is not
ported yet.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.stats import (
    SuffStats,
    fixed_point,
    pairwise_sq_dists,
    segment_sums,
    stats_from_assignment_sites,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import dot_last


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (k, D), or (S, k, D) from the site forms
    assign: torch.Tensor  # (N,) int32, or (S, N)
    inertia: torch.Tensor  # () total SSE, or (S,)
    stats: SuffStats  # per-cluster sufficient statistics


AssignFn = Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def _assign(x: torch.Tensor, centers: torch.Tensor, use_kernel: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-center assignment; returns (assign (N,) int32, min_d2 (N,))."""
    if use_kernel:
        return ops.kmeans_assign(x, centers)
    d2 = pairwise_sq_dists(x, centers)
    return torch.argmin(d2, dim=-1).to(torch.int32), d2.min(dim=-1).values


def _assign_sites(xs: torch.Tensor, centers: torch.Tensor, use_kernel: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The site form of :func:`_assign`: (S, N, D), (S, k, D) -> (S, N) each."""
    if use_kernel:
        return ops.kmeans_assign_sites(xs, centers)
    d2 = pairwise_sq_dists(xs, centers)
    return torch.argmin(d2, dim=-1).to(torch.int32), d2.min(dim=-1).values


def _site_assign_fn(use_kernel: bool, batched: bool) -> AssignFn:
    """The assignment a Lloyd run over (S, N, D) calls: the site wrapper
    for a batch, the single-site wrapper (on S = 1) for one site."""
    if batched:
        return lambda xs, c: _assign_sites(xs, c, use_kernel)

    def one(xs, c):
        a, m = _assign(xs[0], c[0], use_kernel)
        return a[None], m[None]

    return one


def site_generator(seed: int, site: int) -> torch.Generator:
    """The k-means++ generator of ``site`` under run seed ``seed``: its
    own stream, so a site draws the same numbers alone and in a batch."""
    state = np.random.SeedSequence([int(seed), int(site)]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def kmeans_plus_plus_sites(
    xs: torch.Tensor, k: int, generators: Sequence[torch.Generator]
) -> torch.Tensor:
    """k-means++ seeding (Arthur & Vassilvitskii) of every site at once:
    xs (S, N, D) -> (S, k, D) centres, each a data point of its site.

    Site s draws k uniforms from ``generators[s]``: the first picks a
    point uniformly, the i-th picks a point with probability proportional
    to its squared distance to the nearest centre chosen so far, by
    inverse CDF.  That distance is updated incrementally, one (S, N) pass
    per centre, and the CDF is an exact integer prefix sum of fixed-point
    distances, so a site's choice does not depend on the batch."""
    s, n, d = xs.shape
    if len(generators) != s:
        raise ValueError(f"want one generator per site, got {len(generators)} for {s} sites")
    u = torch.stack([torch.rand(k, generator=g, dtype=torch.float64) for g in generators]).to(xs.device)
    rows = torch.arange(s, device=xs.device)
    x2 = dot_last(xs, xs)

    def d2_to(c):  # c (S, D) -> (S, N) squared distances, expanded form clamped at 0
        return ((x2 + dot_last(c, c)[:, None]) - 2.0 * dot_last(xs, c[:, None, :])).clamp(min=0.0)

    centers = torch.empty((s, k, d), dtype=xs.dtype, device=xs.device)
    first = (u[:, 0] * n).long().clamp(max=n - 1)
    centers[:, 0] = xs[rows, first]
    mind2 = d2_to(centers[:, 0])
    for i in range(1, k):
        q, _ = fixed_point(mind2[..., None])
        cdf = torch.cumsum(q[..., 0], dim=1)  # int64: exact, in any order
        total = cdf[:, -1]
        target = torch.minimum((u[:, i] * total.double()).long(), (total - 1).clamp(min=0))
        idx = torch.searchsorted(cdf, target[:, None], right=True)[:, 0].clamp(max=n - 1)
        centers[:, i] = xs[rows, idx]
        mind2 = torch.minimum(mind2, d2_to(centers[:, i]))
    return centers


def lloyd_sites(xs: torch.Tensor, centers: torch.Tensor, iters: int, assign_fn: AssignFn) -> KMeansResult:
    """``iters`` Lloyd steps from ``centers`` (S, k, D) on every site,
    then the final assignment and its statistics.  The step is the JAX
    package's (``repro/core/kmeans.py:82-100``): empty clusters keep their
    centre, then the first empty one (if any) is re-seeded at the point
    farthest from its centre — one repair per iteration."""
    s, _, _ = xs.shape
    k = centers.shape[1]
    rows = torch.arange(s, device=xs.device)
    for _ in range(iters):
        assign, mind2 = assign_fn(xs, centers)
        counts, sums, _ = segment_sums(xs, assign, k)
        new = (sums / counts.double().clamp(min=1.0)[..., None]).to(centers.dtype)
        new = torch.where((counts > 0)[..., None], new, centers)
        far = torch.argmax(mind2, dim=1)
        empty = counts == 0
        first_empty = torch.argmax(empty.to(torch.int32), dim=1)  # first True, 0 if none
        repaired = torch.where(empty.any(dim=1)[:, None], xs[rows, far], new[rows, first_empty])
        new[rows, first_empty] = repaired
        centers = new
    assign, mind2 = assign_fn(xs, centers)
    stats = stats_from_assignment_sites(xs, assign, k)
    return KMeansResult(centers=stats.centers, assign=assign, inertia=mind2.sum(dim=1), stats=stats)


def kmeans_sites(
    xs: torch.Tensor,
    k: int,
    iters: int = 25,
    use_kernel: bool = False,
    init_centers: torch.Tensor | None = None,
    seed: int = 0,
    sites: Sequence[int] | None = None,
) -> KMeansResult:
    """Lloyd's algorithm on every site at once: xs (S, N, D) -> a
    KMeansResult with a leading site axis, one ``kmeans_assign_sites``
    launch per iteration plus one for the final assignment.

    ``init_centers`` (S, k, D) replaces the seeding; otherwise site
    ``sites[j]`` (default j) seeds k-means++ from ``site_generator(seed,
    sites[j])``."""
    xs = xs.float()
    if init_centers is None:
        ids = range(xs.shape[0]) if sites is None else sites
        init_centers = kmeans_plus_plus_sites(xs, k, [site_generator(seed, i) for i in ids])
    centers = init_centers.to(device=xs.device, dtype=torch.float32)
    if centers.shape != (xs.shape[0], k, xs.shape[2]):
        raise ValueError(f"want init_centers of shape {(xs.shape[0], k, xs.shape[2])}, got {tuple(centers.shape)}")
    return lloyd_sites(xs, centers, iters, _site_assign_fn(use_kernel, batched=True))


def _one_site(res: KMeansResult) -> KMeansResult:
    st = res.stats
    return KMeansResult(
        centers=res.centers[0],
        assign=res.assign[0],
        inertia=res.inertia[0],
        stats=SuffStats(sizes=st.sizes[0], centers=st.centers[0], sse=st.sse[0]),
    )


def kmeans(
    x: torch.Tensor,
    k: int,
    iters: int = 25,
    use_kernel: bool = False,
    init_centers: torch.Tensor | None = None,
    seed: int = 0,
    site: int = 0,
) -> KMeansResult:
    """Lloyd's algorithm with fixed iteration count (grid-friendly: no
    data-dependent termination, identical work on every site), on one
    site's points x (N, D), through the single-site assignment wrapper.

    Empty clusters are re-seeded at the point farthest from its center
    (standard Lloyd repair), keeping k live clusters where possible.
    ``init_centers`` (k, D) replaces the seeding; otherwise k-means++
    draws from ``site_generator(seed, site)``, so this equals site
    ``site`` of :func:`kmeans_sites`.
    """
    xs = x.float()[None]
    if init_centers is None:
        init = kmeans_plus_plus_sites(xs, k, [site_generator(seed, site)])
    else:
        init = init_centers.to(device=xs.device, dtype=torch.float32)[None]
    if init.shape != (1, k, xs.shape[2]):
        raise ValueError(f"want init_centers of shape {(k, xs.shape[2])}, got {tuple(init.shape[1:])}")
    return _one_site(lloyd_sites(xs, init, iters, _site_assign_fn(use_kernel, batched=False)))


def kmeans_warm(
    x: torch.Tensor,
    centers0: torch.Tensor,
    iters: int = 25,
    use_kernel: bool = False,
) -> KMeansResult:
    """Lloyd's algorithm warm-started from explicit initial centers —
    exactly the ``kmeans`` iteration (same empty-cluster repair, same
    statistics), minus the seeding."""
    return kmeans(x, centers0.shape[0], iters=iters, use_kernel=use_kernel, init_centers=centers0)
