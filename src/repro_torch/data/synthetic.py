"""Synthetic datasets matching the paper's experimental setup.

The paper (§5.2): "For the clustering task, the data is a set of random
Gaussian distributions.  For the frequent itemsets mining, synthetic
transactions from different sizes were generated."  The generators are
numpy-only and draw from ``np.random.default_rng`` exactly as the JAX
package's ``repro.data.synthetic`` does, so one seed gives byte-identical
arrays in both packages.
"""

from __future__ import annotations

import numpy as np


def gaussian_mixture(
    seed: int,
    n_points: int,
    dim: int,
    n_components: int,
    spread: float = 10.0,
    sigma: float = 0.6,
) -> tuple[np.ndarray, np.ndarray]:
    """Random Gaussian mixture.  Returns (points (N, D) f32, labels (N,))."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, size=(n_components, dim)).astype(np.float32)
    comp = rng.integers(0, n_components, size=n_points)
    pts = centers[comp] + rng.normal(0.0, sigma, size=(n_points, dim)).astype(np.float32)
    return pts.astype(np.float32), comp


def split_sites(x: np.ndarray, n_sites: int, seed: int = 0) -> np.ndarray:
    """Shuffle and split points evenly into (s, n, D) site shards
    (the paper distributes the dataset uniformly over processes)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    n = (len(x) // n_sites) * n_sites
    return x[idx[:n]].reshape(n_sites, -1, *x.shape[1:])


def ibm_transactions(
    seed: int,
    n_tx: int,
    n_items: int,
    avg_tx_len: int = 10,
    n_patterns: int = 20,
    avg_pattern_len: int = 4,
    corruption: float = 0.25,
) -> np.ndarray:
    """IBM Quest-style synthetic transaction generator (T_avg I_pat D_n).

    Draws maximal potentially-frequent patterns (exponential lengths around
    ``avg_pattern_len``), then assembles transactions from patterns with
    per-item corruption + random noise items.  Returns dense bool
    (n_tx, n_items).
    """
    rng = np.random.default_rng(seed)
    patterns = []
    weights = rng.exponential(1.0, n_patterns)
    weights /= weights.sum()
    for _ in range(n_patterns):
        ln = max(1, min(n_items, int(rng.poisson(avg_pattern_len))))
        patterns.append(rng.choice(n_items, size=ln, replace=False))

    dense = np.zeros((n_tx, n_items), dtype=bool)
    for t in range(n_tx):
        ln = max(1, int(rng.poisson(avg_tx_len)))
        got = 0
        while got < ln:
            p = patterns[rng.choice(n_patterns, p=weights)]
            keep = p[rng.random(len(p)) > corruption]
            dense[t, keep] = True
            got += max(len(keep), 1)
        # sprinkle noise items
        n_noise = rng.integers(0, 3)
        if n_noise:
            dense[t, rng.choice(n_items, size=n_noise, replace=False)] = True
    return dense


def split_transactions(dense: np.ndarray, n_sites: int, seed: int = 0) -> list[np.ndarray]:
    """Split a dense transaction DB into per-site shards (uneven tail ok)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(dense))
    return [dense[s] for s in np.array_split(idx, n_sites)]
