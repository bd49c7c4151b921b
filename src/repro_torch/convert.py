"""State carried across from the JAX package.

The mining apps have no weights: their state is the data and the seeded
draws.  GFM's is the packed transaction DB: the JAX package keeps each
site's words as ``(n_tx, W)`` uint32 (``repro.core.apriori.TransactionDB
.packed``); handed over as numpy arrays, they become the port's DBs with
the same bits, so both packages mine exactly the same data.  Clustering's
is the site points ``(S, n, D)`` and the per-site k-means++ centres
``(S, k, D)`` that ``jax.random`` drew, which torch cannot redraw.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.core.apriori import TransactionDB, n_words


def transaction_dbs_from_reference(
    packed: Sequence[np.ndarray], n_items: int, device: str | torch.device
) -> list[TransactionDB]:
    """Per-site ``(n_tx, W)`` uint32 word arrays -> the port's
    TransactionDBs on ``device`` (int32 bit views of the same words)."""
    out = []
    for words in packed:
        words = np.array(words, dtype=np.uint32)  # an owned, writable copy
        if words.ndim != 2 or words.shape[1] != n_words(n_items):
            raise ValueError(
                f"want (n_tx, {n_words(n_items)}) words for {n_items} items, got {words.shape}"
            )
        out.append(
            TransactionDB(
                packed=torch.from_numpy(words.view(np.int32)).to(torch.device(device)),
                n_items=int(n_items),
                n_tx=int(words.shape[0]),
            )
        )
    return out


def _float_sites(a, name: str, device: str | torch.device) -> torch.Tensor:
    a = np.array(a, dtype=np.float32)  # an owned, writable copy
    if a.ndim != 3:
        raise ValueError(f"want {name} as an (S, ·, D) array, got shape {a.shape}")
    return torch.from_numpy(a).to(torch.device(device))


def site_points_from_reference(xs: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """The JAX package's ``(S, n, D)`` site points -> the port's f32 tensor on ``device``."""
    return _float_sites(xs, "site points", device)


def init_centers_from_reference(centers: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """Per-site ``(S, k, D)`` initial centres drawn by the JAX package
    (``repro.core.kmeans.kmeans_plus_plus_init`` with each site's key) ->
    the port's f32 tensor on ``device``, for ``init_centers``."""
    return _float_sites(centers, "initial centres", device)
