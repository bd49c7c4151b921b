"""State carried across from the JAX package.

GFM has no weights: its state is the packed transaction DB, and its
results are plain Python dicts already.  The JAX package keeps each
site's words as ``(n_tx, W)`` uint32 (``repro.core.apriori.TransactionDB
.packed``); handed over as numpy arrays, they become the port's DBs with
the same bits, so both packages mine exactly the same data.
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
