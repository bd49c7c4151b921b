"""The one traffic generator: token batches drawn from ``--seed`` by the
parameters of a mix file, so a mix is data and never code.

``TokenStream`` is a copy of ``repro_torch.data.pipeline.TokenStream``'s
arithmetic (numpy's generator seeded by (seed, step)): a batch is a pure
function of the seed and its index, the same on every run and on every
host.  Every batch of one seed has the mix's shape, so two seeds differ in
the ids alone, never in the work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TokenStream:
    vocab: int
    batch: int
    seq_len: int
    seed: int

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """``{"tokens", "labels"}`` int32 (batch, seq_len): uniform ids in
        [0, vocab), the labels the tokens shifted by one."""
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.vocab, size=(self.batch, self.seq_len + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def stream(config: dict, mix: dict, seed: int) -> TokenStream:
    """The stream of a mix (``batch``, ``seq_len``) over a configuration's
    vocabulary."""
    return TokenStream(vocab=int(config["model"]["vocab"]), batch=int(mix["batch"]), seq_len=int(mix["seq_len"]),
                       seed=int(seed))


class Reservoir:
    """``k`` of the calls a window makes, drawn from the seed uniformly over
    however many calls come (Algorithm R): the calls whose outputs the
    reference judges once the window has closed."""

    def __init__(self, seed: int, k: int):
        self.k = int(k)
        self.rng = np.random.default_rng((int(seed), 0x5A3))
        self.slots: list[int] = []
        self.seen = 0

    def offer(self, index: int) -> bool:
        """Call ``index`` was made: true if it is now judged (it may have
        taken another's place)."""
        self.seen += 1
        if len(self.slots) < self.k:
            self.slots.append(index)
            return True
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.slots[j] = index
            return True
        return False

    @property
    def indices(self) -> list[int]:
        return sorted(self.slots)
