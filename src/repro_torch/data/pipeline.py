"""Deterministic, restartable token batches.

The port of ``repro.data.pipeline``: the stream is a pure function of
(seed, step), so a restarted job resumes mid-stream exactly from the step
alone.  The numbers come from numpy's generator, so a batch equals the
JAX package's bit for bit.  ``place_batch``, the counterpart of the JAX
package's ``device_put_batch``, takes the whole batch on every rank and
distributes it over a ``DeviceMesh`` by the same logical-axis rules, each
rank keeping its block; the training entry draws ``batch_at`` on every
rank and places it so.  ``host_batch_at`` is the JAX package's stripe of
rows for one of several processes that each place only their own rows;
the port's entry does not call it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding import Rules, distribute


@dataclass
class TokenStream:
    """Synthetic LM token stream (stands in for a tokenized corpus reader;
    the interface — ``batch_at(step)`` pure in (seed, step) — is what
    restarts rely on).  With ``frontend_len`` each batch also carries
    ``"frontend"``, seeded normal embeddings (B, frontend_len, d_model)
    for a model with a stub frontend."""

    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    frontend_len: int = 0
    d_model: int = 0

    def batch_at(self, step: int) -> dict:
        """``{"tokens", "labels"}`` int32 (B, seq_len), labels the tokens
        shifted by one, and ``"frontend"`` f32 with ``frontend_len``."""
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.vocab, size=(self.global_batch, self.seq_len + 1), dtype=np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.frontend_len:
            out["frontend"] = rng.normal(0, 1, (self.global_batch, self.frontend_len, self.d_model)).astype(
                np.float32
            )
        return out

    def host_batch_at(self, step: int) -> dict:
        """This process's stripe of the global batch: rows ``rank::world``
        of a ``torch.distributed`` group when one is initialised, else the
        whole batch (the JAX package's multi-process layout).  Not an input
        of ``place_batch``, which takes the whole batch: the training entry
        calls ``batch_at``."""
        full = self.batch_at(step)
        if not (dist.is_available() and dist.is_initialized()):
            return full
        n, i = dist.get_world_size(), dist.get_rank()
        return {k: v[i::n] for k, v in full.items()}


def place_batch(batch: dict, device_mesh, rules: Rules, axes=("batch", "seq")) -> dict:
    """Place a host batch (the whole batch, the same arrays on every rank:
    ``TokenStream.batch_at``) onto a ``DeviceMesh`` as DTensors with
    rule-derived placements, each rank keeping its shard with nothing sent
    (a contiguous block of rows where the batch splits over ``data``, as
    ``device_put_batch`` gives each device): dim i of each array takes the
    logical axis ``axes[i]`` (later dims none), and
    ``sharding.to_placements`` of its pspec.  What is not an array (a
    decode step's ``pos``) stays as it is."""

    def put(x):
        t = torch.as_tensor(x)
        return distribute(t, tuple(axes[: t.ndim]) + (None,) * max(0, t.ndim - len(axes)), rules, device_mesh)

    return {k: put(v) if isinstance(v, (torch.Tensor, np.ndarray)) else v for k, v in batch.items()}
