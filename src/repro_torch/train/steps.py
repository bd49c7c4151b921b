"""Serve steps: prefill and decode, with the JAX package's signatures
(``step(model, batch, cache) -> (logits, cache)``).

Each step runs under ``torch.inference_mode()``: serving builds no autograd
graph.  Scoring, the forward half of the JAX package's train-step loss, is
``forward_train(..., return_hidden=True)`` then
``train.losses.chunked_softmax_ce``; for the MoE archs ``forward_train``
also returns the MoE layers' summed aux and z losses, which the JAX
package's train loss adds to the CE.  The training steps come with the
training slice.  The steps serve every arch of the port as they are: the
decode cache of zamba2 holds the shared attention block's K/V for each
group after the layers' caches (``transformer.init_cache``), and that of
seamless the cross K/V of the encoder's output in each decoder layer's.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, chunk: int = 1024):
    """``prefill_step(model, {"tokens": (B, S), "frontend": (B, F, D)},
    cache)`` -> (logits of the last position (B, 1, V) f32, the cache after
    the prompt).  ``"frontend"``, the stub frontend's precomputed
    embeddings, is optional: seamless's frames, which its encoder reads,
    or phi-3-vision's patches, which go in front of the tokens (the cache
    then counts them).  ``chunk`` is the chunked attention oracle's KV
    chunk."""

    def prefill_step(model, batch, cache):
        with torch.inference_mode():
            return T.prefill(cfg, model, batch["tokens"], cache, batch.get("frontend"), chunk=chunk)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_fn(model, {"token": (B, 1), "pos": int}, cache)`` ->
    (logits (B, 1, V) f32, the cache after the token)."""

    def decode_fn(model, batch, cache):
        with torch.inference_mode():
            return T.decode_step(cfg, model, batch["token"], batch["pos"], cache)

    return decode_fn
