"""Serve steps: prefill and decode, with the JAX package's signatures
(``step(model, batch, cache) -> (logits, cache)``).

Each step runs under ``torch.inference_mode()``: serving builds no autograd
graph.  The training steps come with the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(model, {"tokens": (B, S)}, cache)`` -> (logits of
    the last position (B, 1, V) f32, the cache after the prompt)."""

    def prefill_step(model, batch, cache):
        with torch.inference_mode():
            return T.prefill(cfg, model, batch["tokens"], cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_fn(model, {"token": (B, 1), "pos": int}, cache)`` ->
    (logits (B, 1, V) f32, the cache after the token)."""

    def decode_fn(model, batch, cache):
        with torch.inference_mode():
            return T.decode_step(cfg, model, batch["token"], batch["pos"], cache)

    return decode_fn
