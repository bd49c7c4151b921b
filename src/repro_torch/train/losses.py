"""Losses.  The CE is computed CHUNKED over the sequence so the full
(B, S, V) logits tensor never exists: at any one time only one chunk's
(B, chunk, V) f32 logits do, which is what the 256,000-token vocabulary of
gemma2 needs at 8,192 tokens.  Under autograd each chunk runs under
``torch.utils.checkpoint``: its logits are recomputed in the backward and
never stored, as the JAX package's ``@jax.checkpoint chunk_ce`` does
(stablelm's would be 6.6 GB of f32 at 4 x 4,096 tokens).

The port of ``repro.train.losses``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.transformer import logits_from


def _chunk_ce(cfg, model, h: torch.Tensor, lab: torch.Tensor):
    """(summed CE over the labelled tokens of one chunk f32, their count int32)."""
    lg = logits_from(cfg, model, h)  # (B, C, Vp) f32, padded ids masked
    mask = lab >= 0
    gold = torch.gather(lg, -1, lab.clamp(min=0).long()[..., None])[..., 0]
    ce = torch.where(mask, torch.logsumexp(lg, dim=-1) - gold, 0.0)
    return ce.sum(), mask.sum(dtype=torch.int32)


def chunked_softmax_ce(cfg, model, hidden: torch.Tensor, labels: torch.Tensor, chunk: int = 512):
    """hidden (B, S, D); labels (B, S) int with -1 = ignore.  Returns
    (mean_ce f32 scalar, n_tokens int32 scalar): the summed CE over the
    labelled tokens over their count (at least 1), the chunks' sums added
    in order."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:  # pad with ignored labels
        pad = chunk - s % chunk
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        s += pad
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c0 in range(0, s, chunk):
        h, lab = hidden[:, c0 : c0 + chunk], labels[:, c0 : c0 + chunk]
        if remat:
            ce, n = checkpoint(_chunk_ce, cfg, model, h, lab, use_reentrant=False)
        else:
            ce, n = _chunk_ce(cfg, model, h, lab)
        tot = tot + ce
        cnt = cnt + n
    return tot / torch.clamp(cnt.float(), min=1.0), cnt
