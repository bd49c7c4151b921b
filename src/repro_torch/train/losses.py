"""Losses, forward only (scoring).  The CE is computed CHUNKED over the
sequence so the full (B, S, V) logits tensor never exists: at any one time
only one chunk's (B, chunk, V) f32 logits do, which is what the
256,000-token vocabulary of gemma2 needs at 8,192 tokens.

The port of ``repro.train.losses``; the backward comes with training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.transformer import logits_from


def chunked_softmax_ce(cfg, model, hidden: torch.Tensor, labels: torch.Tensor, chunk: int = 512):
    """hidden (B, S, D); labels (B, S) int with -1 = ignore.  Returns
    (mean_ce f32 scalar, n_tokens int32 scalar): the summed CE over the
    labelled tokens over their count (at least 1)."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:  # pad with ignored labels
        pad = chunk - s % chunk
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        s += pad
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c0 in range(0, s, chunk):
        lab = labels[:, c0 : c0 + chunk]
        lg = logits_from(cfg, model, hidden[:, c0 : c0 + chunk])  # (B, C, Vp) f32, padded ids masked
        mask = lab >= 0
        gold = torch.gather(lg, -1, lab.clamp(min=0).long()[..., None])[..., 0]
        ce = torch.where(mask, torch.logsumexp(lg, dim=-1) - gold, 0.0)
        del lg
        tot = tot + ce.sum()
        cnt = cnt + mask.sum(dtype=torch.int32)
    return tot / torch.clamp(cnt.float(), min=1.0), cnt
