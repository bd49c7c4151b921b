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

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import apply_norm, softcap
from repro_torch.models.transformer import logits_from
from repro_torch.sharding import constrain, is_dtensor, local_offset, redistributed, use_weight


def _chunk_ce(cfg, model, h: torch.Tensor, lab: torch.Tensor):
    """(summed CE over the labelled tokens of one chunk f32, their count int32)."""
    if is_dtensor(h):
        return _chunk_ce_sharded(cfg, model, h, lab)
    lg = logits_from(cfg, model, h)  # (B, C, Vp) f32, padded ids masked
    mask = lab >= 0
    gold = torch.gather(lg, -1, lab.clamp(min=0).long()[..., None])[..., 0]
    ce = torch.where(mask, torch.logsumexp(lg, dim=-1) - gold, 0.0)
    return ce.sum(), mask.sum(dtype=torch.int32)


def _chunk_ce_sharded(cfg, model, h, lab):
    """``_chunk_ce`` of DTensor hidden states: the reference's constraints
    (hidden on ``batch``, the logits on (``batch``, None, ``vocab``)) with
    the logits' matmul, softcap and mask, and the CE, on each rank's local
    shards: its batch rows against its slice of the vocabulary.  Where the
    vocabulary is split, the max and the sum of exponentials reduce over
    its mesh dims, and each rank picks the labels that fall in its slice,
    0 elsewhere, summed there (the masked gather XLA partitions
    ``take_along_axis`` into); the logits are never gathered.  Local
    gradients flow back through ``to_local``'s Partial placements: the
    hidden states' over the vocabulary's ranks, the weight's over the
    batch's."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    h = apply_norm(cfg, model.final_norm, constrain(h, ("batch", None, None)))
    w = use_weight(model.embed).T if cfg.tie_embeddings else use_weight(model.lm_head)  # (D, Vp)
    mesh = h.device_mesh
    n = mesh.ndim
    vocab = [j for j in range(n) if w.placements[j].is_shard(1)]
    batch = [j for j in range(n) if j not in vocab and h.placements[j].is_shard(0)]
    h_pl = [Shard(0) if j in batch else Replicate() for j in range(n)]
    w_pl = [Shard(1) if j in vocab else Replicate() for j in range(n)]
    h, w = h.redistribute(mesh, h_pl), w.redistribute(mesh, w_pl)
    lab_l = redistributed(lab, mesh, h_pl).to_local()
    h_l = h.to_local(grad_placements=[Partial() if j in vocab else p for j, p in enumerate(h_pl)])
    w_l = w.to_local(grad_placements=[Partial() if j in batch else p for j, p in enumerate(w_pl)])
    lg = (h_l @ w_l.to(h_l.dtype)).float()  # (B_l, C, V_l)
    if cfg.final_softcap:
        lg = softcap(lg, cfg.final_softcap)
    v0 = local_offset(w, 1)
    if cfg.vocab_padded > cfg.vocab:
        ids = v0 + torch.arange(lg.shape[-1], device=lg.device)
        lg = torch.where(ids < cfg.vocab, lg, -1e30)
    mask = lab_l >= 0
    split = math.prod(mesh.size(j) for j in vocab) > 1
    if not split:
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, lab_l.clamp(min=0).long()[..., None])[..., 0]
    else:
        def over_vocab(t, op):  # reduce a per-rank (B_l, C) share over the vocabulary's ranks
            part = [op if j in vocab else p for j, p in enumerate(h_pl)]
            shape = (h.shape[0], *t.shape[1:])
            d = DTensor.from_local(t, mesh, part, shape=shape, stride=torch.empty(shape, device="meta").stride())
            return d.redistribute(mesh, h_pl).to_local()

        m = over_vocab(lg.amax(dim=-1).detach(), Partial("max"))
        lse = m + torch.log(over_vocab(torch.exp(lg - m[..., None]).sum(dim=-1), Partial()))
        idx = lab_l.long() - v0
        mine = (idx >= 0) & (idx < lg.shape[-1])
        gold = over_vocab(torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0] * mine,
                          Partial())
    ce = torch.where(mask, lse - gold, 0.0).sum()
    cnt = mask.sum(dtype=torch.int32)
    total = [Partial() if j in batch else Replicate() for j in range(n)]
    return (DTensor.from_local(ce, mesh, total, shape=(), stride=()),
            DTensor.from_local(cnt, mesh, total, shape=(), stride=()))


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
