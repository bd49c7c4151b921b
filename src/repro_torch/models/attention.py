"""GQA attention: the chunked online-softmax oracle for train and prefill,
the flash kernel for full-sequence attention when ``cfg.flash_kernel`` is
set, and cached single-token decode, with the sliding window and the logit
softcap.

The port of ``repro.models.attention``.  ``chunked_attention`` keeps the
JAX package's numerics: q is scaled and cast back to its dtype, scores are
f32 with the softcap in f32, padded keys sit at ``PAD_POS``, each row is
guarded per chunk, and the accumulator is in q's dtype (bf16 in a bf16
model).  The flash kernel (``kernels.ops.flash_attention``) instead keeps
an f32 accumulator, as the Pallas kernel does; each path is held to its
own JAX counterpart.  Scores are never formed at (Sq, Skv): the KV axis
goes in chunks.  On a mesh every attention core (the oracle, the flash
kernel, decode) runs on each rank's own batch rows and heads
(``sharding.local_heads``), with no collective.  ``attention`` also serves the encoder (non-causal) and
the encoder-decoder's cross-attention (K/V from the encoder's output, no
RoPE, non-causal, Sq ≠ Skv).  With ``cfg.qk_norm`` a self-attention's q
and k go through their own norms over the head dim after the projection
and before RoPE (``q_norm``, ``k_norm``); a cross-attention has neither.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_norm, apply_rope, norm_spec, softcap, spec
from repro_torch.sharding import constrain, is_dtensor, local_heads, local_offset, redistributed

NEG = -1e30
PAD_POS = 1 << 29  # sentinel position for padded KV slots (always masked)


def attn_spec(cfg, cross: bool = False) -> dict:
    """The projections of one attention, and with ``cfg.qk_norm`` the
    norms of q and k; ``cross`` for the encoder-decoder's cross-attention,
    which has the four projections only, as in the JAX package."""
    d = cfg.d_model
    p = {
        "wq": spec((d, cfg.n_heads, cfg.head_dim), ("embed", "heads", "head_dim")),
        "wk": spec((d, cfg.n_kv_heads, cfg.head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": spec((d, cfg.n_kv_heads, cfg.head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": spec((cfg.n_heads, cfg.head_dim, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = norm_spec(cfg, cfg.head_dim)
        p["k_norm"] = norm_spec(cfg, cfg.head_dim)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul, contiguous (B, S, H, Dh)."""
    d, h, dk = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * dk)).view(*x.shape[:2], h, dk)


def _project_qkv(cfg, p, x: torch.Tensor, kv_x: torch.Tensor | None = None):
    """q from x; k and v from ``kv_x`` (x when None); q and k normed over
    the head dim where ``p`` has ``q_norm`` (a self-attention with
    ``cfg.qk_norm``)."""
    kv_x = x if kv_x is None else kv_x
    q = constrain(_heads(x, p["wq"]), ("batch", "seq", "heads", None))
    k = constrain(_heads(kv_x, p["wk"]), ("batch", "seq", "kv_heads", None))
    v = constrain(_heads(kv_x, p["wv"]), ("batch", "seq", "kv_heads", None))
    if cfg.qk_norm and "q_norm" in p:
        q = apply_norm(cfg, p["q_norm"], q)
        k = apply_norm(cfg, p["k_norm"], k)
    return q, k, v


def _out_proj(p, out: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")``: (B, S, H, Dh) through ``wo``; on a mesh
    the sum over the sharded heads is reduced here, before a post-norm."""
    h, dk, d = p["wo"].shape
    return constrain(out.reshape(*out.shape[:2], h * dk) @ p["wo"].to(dt).reshape(h * dk, d), ("batch", "seq", None))


def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, Dh) -> (B, S, Kv, G, Dh) splitting query heads into KV groups."""
    b, s, h, dh = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, dh)


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, Kv, G, Dh) — grouped query heads
    k: torch.Tensor,  # (B, Sk, Kv, Dh)
    v: torch.Tensor,  # (B, Sk, Kv, Dh)
    q_pos: torch.Tensor,  # (Sq,) int
    k_pos: torch.Tensor,  # (Sk,) int
    causal: bool,
    window: int = 0,
    cap: float = 0.0,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over the KV axis in chunks; returns
    (B, Sq, Kv, G, Dh) in q's dtype."""
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    chunk = min(chunk, sk)
    if sk % chunk:  # pad KV to a chunk multiple; sentinel positions mask out
        pad = chunk - sk % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.cat([k_pos, torch.full((pad,), PAD_POS, dtype=k_pos.dtype, device=k_pos.device)])
        sk += pad
    qf = (q * scale).to(q.dtype)
    # a window >= the (padded) KV length masks nothing beyond causality
    use_window = bool(window) and window < sk

    def body(m, den, acc, kc, vc, kp):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.to(qf.dtype)).float()  # (B, Kv, G, Sq, C)
        if cap:
            s = softcap(s, cap)
        mask = (kp[None, :] < PAD_POS).expand(sq, kp.shape[0])  # padded KV slots never attend
        if causal:
            mask = mask & (q_pos[:, None] >= kp[None, :])
        if use_window:
            mask = mask & (q_pos[:, None] - kp[None, :] < window)
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]).to(vc.dtype)
        # the per-row guard against wholly masked chunks (future causal
        # chunks, all-pad chunks, out-of-window chunks)
        kp_max_real = torch.where(kp < PAD_POS, kp, -1).max()
        row_valid = (kp[0] < PAD_POS).expand(sq)
        if causal:
            row_valid = row_valid & (q_pos >= kp[0])
        if use_window:
            row_valid = row_valid & (q_pos - kp_max_real < window)
        p = p * row_valid[:, None].to(p.dtype)
        corr = torch.exp(m - m_new)
        den = den * corr + p.float().sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        return m_new, den, acc

    # under autograd each chunk is checkpointed, as the JAX package's
    # @jax.checkpoint body: its scores and probabilities are recomputed in
    # the backward, never stored across the KV loop (memory linear in S)
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    m = torch.full((b, kvh, g, sq), NEG, dtype=torch.float32, device=q.device)
    den = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, dh), dtype=q.dtype, device=q.device)
    for c0 in range(0, sk, chunk):
        kc, vc, kp = k[:, c0 : c0 + chunk], v[:, c0 : c0 + chunk], k_pos[c0 : c0 + chunk]
        if remat:
            m, den, acc = checkpoint(body, m, den, acc, kc, vc, kp, use_reentrant=False)
        else:
            m, den, acc = body(m, den, acc, kc, vc, kp)
    out = acc / torch.clamp(den, min=1e-30)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4)  # (B, Kv, G, Sq, Dh) -> (B, Sq, Kv, G, Dh)


def attention(
    cfg,
    p,
    x: torch.Tensor,  # (B, Sq, D)
    q_pos: torch.Tensor,  # (Sq,)
    *,
    causal: bool = True,
    window: int = 0,
    kv_x: torch.Tensor | None = None,  # cross-attention memory (B, Sk, D)
    kv_pos: torch.Tensor | None = None,  # its positions (Sk,); q_pos when None
    rope: bool = True,
    chunk: int = 1024,
) -> torch.Tensor:
    """Full-sequence attention: train, scoring and prefill's encoder and
    cross-attention.  K/V come from ``kv_x`` when given (x otherwise);
    RoPE only with ``rope``.  With ``cfg.flash_kernel`` it goes through
    ``ops.flash_attention_sharded`` (``ops.flash_attention`` on each rank's
    shards of DTensors; the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors) with ``causal`` as given; positions must then
    run from 0 without gaps on both axes.  Otherwise the chunked oracle,
    with ``kv_pos`` as the keys' positions."""
    q, k, v = _project_qkv(cfg, p, x, kv_x)
    kp = q_pos if kv_pos is None else kv_pos
    if rope:
        q = apply_rope(q, q_pos[None, :], cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, kp[None, :], cfg.rope_theta, cfg.rope_pct)
    if cfg.flash_kernel:
        out = ops.flash_attention_sharded(q, k, v, causal=causal, window=window, cap=cfg.attn_softcap)
    else:
        out = local_heads(lambda q, k, v: _chunked(q, k, v, q_pos, kp, causal=causal, window=window,
                                                   cap=cfg.attn_softcap, chunk=chunk), q, k, v)
    return _out_proj(p, out, x.dtype)


def _chunked(q, k, v, q_pos, k_pos, **kw) -> torch.Tensor:
    """``chunked_attention`` on ungrouped q (B, Sq, H, Dh) -> (B, Sq, H, Dh)."""
    b, s, h, dh = q.shape
    return chunked_attention(_grouped(q, k.shape[2]), k, v, q_pos, k_pos, **kw).reshape(b, s, h, dh)


def attention_with_cache(
    cfg,
    p,
    x: torch.Tensor,  # (B, Sq, D)
    q_pos: torch.Tensor,  # (Sq,)
    *,
    window: int = 0,
    chunk: int = 1024,
):
    """Prefill: causal attention through the chunked oracle, and the K/V
    of the sequence (B, Sq, Kv, Dh) for the cache."""
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, q_pos[None, :], cfg.rope_theta, cfg.rope_pct)
    k = apply_rope(k, q_pos[None, :], cfg.rope_theta, cfg.rope_pct)
    out = local_heads(lambda q, k, v: _chunked(q, k, v, q_pos, q_pos, causal=True, window=window,
                                               cap=cfg.attn_softcap, chunk=chunk), q, k, v)
    return _out_proj(p, out, x.dtype), {"k": k, "v": v}


def decode_attention(
    cfg,
    p,
    x: torch.Tensor,  # (B, 1, D)
    pos,  # the current position (cache entries < pos are live)
    cache: dict,  # {"k", "v"}: (B, S, Kv, Dh)
    *,
    window: int = 0,
):
    """Single-token decode against a pre-allocated cache: the new K/V is
    written at ``pos`` IN PLACE (the JAX package returns an updated copy;
    a copy of every layer's cache a token is what the port saves), then a
    full softmax over the cache with keys ``kpos <= pos`` and, with a
    window, ``pos - kpos < window``.  Returns (out (B, 1, D), cache)."""
    pos = int(pos)
    s_max = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(cfg, p, x)
    pos_arr = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_arr, cfg.rope_theta, cfg.rope_pct)
    k_new = apply_rope(k_new, pos_arr, cfg.rope_theta, cfg.rope_pct)
    k, v = cache["k"], cache["v"]
    _write_at(k, pos, k_new)
    _write_at(v, pos, v_new)

    def core(q, k, v):
        b, _, h, dh = q.shape
        qg = _grouped(q, k.shape[2])  # (B, 1, Kv, G, Dh)
        s = torch.einsum("bqhgd,bkhd->bhgqk", (qg * (1.0 / math.sqrt(dh))).to(qg.dtype), k).float()
        if cfg.attn_softcap:
            s = softcap(s, cfg.attn_softcap)
        kpos = torch.arange(s_max, device=q.device)
        mask = kpos <= pos
        if window:
            mask = mask & (pos - kpos < window)
        s = torch.where(mask, s, NEG)
        pr = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bhgqd", pr.to(v.dtype), v)
        return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, dh)

    return _out_proj(p, local_heads(core, q, k, v), x.dtype), {"k": k, "v": v}


def _write_at(cache: torch.Tensor, pos: int, new: torch.Tensor) -> None:
    """``cache[:, pos] = new[:, 0]`` in place.  A DTensor cache writes its
    local shard, the new entry placed as the cache is (its one position
    whole); where the cache's positions are sharded (``kv_seq``) only the
    rank that holds ``pos`` writes."""
    from torch.distributed.tensor import Replicate, Shard

    if is_dtensor(cache):
        new = redistributed(new, cache.device_mesh, [Replicate() if p == Shard(1) else p for p in cache.placements])
        local = cache.to_local()
        pos -= local_offset(cache, 1)
        if not 0 <= pos < local.shape[1]:
            return
        cache, new = local, new.to_local()
    cache[:, pos] = new[:, 0].to(cache.dtype)
