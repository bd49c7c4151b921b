"""Plain PyTorch versions of the hand-written kernels.

They define the semantics the CUDA kernels are held to, and they are what
``ops`` runs for tensors on the CPU.  Support counts are held to exact
integer equality.  Packed words are int32 bit views of the uint32 bitmaps:
``(t & m) == m`` is bit-exact on int32, and torch's uint32 lacks bitwise
ops on the CPU.

The K-Means assignment follows the TPU kernel
(``repro/kernels/kmeans_assign.py:_kernel``), not the JAX package's own
oracle: the argmin is taken over the UNCLAMPED ``d²`` (ties to the lowest
index) and only the minimum is clamped at 0.  Its dot products are summed
over ``d = 0 .. D-1`` in order, one rounding per product and per sum,
which is the order the CUDA kernel uses: the two agree bit for bit.

The sLSTM scan follows the TPU kernel (``repro/kernels/slstm_cell.py``):
f32 state across the whole sequence, outputs rounded to wx's dtype.

The support count and the K-Means assignment also take a launch config
(``kernels/autotune.py``) and split their work as the CUDA launch does:
the count sums the word shares that the config's split gives, exactly;
the assignment runs ``threads × points`` points at a time, each point's
arithmetic unchanged.  No config changes a result.

Flash attention follows the TPU kernel (``repro/kernels/flash_attention.py``)
where it differs from the model's chunked oracle: f32 scores, state and
accumulator, p rounded to v's dtype only for the PV product.  It walks the
keys in the CUDA kernel's tile (``FLASH_BLOCK_K``), so both see the same
running maximum and differ only in the order of their sums.
"""

from __future__ import annotations

import math

import torch

BLOCK_C = 512  # candidates per chunk: bounds the (S, N, C) intermediate
FLASH_BLOCK_K = 64  # keys per tile, the CUDA flash kernel's (csrc/flash_attention.cu kBK)
FLASH_NEG = -1e30


def count_shares(n: int, split: int) -> list[tuple[int, int]]:
    """The row ranges [r0, r1) of the word shares into which the CUDA count
    splits ``n`` rows when a launch config asks for ``split`` shares: at
    least 32 words (1,024 rows) a share, so at most ceil(ceil(n/32) / 32)
    of them.  Split 0 (the card's heuristic, which counts the card's warps)
    is one share here."""
    nw = -(-n // 32)
    shares = max(1, min(split, -(-nw // 32)))
    words = -(-(-(-nw // shares)) // 32) * 32
    return [(32 * j, min(n, 32 * (j + words))) for j in range(0, nw, words)] or [(0, n)]


def support_count_sites_ref(
    tx: torch.Tensor, masks: torch.Tensor, block_c: int = BLOCK_C, config: tuple | None = None
) -> torch.Tensor:
    """tx (S, N, W), masks (S, C, W) int32 -> (S, C) int32 supports: for
    each site, the rows of ``tx`` that hold every bit of the mask.  With a
    launch config ``(threads, u, i, split)`` the rows are counted in the
    word shares of its split (:func:`count_shares`) and the shares summed."""
    s, n, w = tx.shape
    s2, c, w2 = masks.shape
    if s != s2 or w != w2:
        raise ValueError(f"shape mismatch: tx {tuple(tx.shape)} vs masks {tuple(masks.shape)}")
    out = torch.zeros((s, c), dtype=torch.int32, device=tx.device)
    for r0, r1 in count_shares(n, config[3]) if config is not None else [(0, n)]:
        part = tx[:, r0:r1]
        for c0 in range(0, c, block_c):
            mk = masks[:, c0 : c0 + block_c]  # (S, Cb, W)
            hit = torch.ones((s, r1 - r0, mk.shape[1]), dtype=torch.bool, device=tx.device)
            for ww in range(w):
                m = mk[:, None, :, ww]  # (S, 1, Cb)
                hit &= (part[:, :, ww, None] & m) == m
            out[:, c0 : c0 + block_c] += hit.sum(dim=1, dtype=torch.int32)
    return out


def support_count_prune_sites_ref(
    tx: torch.Tensor, masks: torch.Tensor, min_counts: torch.Tensor, config: tuple | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The site form plus per-site thresholds: min_counts (S,) int32 ->
    ``(counts (S, C) int32, counts >= min_counts[:, None])``."""
    counts = support_count_sites_ref(tx, masks, config=config)
    return counts, counts >= min_counts.to(counts.device, torch.int32)[:, None]


def support_count_ref(tx: torch.Tensor, masks: torch.Tensor, config: tuple | None = None) -> torch.Tensor:
    """tx (N, W), masks (C, W) int32 -> (C,) int32 supports."""
    return support_count_sites_ref(tx[None], masks[None], config=config)[0]


def support_count_prune_ref(
    tx: torch.Tensor, masks: torch.Tensor, min_count: int, config: tuple | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts (C,) int32, counts >= min_count)``."""
    counts = support_count_ref(tx, masks, config=config)
    return counts, counts >= int(min_count)


def vertical_bitmap_ref(tx: torch.Tensor) -> torch.Tensor:
    """The bit-sliced (vertical) layout the CUDA support count builds in its
    first stage: tx (S, N, W) int32 -> vt (S, 32·W, ceil(N/32)) int32, bit r
    of ``vt[s, i, j]`` is item i (bit i % 32 of word i // 32) of transaction
    32·j + r, zero for the rows past N."""
    s, n, w = tx.shape
    nw = -(-n // 32)
    shifts = torch.arange(32, device=tx.device)
    bits = ((tx[..., None] >> shifts) & 1).to(torch.uint8).reshape(s, n, 32 * w)  # (S, N, items)
    bits = torch.cat([bits, bits.new_zeros((s, nw * 32 - n, 32 * w))], dim=1).reshape(s, nw, 32, 32 * w)
    acc = torch.zeros((s, nw, 32 * w), dtype=torch.int64, device=tx.device)
    for r in range(32):
        acc |= bits[:, :, r].long() << r
    acc = torch.where(acc >= 2**31, acc - 2**32, acc)  # uint32 words as their int32 views
    return acc.to(torch.int32).transpose(1, 2).contiguous()


def _popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 value in [0, 2^32)."""
    x = words - ((words >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def support_count_vertical_sites_ref(
    vt: torch.Tensor, masks: torch.Tensor, n: int, block_c: int = BLOCK_C
) -> torch.Tensor:
    """Support counts from the vertical layout, as the CUDA count stage
    takes them: vt (S, 32·W, ceil(n/32)) from :func:`vertical_bitmap_ref`,
    masks (S, C, W) int32 -> (S, C) int32.  Each count starts from the
    valid-row bits (all ones but the last word's rows past n), ANDs the
    columns of the mask's items, and adds the popcounts.  Equal to
    :func:`support_count_sites_ref` on the tx that vt was made from."""
    s, items, nw = vt.shape
    w = masks.shape[2]
    if items != 32 * w or masks.shape[0] != s or nw != -(-n // 32):
        raise ValueError(f"shape mismatch: vt {tuple(vt.shape)} vs masks {tuple(masks.shape)}, n={n}")
    cols = vt.long() & 0xFFFFFFFF  # (S, items, NW) as uint32 values
    valid = torch.full((nw,), 0xFFFFFFFF, dtype=torch.int64, device=vt.device)
    if n % 32:
        valid[-1] = (1 << (n % 32)) - 1
    shifts = torch.arange(32, device=vt.device)
    out = torch.zeros((s, masks.shape[1]), dtype=torch.int32, device=vt.device)
    for c0 in range(0, masks.shape[1], block_c):
        mk = masks[:, c0 : c0 + block_c]
        has = ((mk[..., None] >> shifts) & 1).bool().reshape(s, mk.shape[1], items)  # (S, Cb, items)
        acc = valid.expand(s, mk.shape[1], nw).clone()
        for i in torch.nonzero(has.any(dim=(0, 1))).flatten().tolist():
            acc = torch.where(has[:, :, i, None], acc & cols[:, None, i], acc)
        out[:, c0 : c0 + block_c] = _popcount32(acc).sum(dim=2).to(torch.int32)
    return out


def dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Σ_d a[..., d] * b[..., d]`` (broadcast), summed over d in index
    order with one rounding per product and per sum (no fused
    multiply-add).  Every op is elementwise, so the result does not depend
    on the other dimensions' sizes: a site gets the same bits alone and in
    a batch of sites."""
    acc = a[..., 0] * b[..., 0]
    for d in range(1, a.shape[-1]):
        acc = acc + a[..., d] * b[..., d]
    return acc


def kmeans_assign_sites_ref(
    xs: torch.Tensor, centers_s: torch.Tensor, config: tuple | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """xs (S, N, D), centers (S, K, D) f32 -> (assign (S, N) int32,
    min_d2 (S, N) f32): ``d² = (‖x‖² + ‖c‖²) − 2·x·c`` per site, the
    argmin over the unclamped d² (first index on ties), then
    ``max(min d², 0)``.  With a launch config ``(threads, points)`` the
    points go ``threads × points`` at a time."""
    if config is not None:
        s, n, _ = xs.shape
        block = config[0] * config[1]
        assign = torch.empty((s, n), dtype=torch.int32, device=xs.device)
        mind2 = torch.empty((s, n), dtype=xs.dtype, device=xs.device)
        for n0 in range(0, n, block):
            assign[:, n0 : n0 + block], mind2[:, n0 : n0 + block] = kmeans_assign_sites_ref(
                xs[:, n0 : n0 + block], centers_s
            )
        return assign, mind2
    x2 = dot_last(xs, xs)  # (S, N)
    c2 = dot_last(centers_s, centers_s)  # (S, K)
    xc = dot_last(xs[:, :, None, :], centers_s[:, None, :, :])  # (S, N, K)
    d2 = (x2[:, :, None] + c2[:, None, :]) - 2.0 * xc
    assign = torch.argmin(d2, dim=-1)
    mind2 = torch.gather(d2, -1, assign[..., None])[..., 0]
    return assign.to(torch.int32), mind2.clamp(min=0.0)


def kmeans_assign_ref(
    x: torch.Tensor, centers: torch.Tensor, config: tuple | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, D), centers (K, D) f32 -> (assign (N,) int32, min_d2 (N,) f32)."""
    assign, mind2 = kmeans_assign_sites_ref(x[None], centers[None], config=config)
    return assign[0], mind2[0]


def slstm_scan_ref(
    wx: torch.Tensor,
    r: torch.Tensor,
    bias: torch.Tensor,
    state0: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The sLSTM recurrence over a whole sequence, one step at a time, as
    the TPU kernel computes it (``repro/kernels/slstm_cell.py:_kernel``):
    wx (B, S, H, 4P), R (H, P, 4P), bias (H, 4P), state0 = (c0, n0, h0)
    each (B, H, P) -> (hids (B, S, H, P), (cT, nT, hT)), all in wx's dtype.

    wx, R, bias and the initial state are cast to f32 and the state stays
    f32 across the whole sequence; per step
    ``z,i,f,o = split(wx_t + h@R + b)``, ``c = σ(f)c + σ(i)tanh(z)``,
    ``n = σ(f)n + σ(i)``, ``h = σ(o)c/max(n,1)``; ``hids[t]`` and the final
    state are cast to wx's dtype.  This is not the model's per-step cell
    (``models.xlstm._slstm_cell``), which rounds the state to the model
    dtype every step."""
    dt = wx.dtype
    b, s, nh, p4 = wx.shape
    p = p4 // 4
    r32, b32 = r.float(), bias.float()
    c, n, hid = (t.float() for t in state0)
    hids = torch.empty((b, s, nh, p), dtype=dt, device=wx.device)
    for t in range(s):
        rec = torch.einsum("bhp,hpq->bhq", hid, r32)
        g = wx[:, t].float() + rec + b32[None]
        z = torch.tanh(g[..., :p])
        i = torch.sigmoid(g[..., p : 2 * p])
        f = torch.sigmoid(g[..., 2 * p : 3 * p])
        o = torch.sigmoid(g[..., 3 * p :])
        c = f * c + i * z
        n = f * n + i
        hid = o * c / torch.clamp(n, min=1.0)
        hids[:, t] = hid.to(dt)
    return hids, (c.to(dt), n.to(dt), hid.to(dt))


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    cap: float = 0.0,
) -> torch.Tensor:
    """Forward attention as the TPU kernel computes it
    (``repro/kernels/flash_attention.py:_kernel``): q (B, Sq, H, Dh), k/v
    (B, Skv, Kv, Dh) with H % Kv == 0 -> (B, Sq, H, Dh) in q's dtype.
    Query head h reads KV head ``h // (H/Kv)``; positions run from 0 on
    both axes.

    Per key tile of ``FLASH_BLOCK_K``: ``s = (f32(q)·scale)·f32(k)ᵀ`` in f32,
    ``tanh(s/cap)·cap`` when ``cap``; masked (``q < k`` when causal,
    ``q - k >= window`` when ``window``) to -1e30; ``m' = max(m, max s)``,
    ``p = exp(s - m')`` (0 where ``m' <= -5e29``), ``l = l·exp(m - m') +
    Σp`` over the f32 p, ``acc = acc·exp(m - m') + round_v(p)·f32(v)``;
    then ``acc / max(l, 1e-30)`` rounded to q's dtype (0 for a row with no
    visible key).  Scores exist one tile at a time: (B, Kv, G, Sq, FLASH_BLOCK_K)."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh)
    qf = (q.float() * scale).reshape(b, sq, kvh, g, dh)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, kvh, g, sq), FLASH_NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, sq, dh), dtype=torch.float32, device=q.device)
    for k0 in range(0, skv, FLASH_BLOCK_K):
        kc, vc = k[:, k0 : k0 + FLASH_BLOCK_K], v[:, k0 : k0 + FLASH_BLOCK_K]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.float())
        if cap:
            s = torch.tanh(s / cap) * cap
        k_pos = torch.arange(k0, k0 + kc.shape[1], device=q.device)[None, :]
        mask = torch.ones((sq, kc.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window:
            mask = mask & (q_pos - k_pos < window)
        s = torch.where(mask, s, FLASH_NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        # rows with no visible key yet: p exactly 0 (m_new is still -1e30)
        p = torch.where((m_new > FLASH_NEG / 2)[..., None], p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vc.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)
