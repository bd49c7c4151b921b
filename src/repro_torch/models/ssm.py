"""Linear-recurrence mixers: the chunked gated outer-product scan.

    h_t = exp(log_a_t) · h_{t-1} + g_t · k_t v_tᵀ        (state: (n, p) per head)
    y_t = q_t · h_t                                       (contract n)

This is the mLSTM matrix-memory recurrence (a = σ_f, g = the input gate,
k/v/q from projections, the normaliser an extra v-channel) and Mamba-2's
SSD recurrence.  The chunked evaluation (intra-chunk quadratic form plus an
inter-chunk state loop) follows the JAX package's ``repro.models.ssm``
step for step, with its roundings: the decays in f32, every product that
meets v cast to v's dtype.  All decay/log quantities stay ≤ 0 so every
exp() is ≤ 1.  Mamba-2 itself comes with its own slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gated_outer_scan(
    log_a: torch.Tensor,  # (B, S, H) ≤ 0
    gate: torch.Tensor,  # (B, S, H)
    k: torch.Tensor,  # (B, S, H, N)
    v: torch.Tensor,  # (B, S, H, P)
    q: torch.Tensor,  # (B, S, H, N)
    h0: torch.Tensor | None = None,  # (B, H, N, P)
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P), h_final (B, H, N, P))."""
    b, s, h = log_a.shape
    n, p = k.shape[-1], v.shape[-1]
    chunk = min(chunk, s)
    orig_s = s
    if s % chunk:  # pad tail steps with identity transitions (log_a=0,
        # gate=0): outputs for pads are discarded, the state is unchanged
        pad = chunk - s % chunk
        log_a = F.pad(log_a, (0, 0, 0, pad))
        gate = F.pad(gate, (0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        s += pad
    nc = s // chunk

    f32 = torch.float32
    la = log_a.to(f32).reshape(b, nc, chunk, h)
    g = gate.to(f32).reshape(b, nc, chunk, h)
    kc = k.reshape(b, nc, chunk, h, n)
    vc = v.reshape(b, nc, chunk, h, p)
    qc = q.reshape(b, nc, chunk, h, n)

    lcum = torch.cumsum(la, dim=2)  # (B, NC, L, H) ≤ 0 within chunk
    ltot = lcum[:, :, -1, :]  # (B, NC, H)

    # intra-chunk, all chunks at once:
    # S[t, s'] = exp(lcum_t - lcum_s') * g_s' * (q_t · k_s'),  s' ≤ t
    qk = torch.einsum("bclhn,bcmhn->bchlm", qc, kc)  # (B,NC,H,L,L)
    dec = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (B,NC,L,L,H) t,s'
    dec = dec.permute(0, 1, 4, 2, 3)  # (B,NC,H,L,L)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=v.device))
    w = torch.where(tri, torch.exp(torch.clamp(dec, max=0.0)), 0.0) * qk
    w = w * g.permute(0, 1, 3, 2)[:, :, :, None, :]  # gate at s'
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", w.to(v.dtype), vc)

    # inter-chunk loop over NC carrying h (B, H, N, P): the state injection
    # and the q·h readout per chunk, so no stacked per-chunk state exists
    if h0 is None:
        h0 = torch.zeros((b, h, n, p), dtype=v.dtype, device=v.device)
    inj_w = (torch.exp(ltot[:, :, None, :] - lcum) * g).to(v.dtype)  # (B,NC,L,H)
    q_dec = (torch.exp(lcum)[..., None] * qc.to(f32)).to(v.dtype)  # (B,NC,L,H,N)

    hprev = h0
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("blhn,bhnp->blhp", q_dec[:, c], hprev))
        inj_c = torch.einsum("blh,blhn,blhp->bhnp", inj_w[:, c], kc[:, c], vc[:, c])
        hprev = torch.exp(ltot[:, c])[..., None, None].to(hprev.dtype) * hprev + inj_c
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(b, s, h, p)
    return y[:, :orig_s], hprev


def gated_outer_step(
    log_a: torch.Tensor,  # (B, H)
    gate: torch.Tensor,  # (B, H)
    k: torch.Tensor,  # (B, H, N)
    v: torch.Tensor,  # (B, H, P)
    q: torch.Tensor,  # (B, H, N)
    h: torch.Tensor,  # (B, H, N, P)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the same recurrence, in the state's dtype."""
    hnew = torch.exp(log_a.to(torch.float32))[..., None, None].to(h.dtype) * h + (
        gate[..., None, None].to(h.dtype) * k[..., :, None] * v[..., None, :]
    )
    y = torch.einsum("bhn,bhnp->bhp", q, hnew)
    return y, hnew
