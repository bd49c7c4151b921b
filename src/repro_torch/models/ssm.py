"""Linear-recurrence mixers: the chunked gated outer-product scan.

    h_t = exp(log_a_t) · h_{t-1} + g_t · k_t v_tᵀ        (state: (n, p) per head)
    y_t = q_t · h_t                                       (contract n)

This is the mLSTM matrix-memory recurrence (a = σ_f, g = the input gate,
k/v/q from projections, the normaliser an extra v-channel) and Mamba-2's
SSD recurrence.  The chunked evaluation (intra-chunk quadratic form plus an
inter-chunk state loop) follows the JAX package's ``repro.models.ssm``
step for step, with its roundings: the decays in f32, every product that
meets v cast to v's dtype.  All decay/log quantities stay ≤ 0 so every
exp() is ≤ 1.

Mamba-2's mixer sits on the scan: a = exp(Δ·A), g = Δ, k = B, v = x,
q = C, after a depthwise causal conv of x, B and C.  The conv keeps the
reference's four-tap loop, which rounds in x's dtype at every tap
(``F.conv1d`` would accumulate in f32); Δ is the softplus in f32 as
``logaddexp(x, 0)``, the reference's formula.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm, spec
from repro_torch.sharding import constrain, local_by_roles


_SEQ = {"batch": 0, "heads": 2}  # (B, S, H, ...) operands
_STATE = {"batch": 0, "heads": 1}  # (B, H, ...) operands


def gated_outer_scan(
    log_a: torch.Tensor,  # (B, S, H) ≤ 0
    gate: torch.Tensor,  # (B, S, H)
    k: torch.Tensor,  # (B, S, H, N)
    v: torch.Tensor,  # (B, S, H, P)
    q: torch.Tensor,  # (B, S, H, N)
    h0: torch.Tensor | None = None,  # (B, H, N, P)
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P), h_final (B, H, N, P)).  Batch rows and
    heads are independent: DTensor operands run on each rank's own, placed
    as ``v`` is (its heads on ``ssm_inner``'s mesh axis)."""
    return local_by_roles(
        lambda *a: _gated_outer_scan(*a, chunk=chunk), (log_a, gate, k, v, q, h0),
        (_SEQ, _SEQ, _SEQ, _SEQ, _SEQ, None if h0 is None else _STATE), (_SEQ, _STATE), lead=3)


def _gated_outer_scan(log_a, gate, k, v, q, h0, chunk: int):
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
    """Single decode step of the same recurrence, in the state's dtype (on
    each rank's batch rows and heads, as ``gated_outer_scan``)."""
    return local_by_roles(_gated_outer_step, (log_a, gate, k, v, q, h), (_STATE,) * 6, (_STATE, _STATE), lead=3)


def _gated_outer_step(log_a, gate, k, v, q, h):
    hnew = torch.exp(log_a.to(torch.float32))[..., None, None].to(h.dtype) * h + (
        gate[..., None, None].to(h.dtype) * k[..., :, None] * v[..., None, :]
    )
    y = torch.einsum("bhn,bhnp->bhp", q, hnew)
    return y, hnew


# ---------------------------------------------------------------------------
# Causal depthwise conv (mamba's local conv)
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (W, C) depthwise causal conv, one tap at a time in
    x's dtype; DTensor operands on each rank's own batch rows and
    channels (the pad along the sequence has no DTensor strategy on every
    torch release)."""
    return local_by_roles(_causal_conv, (x, w), ({"batch": 0, "ch": 2}, {"ch": 1}), ({"batch": 0, "ch": 2},))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    wlen = w.shape[0]
    pad = F.pad(x, (0, 0, wlen - 1, 0))
    out = torch.zeros_like(x)
    for i in range(wlen):
        out = out + pad[:, i : i + x.shape[1], :] * w[i][None, None, :]
    return out


def causal_conv_step(x_new: torch.Tensor, state: torch.Tensor, w: torch.Tensor):
    """x_new (B, C); state (B, W-1, C) past inputs; returns (y (B, C), state')."""
    full = torch.cat([state, x_new[:, None, :]], dim=1)  # (B, W, C)
    y = torch.einsum("bwc,wc->bc", full, w)
    return y, full[:, 1:, :]


# ---------------------------------------------------------------------------
# Mamba-2 mixer block
# ---------------------------------------------------------------------------


def _dims(cfg):
    ss = cfg.ssm
    d_in = ss.expand * cfg.d_model
    return ss, d_in, d_in // ss.head_dim


def mamba2_spec(cfg) -> dict:
    ss, d_in, h = _dims(cfg)
    d = cfg.d_model
    gn = ss.d_state  # n_groups = 1
    return {
        "w_z": spec((d, d_in), ("embed", "ssm_inner")),
        "w_x": spec((d, d_in), ("embed", "ssm_inner")),
        "w_B": spec((d, gn), ("embed", "ssm_state")),
        "w_C": spec((d, gn), ("embed", "ssm_state")),
        "w_dt": spec((d, h), ("embed", "ssm_heads")),
        "conv_x": spec((ss.d_conv, d_in), ("conv", "ssm_inner")),
        "conv_B": spec((ss.d_conv, gn), ("conv", "ssm_state")),
        "conv_C": spec((ss.d_conv, gn), ("conv", "ssm_state")),
        "A_log": spec((h,), ("ssm_heads",)),
        "D": spec((h,), ("ssm_heads",)),
        "dt_bias": spec((h,), ("ssm_heads",)),
        "out_norm": {"scale": spec((d_in,), ("norm_scale",))},
        "w_out": spec((d_in, d), ("ssm_inner", "embed")),
    }


def _softplus_dt(p, xw_dt: torch.Tensor) -> torch.Tensor:
    """Δ = softplus(x·w_dt + dt_bias) in f32, as ``jax.nn.softplus``."""
    u = xw_dt.float() + p["dt_bias"].float()
    return torch.logaddexp(u, torch.zeros_like(u))


def _decay(p) -> torch.Tensor:
    return -torch.exp(p["A_log"].float())  # (H,) < 0


def _readout(p, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The skip through D, the gate silu(z), the norm and the out projection."""
    y = y + p["D"].to(y.dtype)[..., :, None] * xh
    y = y.reshape(*z.shape)
    y = rms_norm(y * F.silu(z), p["out_norm"]["scale"])
    return y @ p["w_out"].to(dt)


def apply_mamba2(cfg, p, x: torch.Tensor, h0: torch.Tensor | None = None):
    """Full-sequence mixer, x (B, S, D).  Returns (y (B, S, D), the decode
    cache: the final state and the last W-1 inputs of each conv)."""
    ss, d_in, h = _dims(cfg)
    b, s, _ = x.shape
    dt_ = x.dtype
    z = constrain(x @ p["w_z"].to(dt_), ("batch", "seq", "ssm_inner"))
    pre = {name: x @ p[f"w_{name}"].to(dt_) for name in ("x", "B", "C")}  # before the conv
    pre["x"] = constrain(pre["x"], ("batch", "seq", "ssm_inner"))
    xi, bm, cm = (F.silu(causal_conv(pre[n], p[f"conv_{n}"].to(dt_))) for n in ("x", "B", "C"))
    delta = _softplus_dt(p, x @ p["w_dt"].to(dt_))  # (B, S, H)
    log_a = delta * _decay(p)[None, None, :]
    xh = xi.reshape(b, s, h, ss.head_dim)
    kb = bm[:, :, None, :].expand(b, s, h, ss.d_state)
    qc = cm[:, :, None, :].expand(b, s, h, ss.d_state)
    y, h_fin = gated_outer_scan(log_a, delta, kb, xh, qc, h0=h0, chunk=ss.chunk)
    out = _readout(p, y, xh, z, dt_)
    tail = ss.d_conv - 1
    cache = {"h": h_fin, **{f"conv_{n}": pre[n][:, s - tail :, :] for n in ("x", "B", "C")}}
    return out, cache


def mamba2_decode(cfg, p, x: torch.Tensor, cache: dict):
    """x (B, 1, D) single-token step; returns (y (B, 1, D), cache')."""
    ss, d_in, h = _dims(cfg)
    b = x.shape[0]
    dt_ = x.dtype
    xt = x[:, 0, :]
    z = xt @ p["w_z"].to(dt_)
    conv, state = {}, {}
    for n in ("x", "B", "C"):
        conv[n], state[f"conv_{n}"] = causal_conv_step(
            xt @ p[f"w_{n}"].to(dt_), cache[f"conv_{n}"], p[f"conv_{n}"].to(dt_))
    xi = F.silu(conv["x"]).reshape(b, h, ss.head_dim)
    bm = F.silu(conv["B"])[:, None, :].expand(b, h, ss.d_state)
    cm = F.silu(conv["C"])[:, None, :].expand(b, h, ss.d_state)
    delta = _softplus_dt(p, xt @ p["w_dt"].to(dt_))  # (B, H)
    y, hnew = gated_outer_step(delta * _decay(p)[None, :], delta, bm, xi, cm, cache["h"])
    out = _readout(p, y, xi, z, dt_)[:, None, :]
    return out, {"h": hnew, **state}


def mamba2_cache_spec(cfg, batch: int) -> dict:
    """The decode state of one layer, in ``cfg.dtype``: h (B, H, N, P) and
    the last W-1 inputs of the three convs."""
    ss, d_in, h = _dims(cfg)
    dt = cfg.dtype
    tail = ss.d_conv - 1
    return {
        "h": spec((batch, h, ss.d_state, ss.head_dim), ("batch", "ssm_heads", "ssm_state", None), dt),
        "conv_x": spec((batch, tail, d_in), ("batch", None, "ssm_inner"), dt),
        "conv_B": spec((batch, tail, ss.d_state), ("batch", None, "ssm_state"), dt),
        "conv_C": spec((batch, tail, ss.d_state), ("batch", None, "ssm_state"), dt),
    }
