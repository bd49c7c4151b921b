"""xLSTM blocks: mLSTM (matrix memory, a chunked linear recurrence on the
gated outer-product scan) and sLSTM (scalar memory with recurrent gate
connections, sequential in time).

The port of ``repro.models.xlstm``, with its numerics: sigmoid input gates
and the mLSTM normaliser carried as one extra v-channel of the scan, so
``y = (q·C)/max(|q·n|, 1)``; the gates in f32.  The sLSTM has two paths,
each following its JAX counterpart: with ``cfg.slstm_kernel`` the
recurrence runs in the hand-written kernel (``kernels.ops.slstm_scan``, f32
state over the whole sequence, its final state cast to the model dtype);
otherwise the per-step cell ``_slstm_cell``, which rounds the state to the
model dtype every step.  Decode always takes the cell, as in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm, spec
from repro_torch.models.ssm import gated_outer_scan, gated_outer_step
from repro_torch.sharding import constrain, local_by_roles

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg):
    d_in = 2 * cfg.d_model  # proj factor 2
    h = cfg.n_heads
    p = d_in // h  # value head dim
    n = max(p // 2, 8)  # qk head dim (xLSTM: qk = v/2)
    return d_in, h, p, n


def mlstm_spec(cfg) -> dict:
    """Parameters per mLSTM block: a fused up-projection d -> 2*d_in (x_in
    and gate z) and block-diagonal per-head q/k/v over the inner heads."""
    d = cfg.d_model
    d_in, h, p, n = _mlstm_dims(cfg)
    return {
        "w_in": spec((d, 2 * d_in), ("embed", "mlstm_inner")),
        "w_q": spec((h, p, n), ("heads", "mlstm_p", None)),
        "w_k": spec((h, p, n), ("heads", "mlstm_p", None)),
        "w_v": spec((h, p, p), ("heads", "mlstm_p", None)),
        "w_if": spec((d_in, h, 2), ("mlstm_inner", "heads", None)),
        "if_bias": spec((h, 2), ("heads", None)),
        "out_norm": {"scale": spec((d_in,), ("norm_scale",))},
        "w_out": spec((d_in, d), ("mlstm_inner", "embed")),
    }


def _mlstm_qkvg(cfg, p_, x: torch.Tensor):
    dt = x.dtype
    b, s, _ = x.shape
    d_in, h, p, n = _mlstm_dims(cfg)
    w_in = p_["w_in"].to(dt)
    if _split_over_ranks(w_in, 1):
        # on a mesh the halves of w_in's sharded columns would land on
        # different ranks: re-lay the weight so each rank holds its share
        # of both (an all-to-all of the weight), then two local products
        w3 = constrain(w_in.reshape(w_in.shape[0], 2, d_in), (None, None, "mlstm_inner"))
        xi = constrain(x @ w3[:, 0], ("batch", "seq", "mlstm_inner"))
        z = constrain(x @ w3[:, 1], ("batch", "seq", "mlstm_inner"))
    else:
        up = constrain(x @ w_in, ("batch", "seq", "mlstm_inner"))  # (B,S,2*d_in)
        xi, z = up[..., :d_in], up[..., d_in:]
    xh = xi.reshape(b, s, h, p)  # per-head view for block-diagonal qkv
    q = torch.einsum("bshp,hpn->bshn", xh, p_["w_q"].to(dt)) / math.sqrt(float(n))
    k = torch.einsum("bshp,hpn->bshn", xh, p_["w_k"].to(dt)) / math.sqrt(float(n))
    v = torch.einsum("bshp,hpq->bshq", xh, p_["w_v"].to(dt))
    gates = torch.einsum("bsd,dhg->bshg", xi, p_["w_if"].to(dt)).float()
    # on a mesh the sum over the sharded inner dim is reduced onto the heads here
    gates = constrain(gates, ("batch", "seq", "heads", None)) + p_["if_bias"].float()[None, None]
    i_gate = torch.sigmoid(gates[..., 0])  # (B,S,H)
    # ≤ 0; logsigmoid's backward has no DTensor strategy: each rank's own elements
    log_f = local_by_roles(F.logsigmoid, (gates[..., 1],), ({"b": 0, "s": 1, "h": 2},), ({"b": 0, "s": 1, "h": 2},))
    return z, q, k, v, i_gate, log_f


def _split_over_ranks(t: torch.Tensor, dim: int) -> bool:
    """Whether DTensor ``t`` splits ``dim`` over more than one rank."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return False
    sizes = tuple(t.device_mesh.size(i) for i in range(t.device_mesh.ndim))
    return math.prod(sizes[j] for j, p in enumerate(t.placements) if p == Shard(dim)) > 1


def _mlstm_readout(cfg, p_, y_aug: torch.Tensor, z: torch.Tensor, b: int, s: int) -> torch.Tensor:
    # y_aug: (B,S,H,P+1), the last channel the normaliser q·n
    y = y_aug[..., :-1]
    denom = torch.clamp(torch.abs(y_aug[..., -1:]), min=1.0)
    y = (y / denom).reshape(b, s, -1)
    y = rms_norm(y, p_["out_norm"]["scale"]) * F.silu(z)
    return y @ p_["w_out"].to(z.dtype)


def _with_normaliser(v: torch.Tensor) -> torch.Tensor:
    ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    return torch.cat([v, ones], dim=-1)


def apply_mlstm(cfg, p_, x: torch.Tensor, h0: torch.Tensor | None = None, chunk: int = 128):
    """Full-sequence mLSTM mixer.  Returns (y (B,S,D), cache {h})."""
    b, s, _ = x.shape
    z, q, k, v, i_gate, log_f = _mlstm_qkvg(cfg, p_, x)
    y_aug, h_fin = gated_outer_scan(log_f, i_gate, k, _with_normaliser(v), q, h0=h0, chunk=chunk)
    return _mlstm_readout(cfg, p_, y_aug, z, b, s), {"h": h_fin}


def mlstm_decode(cfg, p_, x: torch.Tensor, cache: dict):
    b = x.shape[0]
    z, q, k, v, i_gate, log_f = _mlstm_qkvg(cfg, p_, x)
    v_aug = _with_normaliser(v)
    y_aug, hnew = gated_outer_step(log_f[:, 0], i_gate[:, 0], k[:, 0], v_aug[:, 0], q[:, 0], cache["h"])
    out = _mlstm_readout(cfg, p_, y_aug[:, None], z, b, 1)
    return out, {"h": hnew}


def mlstm_cache_spec(cfg, batch: int) -> dict:
    d_in, h, p, n = _mlstm_dims(cfg)
    return {
        "h": spec((batch, h, n, p + 1), ("batch", "heads", "mlstm_qk", None), cfg.dtype),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_spec(cfg) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    p = d // h
    return {
        "w": spec((d, h, 4 * p), ("embed", "heads", None)),  # z,i,f,o stacked
        "r": spec((h, p, 4 * p), ("heads", "slstm_p", None)),  # block-diag recurrence
        "bias": spec((h, 4 * p), ("heads", None)),
        "out_norm": {"scale": spec((d,), ("norm_scale",))},
        "w_out": spec((d, d), ("embed", "embed")),
    }


def _slstm_cell(p_, wx_t: torch.Tensor, state):
    """One timestep in the model dtype.  wx_t: (B,H,4P) pre-computed input
    projection; the recurrence ``hid @ R`` in hid's dtype, the gates in f32,
    the new state rounded to wx's dtype."""
    c, n, hid = state  # each (B,H,P)
    rec = torch.einsum("bhp,hpq->bhq", hid, p_["r"].to(hid.dtype))
    g = (wx_t + rec + p_["bias"].to(wx_t.dtype)[None]).float()
    pdim = g.shape[-1] // 4
    z = torch.tanh(g[..., :pdim])
    i = torch.sigmoid(g[..., pdim : 2 * pdim])
    f = torch.sigmoid(g[..., 2 * pdim : 3 * pdim])
    o = torch.sigmoid(g[..., 3 * pdim :])
    c = f * c.float() + i * z
    n = f * n.float() + i
    hid_new = o * c / torch.clamp(n, min=1.0)
    dt = wx_t.dtype
    return (c.to(dt), n.to(dt), hid_new.to(dt))


def apply_slstm(cfg, p_, x: torch.Tensor, state0=None):
    """Sequential sLSTM over the sequence.  Returns (y (B,S,D), cache).

    With ``cfg.slstm_kernel`` the recurrence is one ``ops.slstm_scan`` call
    (the hand-written kernel on the card, its plain version on the CPU);
    otherwise a loop of ``_slstm_cell`` steps."""
    b, s, d = x.shape
    h = cfg.n_heads
    pdim = d // h
    wx = torch.einsum("bsd,dhq->bshq", x, p_["w"].to(x.dtype)).contiguous()  # (B,S,H,4P)
    if state0 is None:
        zero = torch.zeros((b, h, pdim), dtype=x.dtype, device=x.device)
        state0 = (zero, zero, zero)

    def recurrence(wx, r, bias, c0, n0, h0):
        if cfg.slstm_kernel:
            hids, state = ops.slstm_scan(wx, r, bias, (c0, n0, h0))
            return (hids, *state)
        state = (c0, n0, h0)
        hids = []
        for t in range(wx.shape[1]):
            state = _slstm_cell({"r": r, "bias": bias}, wx[:, t], state)
            hids.append(state[2])
        return (torch.stack(hids, dim=1), *state)

    # heads and batch rows are independent: each rank runs its own
    st = {"batch": 0, "heads": 1}
    hids, *state = local_by_roles(
        recurrence, (wx, p_["r"], p_["bias"], *state0),
        ({"batch": 0, "heads": 2}, {"heads": 0}, {"heads": 0}, st, st, st),
        ({"batch": 0, "heads": 2}, st, st, st))
    y = rms_norm(hids.reshape(b, s, d), p_["out_norm"]["scale"])
    out = y @ p_["w_out"].to(x.dtype)
    return out, {"c": state[0], "n": state[1], "hid": state[2]}


def slstm_decode(cfg, p_, x: torch.Tensor, cache: dict):
    b, _, d = x.shape
    wx = torch.einsum("bsd,dhq->bshq", x, p_["w"].to(x.dtype))[:, 0]
    c, n, hid = _slstm_cell(p_, wx, (cache["c"], cache["n"], cache["hid"]))
    y = rms_norm(hid.reshape(b, 1, d), p_["out_norm"]["scale"])
    out = y @ p_["w_out"].to(x.dtype)
    return out, {"c": c, "n": n, "hid": hid}


def slstm_cache_spec(cfg, batch: int) -> dict:
    h = cfg.n_heads
    pdim = cfg.d_model // h
    ax = ("batch", "heads", None)
    return {
        "c": spec((batch, h, pdim), ax, cfg.dtype),
        "n": spec((batch, h, pdim), ax, cfg.dtype),
        "hid": spec((batch, h, pdim), ax, cfg.dtype),
    }
