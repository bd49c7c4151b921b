"""Mixture-of-Experts FFN: top-k routing with capacity-bounded, sort-free
dispatch (per-expert top-C token selection) and optional always-on shared
experts (deepseek-style fine-grained MoE).

The port of ``repro.models.moe``, with its numerics:

  router probs (T, E) in f32 → top-k per token → per-expert token weights
  (E, T) → per-expert top-C token gather into (E, C, D) buffers → batched
  expert matmuls → weighted scatter-add back to (T, D).

Tokens beyond an expert's capacity are dropped (capacity-factor
semantics); the router's aux and z losses come back for the train loss.
Two orders the reference fixes are kept on every device: ``jax.lax.top_k``
puts the lower index first on ties, which ``torch.topk`` does not promise,
so every top-k here is a stable descending sort and a slice (the ties at
the capacity cut decide which tokens are dropped); and the scatter-add
adds each token's expert outputs in expert order, rounding in the compute
dtype, so it runs one ``index_add_`` an expert (within one expert the
selected tokens are distinct, so no two adds meet and two runs give the
same bits).  The reference's sharding constraints place nothing here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import spec


def moe_spec(cfg) -> dict:
    m = cfg.moe
    d = cfg.d_model
    p = {
        "router": spec((d, m.n_experts), ("embed", "experts")),
        "w_gate": spec((m.n_experts, d, m.expert_d_ff), ("experts", "embed", "expert_mlp")),
        "w_up": spec((m.n_experts, d, m.expert_d_ff), ("experts", "embed", "expert_mlp")),
        "w_down": spec((m.n_experts, m.expert_d_ff, d), ("experts", "expert_mlp", "embed")),
    }
    if m.n_shared_experts:
        dsh = m.expert_d_ff * m.n_shared_experts
        p["shared"] = {
            "w_gate": spec((d, dsh), ("embed", "mlp")),
            "w_up": spec((d, dsh), ("embed", "mlp")),
            "w_down": spec((dsh, d), ("mlp", "embed")),
        }
    return p


def _capacity(t: int, m) -> int:
    c = int(t * m.top_k * m.capacity_factor / m.n_experts)
    return min(t, max(8, (c + 7) // 8 * 8))


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest in descending
    order, the lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg, p, xt: torch.Tensor):
    """xt (T, D) -> (router logits (T, E) f32, probs (T, E), the top-k
    weights renormalised (T, k), their experts (T, k)).  An f32 product:
    with TF32 on, tokens would be routed otherwise."""
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, cfg.moe.top_k)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    return logits, probs, top_p, top_i


def _experts(p, xg: torch.Tensor) -> torch.Tensor:
    """xg (E, N, D) through each expert's SwiGLU FFN -> (E, N, D), in xg's dtype."""
    dt = xg.dtype
    h = F.silu(torch.bmm(xg, p["w_gate"].to(dt)))
    h = h * torch.bmm(xg, p["w_up"].to(dt))
    return torch.bmm(h, p["w_down"].to(dt))


def apply_moe(cfg, p, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """x (B, S, D) -> (B, S, D), aux metrics {aux_loss, z_loss} (f32 scalars)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    n_e = m.n_experts
    xt = x.reshape(t, d)
    dt = x.dtype

    logits, probs, top_p, top_i = route(cfg, p, xt)
    # per-expert token weights: a token's k experts are distinct, so the
    # scatter equals the reference's one-hot einsum exactly
    w_te = torch.zeros((t, n_e), dtype=torch.float32, device=x.device).scatter_(1, top_i, top_p)
    w_et = w_te.T  # (E, T)

    # aux losses (Switch-style load balancing + router z-loss)
    routed = torch.zeros((t, n_e), dtype=torch.float32, device=x.device).scatter_(1, top_i, 1.0)
    frac_tokens = routed.mean(dim=0)  # (E,)
    frac_probs = probs.mean(dim=0)
    aux = n_e * torch.sum(frac_tokens * frac_probs) * m.aux_loss
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_loss

    groups = cfg.moe_dispatch_groups
    if groups > 1 and t % groups == 0:
        # local dispatch: top-C within each of G token groups
        tl = t // groups
        sel_w, sel_idx = top_k(w_et.reshape(n_e, groups, tl), _capacity(tl, m))  # (E, G, Cl)
        # token ids over all groups: group g's tokens are g·tl .. g·tl + tl - 1
        sel_idx = sel_idx + torch.arange(groups, device=x.device)[None, :, None] * tl
    else:
        # global dispatch: per-expert top-C over all tokens
        sel_w, sel_idx = top_k(w_et, _capacity(t, m))  # (E, C)
    sel_idx = sel_idx.reshape(n_e, -1)
    ye = _experts(p, xt[sel_idx])  # (E, N, D)
    ye = ye * sel_w.reshape(n_e, -1, 1).to(dt)

    out = torch.zeros((t, d), dtype=dt, device=x.device)
    for e in range(n_e):  # expert order, as the reference's E-major scatter adds
        out.index_add_(0, sel_idx[e], ye[e])

    if m.n_shared_experts:
        sh = p["shared"]
        hs = F.silu(xt @ sh["w_gate"].to(dt)) * (xt @ sh["w_up"].to(dt))
        out = out + hs @ sh["w_down"].to(dt)

    return out.reshape(b, s, d), {"aux_loss": aux, "z_loss": z}
