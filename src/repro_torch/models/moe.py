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
same bits).

One body serves plain tensors and a mesh.  With plain tensors (or
outside ``sharding.activate``) every ``constrain`` is the identity and
every ``local_by_roles`` a direct call.  On a mesh (DTensor operands inside
``sharding.activate``) the dispatch keeps the reference's constraints: the router runs on each rank's tokens,
the per-expert selection is placed on (``experts``, ``expert_cap``) — or
(``experts``, ``expert_group``) in the local form — and the buffers and
expert outputs with it, the combined output on (``flat_tokens``, None).
The ops DTensor has no strategy for run on local shards
(``sharding.local_by_roles``): each top-k over a whole last axis, the
token gather (the global form gathers the tokens to every rank first, as
the reference's partitioner does) and the scatter-add, whose per-rank
sums are reduced by the closing constraint.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import spec
from repro_torch.sharding import bmm_shared_weight_grad, constrain, local_by_roles


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
    order, the lower index first among equal values.  A DTensor is sorted
    on each rank's rows, its last axis gathered whole."""
    def local(x):
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k]

    rows = {f"d{i}": i for i in range(x.ndim - 1)}
    return local_by_roles(local, (x,), (rows,), (rows, rows))


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
    """xg (E, N, D) through each expert's SwiGLU FFN -> (E, N, D), in xg's
    dtype.  On a mesh each weight gradient is split over the ranks that
    hold the same buffer (``sharding.bmm_shared_weight_grad``, along the
    expert's mlp dim)."""
    dt = xg.dtype
    h = F.silu(bmm_shared_weight_grad(xg, p["w_gate"].to(dt), 2))
    h = h * bmm_shared_weight_grad(xg, p["w_up"].to(dt), 2)
    return bmm_shared_weight_grad(h, p["w_down"].to(dt), 1)


def _add_in_expert_order(ix: torch.Tensor, val: torch.Tensor, rows: int) -> torch.Tensor:
    """ix (E, ...) token rows, val (E, ..., D) -> (rows, D): one
    ``index_add_`` an expert, in expert order (the reference's E-major
    scatter), rounding in val's dtype."""
    d = val.shape[-1]
    out = torch.zeros((rows, d), dtype=val.dtype, device=val.device)
    for e in range(ix.shape[0]):
        out.index_add_(0, ix[e].reshape(-1), val[e].reshape(-1, d))
    return out


def _aux_losses(cfg, logits, probs, top_i):
    """Switch-style load balancing and the router z-loss, as sums over the
    tokens over their count (a DTensor's tokens stay on their ranks)."""
    m = cfg.moe
    t = top_i.shape[0]
    hot = local_by_roles(lambda ti: torch.zeros((ti.shape[0], m.n_experts), dtype=torch.float32,
                                                device=ti.device).scatter_(1, ti, 1.0),
                         (top_i,), ({"t": 0},), ({"t": 0},))
    frac_tokens = hot.sum(dim=0) / t
    frac_probs = probs.sum(dim=0) / t
    aux = m.n_experts * torch.sum(frac_tokens * frac_probs) * m.aux_loss
    z = torch.sum(torch.logsumexp(logits, dim=-1) ** 2) / t * m.router_z_loss
    return aux, z


def apply_moe(cfg, p, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """x (B, S, D) -> (B, S, D), aux metrics {aux_loss, z_loss} (f32 scalars)."""
    m = cfg.moe
    b, s, d = x.shape
    t, n_e, dt = b * s, m.n_experts, x.dtype
    xt = x.reshape(t, d)

    logits, probs, top_p, top_i = route(cfg, p, xt)
    aux, z = _aux_losses(cfg, logits, probs, top_i)
    # per-expert token weights: a token's k experts are distinct, so the
    # scatter equals the reference's one-hot einsum exactly
    w_te = local_by_roles(lambda ti, tp: torch.zeros((ti.shape[0], n_e), dtype=torch.float32,
                                                     device=ti.device).scatter_(1, ti, tp),
                          (top_i, top_p), ({"t": 0}, {"t": 0}), ({"t": 0},))
    groups = cfg.moe_dispatch_groups
    if groups > 1 and t % groups == 0:
        # local dispatch: top-C within each of G token groups
        tl = t // groups
        w_egt = constrain(w_te.T.reshape(n_e, groups, tl), ("experts", "expert_group", None))
        sel_w, sel_rel = top_k(w_egt, _capacity(tl, m))  # (E, G, Cl), ids within the group
        sel_w = constrain(sel_w, ("experts", "expert_group", None))
        sel_rel = constrain(sel_rel, ("experts", "expert_group", None))
        xt_g = constrain(xt.reshape(groups, tl, d), ("expert_group", None, None))

        def take(xs, ix):  # (Gl, Tl, D), (El, Gl, Cl) -> (El, Gl, Cl, D)
            return xs[torch.arange(xs.shape[0], device=xs.device)[None, :, None], ix]

        xg = local_by_roles(take, (xt_g, sel_rel), ({"g": 0}, {"e": 0, "g": 1}), ({"e": 0, "g": 1},), lead=1)
        xg = constrain(xg, ("experts", "expert_group", None, None))
        ye = _experts(p, xg.reshape(n_e, -1, d)).reshape(xg.shape)
        ye = constrain(ye, ("experts", "expert_group", None, None)) * sel_w[..., None].to(dt)

        def scat(ix, val):  # (El, Gl, Cl), (El, Gl, Cl, D) -> (Gl, Tl, D), this rank's experts' sums
            gl = ix.shape[1]
            # token rows over this rank's groups: group g's are g·tl .. g·tl + tl - 1
            rows = ix + torch.arange(gl, device=ix.device)[None, :, None] * tl
            return _add_in_expert_order(rows, val, gl * tl).reshape(gl, tl, d)

        out = local_by_roles(scat, (sel_rel, ye), ({"e": 0, "g": 1}, {"e": 0, "g": 1}),
                             ({"e": None, "g": 0},))
        out = constrain(out.reshape(t, d), ("flat_tokens", None))
    else:
        # global dispatch: per-expert top-C over all tokens
        sel_w, sel_idx = top_k(w_te.T, _capacity(t, m))  # (E, C)
        sel_w = constrain(sel_w, ("experts", "expert_cap"))
        sel_idx = constrain(sel_idx, ("experts", "expert_cap"))
        xg = local_by_roles(lambda xs, ix: xs[ix], (xt, sel_idx), ({}, {"e": 0, "c": 1}), ({"e": 0, "c": 1},),
                            lead=1)
        xg = constrain(xg, ("experts", "expert_cap", None))
        ye = constrain(_experts(p, xg), ("experts", "expert_cap", None)) * sel_w[..., None].to(dt)
        out = local_by_roles(lambda ix, val: _add_in_expert_order(ix, val, t), (sel_idx, ye),
                             ({"e": 0, "c": 1}, {"e": 0, "c": 1}), ({"e": None, "c": None},))
        out = constrain(out, ("flat_tokens", None))

    if m.n_shared_experts:
        sh = p["shared"]
        hs = F.silu(xt @ sh["w_gate"].to(dt)) * (xt @ sh["w_up"].to(dt))
        out = out + constrain(hs @ sh["w_down"].to(dt), ("flat_tokens", None))

    return out.reshape(b, s, d), {"aux_loss": aux, "z_loss": z}
