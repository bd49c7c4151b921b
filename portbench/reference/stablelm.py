"""Plain float32 reference of stablelm-2-1.6b as its configuration file
states it (arXiv:2402.17834; hf:stabilityai/stablelm-2-1_6b): a pre-norm
decoder with LayerNorm (eps 1e-5, scale and bias), multi-head attention
with rotary embeddings on the first quarter of each head's channels (the
rotated channels split in halves), a SwiGLU MLP, an untied head, and the
softmax cross-entropy over the labelled tokens.

One departure from the published model, kept because the program makes
it: the q/k/v projections carry no bias (the published config sets
``use_qkv_bias``).  Layers are run one batch row at a time, each under
``torch.utils.checkpoint`` when gradients are taken, so that the
(heads, S, S) scores of one row and layer are the largest temporary.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def vocab_padded(m: dict) -> int:
    mult = m.get("vocab_pad_multiple", 16)
    return (m["vocab"] + mult - 1) // mult * mult


def param_shapes(m: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Every weight by its dotted name: (shape, init)."""
    d, h, kv, dh, ff = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    out = {"embed": ((vocab_padded(m), d), "normal"),
           "final_norm.scale": ((d,), "ones"), "final_norm.bias": ((d,), "zeros"),
           "lm_head": ((d, vocab_padded(m)), "normal")}
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        out.update({p + "ln1.scale": ((d,), "ones"), p + "ln1.bias": ((d,), "zeros"),
                    p + "attn.wq": ((d, h, dh), "normal"), p + "attn.wk": ((d, kv, dh), "normal"),
                    p + "attn.wv": ((d, kv, dh), "normal"), p + "attn.wo": ((h, dh, d), "normal"),
                    p + "ln2.scale": ((d,), "ones"), p + "ln2.bias": ((d,), "zeros"),
                    p + "ffn.w_gate": ((d, ff), "normal"), p + "ffn.w_up": ((d, ff), "normal"),
                    p + "ffn.w_down": ((ff, d), "normal")})
    return out


def layer_norm(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def rope(x: torch.Tensor, theta: float, pct: float) -> torch.Tensor:
    """x (S, H, Dh): the first ``int(Dh·pct)//2*2`` channels rotated by
    position, split in halves."""
    s, _, dh = x.shape
    rot = int(dh * pct) // 2 * 2
    if rot == 0:
        return x
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : rot // 2], x[..., rot // 2 : rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]], dim=-1)


def block(m: dict, w: dict, i: int, x: torch.Tensor, mm) -> torch.Tensor:
    """Layer ``i`` on one row x (S, D)."""
    p = f"layers.{i}."
    d, h, kv, dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    s = x.shape[0]
    a = layer_norm(x, w[p + "ln1.scale"], w[p + "ln1.bias"])
    q = mm(a, w[p + "attn.wq"].reshape(d, h * dh)).view(s, h, dh)
    k = mm(a, w[p + "attn.wk"].reshape(d, kv * dh)).view(s, kv, dh)
    v = mm(a, w[p + "attn.wv"].reshape(d, kv * dh)).view(s, kv, dh)
    q, k = rope(q, m["rope_theta"], m["rope_pct"]), rope(k, m["rope_theta"], m["rope_pct"])
    k, v = k.repeat_interleave(h // kv, dim=1), v.repeat_interleave(h // kv, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", probs, v).reshape(s, h * dh)
    x = x + mm(o, w[p + "attn.wo"].reshape(h * dh, d))
    a = layer_norm(x, w[p + "ln2.scale"], w[p + "ln2.bias"])
    return x + mm(F.silu(mm(a, w[p + "ffn.w_gate"])) * mm(a, w[p + "ffn.w_up"]), w[p + "ffn.w_down"])


def hidden(m: dict, w: dict, tokens: torch.Tensor, mm) -> torch.Tensor:
    """The last layer's output (S, D) of one row of ids (S,)."""
    x = w["embed"][tokens.long()]
    grad = torch.is_grad_enabled()
    for i in range(m["n_layers"]):
        x = checkpoint(block, m, w, i, x, mm, use_reentrant=False) if grad else block(m, w, i, x, mm)
    return x


def ce_sum(m: dict, w: dict, x: torch.Tensor, labels: torch.Tensor, mm) -> tuple[torch.Tensor, int]:
    """(summed cross-entropy of the labelled positions, their count) of one
    row's last hidden states x (S, D) and labels (S,), -1 unlabelled."""
    a = layer_norm(x, w["final_norm.scale"], w["final_norm.bias"])
    logits = mm(a, w["lm_head"])
    if logits.shape[-1] > m["vocab"]:
        logits = logits.masked_fill(torch.arange(logits.shape[-1], device=x.device) >= m["vocab"], float("-inf"))
    keep = labels >= 0
    lab = labels.clamp(min=0).long()
    ce = torch.logsumexp(logits, -1) - logits.gather(-1, lab[:, None])[:, 0]
    return (ce * keep).sum(), int(keep.sum())


def score(m: dict, w: dict, tokens: torch.Tensor, labels: torch.Tensor, mm) -> tuple[torch.Tensor, torch.Tensor]:
    """(the last hidden states (B, S, D), the mean cross-entropy) of a batch,
    without gradients, a row at a time."""
    with torch.no_grad():
        hs, tot, cnt = [], 0.0, 0
        for b in range(tokens.shape[0]):
            x = hidden(m, w, tokens[b], mm)
            c, n = ce_sum(m, w, x, labels[b], mm)
            hs.append(x)
            tot, cnt = tot + c, cnt + n
        return torch.stack(hs), tot / max(cnt, 1)


# ---------------------------------------------------------------------------
# Training: AdamW with decoupled weight decay, the gradient clipped by its
# global norm, a linear warm-up and a cosine decay to a floor.
# ---------------------------------------------------------------------------


def lr_at(opt: dict, step: int) -> float:
    if step < opt["warmup"]:
        return opt["lr"] * step / max(opt["warmup"], 1)
    prog = min(max((step - opt["warmup"]) / max(opt["decay_steps"] - opt["warmup"], 1), 0.0), 1.0)
    floor = opt["min_lr_frac"]
    return opt["lr"] * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog)))


def loss_and_grads(m: dict, w: dict, tokens, labels, mm) -> tuple[float, dict]:
    """The batch's mean cross-entropy and its gradient, row by row: each
    row's summed loss over the batch's label count is differentiated, so
    the gradients add up to the whole batch's."""
    params = [t for t in w.values()]
    for t in params:
        t.grad = None
    total = int((labels >= 0).sum())
    loss = 0.0
    for b in range(tokens.shape[0]):
        with torch.enable_grad():
            c, _ = ce_sum(m, w, hidden(m, w, tokens[b], mm), labels[b], mm)
            (c / max(total, 1)).backward()
        loss += float(c.detach()) / max(total, 1)
    return loss, {n: (t.grad if t.grad is not None else torch.zeros_like(t)) for n, t in w.items()}


def train(m: dict, w: dict, batches: list[dict], opt: dict, mm) -> dict:
    """``len(batches)`` AdamW steps on the float32 weights ``w`` (updated in
    place).  Returns each step's loss and gradient norm before the clip,
    each leaf's gradient norm as the optimizer gets it at step 1 (after
    the clip) and before the clip, and each leaf's change after the last
    step."""
    for t in w.values():
        t.requires_grad_(True)
    start = {n: t.detach().clone() for n, t in w.items()}
    mom = {n: torch.zeros_like(t) for n, t in w.items()}
    var = {n: torch.zeros_like(t) for n, t in w.items()}
    b1, b2 = opt["b1"], opt["b2"]
    out = {"loss": [], "grad_norm": [], "grad1": {}, "grad1_raw": {}}
    for step, batch in enumerate(batches, start=1):
        loss, grads = loss_and_grads(m, w, batch["tokens"], batch["labels"], mm)
        gnorm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads.values()))
        scale = min(opt["grad_clip"] / max(gnorm, 1e-9), 1.0) if opt["grad_clip"] else 1.0
        out["loss"].append(loss)
        out["grad_norm"].append(gnorm)
        lr = lr_at(opt, step)
        with torch.no_grad():
            for n, t in w.items():
                g = grads[n] * scale
                if step == 1:
                    out["grad1"][n] = float(g.norm())
                    out["grad1_raw"][n] = float(grads[n].norm())
                mom[n].mul_(b1).add_((1 - b1) * g)
                var[n].mul_(b2).add_((1 - b2) * g * g)
                mh, vh = mom[n] / (1 - b1 ** step), var[n] / (1 - b2 ** step)
                t.sub_(lr * (mh / (vh.sqrt() + opt["eps"]) + opt["weight_decay"] * t))
                t.grad = None
        del grads
    with torch.no_grad():
        out["change"] = {n: float((t - start[n]).norm()) for n, t in w.items()}
    return out
