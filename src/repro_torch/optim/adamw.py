"""AdamW with f32 master weights and moments, keyed by parameter name.

The port of ``repro.optim.adamw``.  The reference's pytrees are dicts of
tensors here, ``{name: tensor}`` in the order the caller gives them (the
train step gives the JAX package's leaf order), and the update runs in
place under ``torch.no_grad()``.  Every number keeps the reference's
arithmetic, in float32 and in its order: the schedule in ``lr_at``, the
clip scale, ``m = b1·m + (1−b1)·g``, ``v = b2·v + ((1−b2)·g)·g``, the two
bias corrections and ``p − lr·(m̂/(√v̂ + eps) + wd·p)``, each operation
rounded on its own (no fused multiply-add, no ``_foreach`` kernels).
``torch.optim.AdamW`` is not used: it applies the decay before the
moment step, another function.
"""

from __future__ import annotations

import math
from collections.abc import Iterable, Mapping
from typing import NamedTuple

import torch


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: an f32 0-d
    tensor, computed in f32 as the reference computes it (its Python
    constants rounded to f32 where they meet the step)."""
    step = step.float() if isinstance(step, torch.Tensor) else torch.tensor(float(step), dtype=torch.float32)
    warm = step / float(max(cfg.warmup, 1))
    prog = torch.clamp((step - cfg.warmup) / float(max(cfg.decay_steps - cfg.warmup, 1)), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup, warm, cos)


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    """``{"step": int32 0-d, "m": {name: f32 zeros}, "v": {name: f32
    zeros}}`` on the parameters' device."""
    first = next(iter(params.values()))
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
    }


def global_norm(tree: Mapping[str, torch.Tensor] | Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ_leaf Σ leaf²)`` in f32, the leaves summed in the order given."""
    leaves = tree.values() if isinstance(tree, Mapping) else tree
    total = None
    for leaf in leaves:
        sq = torch.sum(leaf.float() ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor], state: dict,
                 params: Mapping[str, torch.Tensor]):
    """One AdamW step: ``(params, new_state, {"grad_norm", "lr"})``.  The
    parameters and moments are updated in place (the returned params are
    the same tensors); ``grads`` is keyed like ``params`` and summed into
    the global norm in its own order."""
    gnorm = global_norm(grads[k] for k in params)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0) if cfg.grad_clip else 1.0
    step = state["step"] + 1
    lr = lr_at(cfg, step).to(gnorm.device)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        g = grads[k].float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        p32 = p.float()
        new_p = p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32)
        p.copy_(new_p.to(p.dtype))
        del g, mh, vh, new_p
    return params, {"step": step, "m": state["m"], "v": state["v"]}, {"grad_norm": gnorm, "lr": lr}
