"""GridLocal's outer optimiser: the paper's single-aggregation pattern
applied to distributed training.

The port of ``repro.optim.outer``.  Each pod (a "grid site") runs H inner
AdamW steps with no communication; every H steps the pods' parameters are
merged by the paper's size-weighted sufficient-statistics aggregation
(uniform sizes, so a mean) and an outer Nesterov-SGD step is applied
(DiLoCo-style).  Trees are ``{name: tensor}`` dicts, as in
``optim.adamw``, and every number keeps the reference's float32
arithmetic in its order.  The outer state's tensors are the port's own:
``outer_init`` copies the parameters into the anchor and ``outer_update``
hands back fresh tensors, so AdamW's in-place update of a pod never moves
the anchor.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import torch


class OuterConfig(NamedTuple):
    h_steps: int = 16  # inner steps between outer syncs
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    # cross-pod delta compression for the merge ('none' | 'int8'):
    # per-leaf symmetric quantisation of (params - anchor), so the only
    # cross-pod payload is int8 and one scale a leaf
    compress: str = "none"


def quantize_delta(delta: torch.Tensor, scale: torch.Tensor | None = None):
    """Symmetric int8 quantisation of a whole leaf: ``(q, scale)`` with
    ``scale = max(max|delta|, 1e-12)`` (an f32 0-d tensor) and ``q =
    clip(round(delta / scale · 127), -127, 127)`` as int8, rounding half
    to even as ``jnp.round`` does."""
    if scale is None:
        scale = torch.clamp(delta.abs().max(), min=1e-12)
    q = torch.clamp(torch.round(delta / scale * 127.0), -127, 127).to(torch.int8)
    return q, scale


def dequantize_delta(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * (scale / 127.0)


def outer_init(params: Mapping[str, torch.Tensor]) -> dict:
    """``{"anchor": f32 copies of the parameters, "momentum": f32 zeros}``,
    keyed and ordered as ``params``."""
    return {
        "anchor": {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()},
        "momentum": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
    }


def outer_step(cfg: OuterConfig, anchor: torch.Tensor, m: torch.Tensor, merged: torch.Tensor):
    """One leaf's Nesterov step on its merged value: ``delta = merged −
    anchor``, ``m' = μ·m + delta``, ``anchor' = anchor + lr·(delta + μ·m')``.
    Returns new tensors ``(anchor', m')``."""
    mu, lr = cfg.outer_momentum, cfg.outer_lr
    delta = merged.float() - anchor
    m = mu * m + delta
    return anchor + lr * (delta + mu * m), m


@torch.no_grad()
def outer_update(cfg: OuterConfig, outer_state: dict, merged_params: Mapping[str, torch.Tensor]):
    """The outer step on the (already pod-averaged) parameters, leaf by
    leaf.  Returns ``(new inner params, new outer state)``: the new inner
    parameters are the new anchor in the merged leaves' dtypes, each a
    tensor of its own (every pod restarts from it)."""
    anchor, mom, new_p = {}, {}, {}
    for k, a in outer_state["anchor"].items():
        anchor[k], mom[k] = outer_step(cfg, a, outer_state["momentum"][k], merged_params[k])
        new_p[k] = anchor[k].to(merged_params[k].dtype, copy=True)
    return new_p, {"anchor": anchor, "momentum": mom}
