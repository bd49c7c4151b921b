"""Shared layer primitives: norms, RoPE, the softcap, the FFNs, and the
parameter spec helpers (the leaf itself, ``ShapeAxes``, is in ``specs``).

Parameters are described by ``ShapeAxes`` specs (shape + dtype + logical
axes), as in the JAX package, so one definition gives both the parameter
count (from shapes alone) and the real initialisation.  Weights are stored
fp32 (master copy); the forward casts to the config's compute dtype.
"""

from __future__ import annotations

import math
from collections.abc import Iterator, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.specs import ShapeAxes, spec, torch_dtype
from repro_torch.sharding import constrain, use_weight


def spec_leaves(specs, prefix: str = "") -> Iterator[tuple[str, ShapeAxes]]:
    """(dotted path, leaf) of every ShapeAxes in a nested dict/list of
    specs, in the order jax.tree flattens it (dict keys sorted)."""
    if isinstance(specs, ShapeAxes):
        yield prefix, specs
    elif isinstance(specs, Mapping):
        for k in sorted(specs):
            yield from spec_leaves(specs[k], f"{prefix}.{k}" if prefix else str(k))
    else:
        for i, s in enumerate(specs):
            yield from spec_leaves(s, f"{prefix}.{i}" if prefix else str(i))


def init_from_specs(specs, generator: torch.Generator, device: torch.device, scale: float = 0.02):
    """Materialise a nested dict of tensors from ShapeAxes specs on
    ``device``: ``normal × min(scale, 1/sqrt(fan_in))`` with ``fan_in =
    shape[-2]`` (the last dim for a vector), drawn from ``generator``
    (which must live on ``device``), leaf by leaf in flattening order;
    ``norm_scale`` leaves are ones and ``norm_bias`` leaves zeros.  The same
    rule as the JAX package's ``init_from_specs``; the numbers differ from
    jax.random's, and parity goes through ``convert`` instead."""
    if isinstance(specs, ShapeAxes):
        s = specs
        dt = torch_dtype(s.dtype)
        if s.axes and s.axes[-1] == "norm_scale":
            return torch.ones(s.shape, dtype=dt, device=device)
        if s.axes and s.axes[-1] == "norm_bias":
            return torch.zeros(s.shape, dtype=dt, device=device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = min(scale, 1.0 / math.sqrt(max(fan_in, 1)))
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=device)
        return (x * std).to(dt)
    if isinstance(specs, Mapping):
        return {k: init_from_specs(specs[k], generator, device, scale) for k in sorted(specs)}
    return [init_from_specs(s, generator, device, scale) for s in specs]


class ParamTree(nn.Module):
    """A nested dict of tensors as a module, read as the JAX package reads
    its parameter dicts: ``p["w_in"]``, ``p["out_norm"]["scale"]``, ``"ffn"
    in p``.  Parameters require gradients (the train step differentiates
    them); the serve steps and scoring run under ``torch.inference_mode()``
    and build no graph."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, key: str):
        v = getattr(self, key)
        if isinstance(v, nn.Parameter):
            return use_weight(v)
        return v

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, times ``1 + scale`` (scale is initialised to ones,
    as in the JAX package), cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(dt)


def norm_spec(cfg, d: int | None = None) -> dict:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {
            "scale": spec((d,), ("norm_scale",)),
            "bias": spec((d,), ("norm_bias",)),
        }
    return {"scale": spec((d,), ("norm_scale",))}


def apply_norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# RoPE (with the partial rotary of stablelm)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, pct: float, theta: float, device=None) -> tuple[torch.Tensor, int]:
    """(inverse frequencies (rot/2,) f32, rot): the first ``rot =
    int(head_dim·pct)//2*2`` channels rotate."""
    rot = int(head_dim * pct) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, pct: float = 1.0) -> torch.Tensor:
    """x (..., S, H, Dh); positions (..., S) int.  The angle is
    ``positions·inv`` in f32; ``[x1·cos − x2·sin, x2·cos + x1·sin]``, each
    cast to x's dtype, then the channels that do not rotate."""
    inv, rot = rope_frequencies(x.shape[-1], pct, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv  # (..., S, rot/2)
    sin = torch.sin(ang)[..., :, None, :]  # (..., S, 1, rot/2)
    cos = torch.cos(ang)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2 :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

GATED_ACTS = ("swiglu", "geglu")


def ffn_spec(cfg, d_ff: int | None = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    if cfg.act in GATED_ACTS:
        return {
            "w_gate": spec((d, d_ff), ("embed", "mlp")),
            "w_up": spec((d, d_ff), ("embed", "mlp")),
            "w_down": spec((d_ff, d), ("mlp", "embed")),
        }
    return {
        "w_up": spec((d, d_ff), ("embed", "mlp")),
        "w_down": spec((d_ff, d), ("mlp", "embed")),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_ffn(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU / GeGLU (gated) or the 4x GELU MLP, in x's dtype."""
    dt = x.dtype
    if cfg.act in GATED_ACTS:
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        act = F.silu if cfg.act == "swiglu" else _gelu
        h = act(g) * u
    else:
        h = _gelu(x @ p["w_up"].to(dt))
    h = constrain(h, ("batch", "seq", "mlp"))
    # on a mesh the sum over the sharded mlp is reduced here, before a post-norm
    return constrain(h @ p["w_down"].to(dt), ("batch", "seq", None))
