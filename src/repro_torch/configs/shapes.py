"""Assigned input-shape set and per-cell input specs.

The port of ``repro.configs.shapes``.  LM transformer shapes are seq_len x
global_batch.  ``decode_*``/``long_*`` run the decode step (one new token
against a seq_len KV cache), NOT the train step; ``prefill_*`` runs the
cache-building forward.  ``long_500k`` requires sub-quadratic attention:
pure full-attention archs skip it (``cfg.subquadratic``).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShapeAxes, spec


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def _shape(shape: str | Shape) -> Shape:
    return SHAPES[shape] if isinstance(shape, str) else shape


def cell_is_supported(cfg: ModelConfig, shape_name: str | Shape) -> bool:
    sh = _shape(shape_name)
    if sh.name == "long_500k" and not cfg.subquadratic:
        return False
    return True


def skip_reason(cfg: ModelConfig, shape_name: str | Shape) -> str:
    if not cell_is_supported(cfg, shape_name):
        return (
            "pure full-attention arch: 524k-token context is architecturally "
            "unsupported (quadratic prefill, unwindowed cache) — see DESIGN.md"
        )
    return ""


def input_specs(cfg: ModelConfig, shape_name: str | Shape) -> dict:
    """ShapeAxes tree for every model input of this (arch x shape) cell.

    train:   {tokens, labels[, frontend]}
    prefill: {tokens[, frontend]}            (cache passed separately)
    decode:  {token, pos}                    (cache passed separately)

    ``shape_name`` may also be a ``Shape`` of one's own (a cell cut to one
    card's batch)."""
    sh = _shape(shape_name)
    b, s = sh.global_batch, sh.seq_len
    tok_axes = ("batch", "seq")
    if sh.kind in ("train", "prefill"):
        s_tok = s - (cfg.frontend_len if (cfg.frontend != "none" and not cfg.is_encdec) else 0)
        out = {"tokens": spec((b, s_tok), tok_axes, "int32")}
        if sh.kind == "train":
            out["labels"] = spec((b, s_tok), tok_axes, "int32")
        if cfg.frontend != "none":
            out["frontend"] = spec(
                (b, cfg.frontend_len, cfg.d_model), ("batch", "frontend", None), cfg.dtype
            )
        return out
    # decode
    return {
        "token": spec((b, 1), tok_axes, "int32"),
        "pos": ShapeAxes(shape=(), dtype="int32", axes=()),
    }
