"""The yardstick's arithmetic: the card's published peaks, the model FLOPs
of a step counted from the configuration and the shapes, and the
operations and bytes of the hand-written kernels' calls.

Peaks are NVIDIA's H100 SXM data sheet (dense rates, no sparsity, at the
full 700 W).  The kernel count is that of ``chip_smoke.py``'s
``flash_bound``: every input byte read once, every
output byte written once, whatever a kernel reads again.  Nothing here
depends on how the program computes a call, so whatever implements it is
held to the same work.
"""

from __future__ import annotations

BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12


# ---------------------------------------------------------------------------
# Model FLOPs.  2 a matmul weight a token in a forward (6 in training: the
# forward and the two products of the backward), counting only weights that
# enter a matmul (never the input embedding's lookup); attention's score and
# value products over the causal pairs; recomputation never counted.
# ---------------------------------------------------------------------------


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal self-attention over ``seq`` positions sees."""
    return seq * (seq + 1) // 2


def dense_matmul_weights(m: dict) -> dict[str, int]:
    """Weights of a dense pre-norm transformer (``m`` the config's model
    keys) that enter a matmul: the layers' and the head's."""
    d, h, kv, dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attn = d * h * dh + 2 * d * kv * dh + h * dh * d
    gated = m.get("act", "swiglu") in ("swiglu", "geglu")
    ffn = (3 if gated else 2) * d * m["d_ff"]
    return {"layers": m["n_layers"] * (attn + ffn), "head": d * _vocab_padded(m)}


def _vocab_padded(m: dict) -> int:
    mult = m.get("vocab_pad_multiple", 16)
    return (m["vocab"] + mult - 1) // mult * mult


def _blocks(m: dict) -> list[str]:
    pat = list(m["layer_pattern"])
    return [pat[i % len(pat)] for i in range(m["n_layers"])]


def attention_flops(m: dict, batch: int, seq: int) -> int:
    """Forward score and value products of every attention layer: 4·Dh a
    causal pair a head (2 for q·k, 2 for p·v)."""
    n_attn = sum(1 for k in _blocks(m) if k in ("full", "swa"))
    return 4 * m["head_dim"] * causal_pairs(seq) * m["n_heads"] * n_attn * batch


def train_step_flops(m: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one dense training step: 6 a matmul weight a token,
    and the attention products three times (the forward and the two of the
    backward)."""
    w = dense_matmul_weights(m)
    return 6 * (w["layers"] + w["head"]) * batch * seq + 3 * attention_flops(m, batch, seq)


def score_flops(m: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one scoring forward of a dense model: the head at
    every position (the loss needs every logit)."""
    w = dense_matmul_weights(m)
    return 2 * (w["layers"] + w["head"]) * batch * seq + attention_flops(m, batch, seq)


# ---------------------------------------------------------------------------
# Kernels: (operations, bytes, the peak the operations are held to)
# ---------------------------------------------------------------------------


def flash_work(batch: int, seq: int, heads: int, kv_heads: int, head_dim: int, elt: int,
               causal: bool = True) -> tuple[int, int, float]:
    """One causal self-attention ``flash_attention`` call, q (B, S, H, Dh)
    and k, v (B, S, Kv, Dh): q, k, v read once and the output written
    once; 4·Dh flops a visible pair a head.  bf16 operands: held to the
    bf16 tensor-core peak."""
    pairs = causal_pairs(seq) if causal else seq * seq
    nbytes = (2 * batch * seq * heads * head_dim + 2 * batch * seq * kv_heads * head_dim) * elt
    flops = 4 * head_dim * pairs * heads * batch
    return flops, nbytes, BF16_FLOPS_PER_S


def least_seconds(flops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: the larger of the operations
    over ``peak`` and the bytes over the HBM bandwidth."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)
