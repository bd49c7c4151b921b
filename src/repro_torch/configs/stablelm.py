"""stablelm-1.6b [dense] — partial rotary (25%), LayerNorm
[hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab=100352,
    rope_theta=10_000.0,
    rope_pct=0.25,
    layer_pattern=("full",),
    norm="layernorm",
    act="swiglu",
    tie_embeddings=False,
    subquadratic=False,
)
