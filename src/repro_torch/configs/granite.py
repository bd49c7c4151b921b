"""granite-20b [dense] — llama-arch code model, MQA (kv=1) [arXiv:2405.04324]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    rope_theta=10_000.0,
    layer_pattern=("full",),
    norm="layernorm",
    act="gelu_mlp",  # GPT-BigCode-style 4x GELU MLP (matches the 20B param count)
    subquadratic=False,
)
