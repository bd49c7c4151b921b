"""zamba2-1.2b [hybrid] — Mamba2 backbone + weight-shared attention block
interleaved every 6 layers [arXiv:2411.15242].

Layout: 38 mamba2 layers = 6 scan groups of 6 (each preceded by the shared
attention+FFN block) + 2 static tail layers.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    layer_pattern=("mamba2",) * 6,
    shared_attn_every=6,
    ssm=SSMConfig(d_state=64, expand=2, d_conv=4, head_dim=64, chunk=128),
    norm="rmsnorm",
    act="swiglu",
    subquadratic=True,
)
