"""gemma2-2b [dense] — local+global alternating attention, logit softcaps,
pre+post norms, scaled embeddings [arXiv:2408.00118].  Half the layers
attend within a 4,096-token window."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256_000,
    rope_theta=10_000.0,
    window=4096,
    layer_pattern=("swa", "full"),
    attn_softcap=50.0,
    final_softcap=30.0,
    norm="rmsnorm",
    act="geglu",
    post_norm=True,
    embed_scale=True,
    subquadratic=True,
)
