"""seamless-m4t-large-v2 [audio] — encoder-decoder text backbone; speech
frontend is a STUB (the caller passes precomputed frame embeddings,
``frontend_embeds``) [arXiv:2308.11596].  24 encoder + 24 decoder layers."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    n_layers=24,       # decoder
    n_enc_layers=24,   # encoder
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256_206,
    layer_pattern=("full",),
    norm="layernorm",
    act="gelu_mlp",
    frontend="frames",
    frontend_len=1024,
    tie_embeddings=False,
    subquadratic=False,
)
