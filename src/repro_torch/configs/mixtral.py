"""mixtral-8x22b [moe] — 8 experts top-2, GQA kv=8, SWA (per assignment)
[arXiv:2401.04088]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    window=4096,
    layer_pattern=("swa",),
    moe=MoEConfig(n_experts=8, n_shared_experts=0, top_k=2, expert_d_ff=16384),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    subquadratic=True,  # sliding-window attention in every layer
)
