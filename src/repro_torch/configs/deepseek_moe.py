"""deepseek-moe-16b [moe] — 2 shared + 64 routed experts top-6, fine-grained
(expert d_ff 1408); first layer is a dense FFN [arXiv:2401.06066]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense FFN of the first (prefix) layer
    vocab=102400,
    prefix_pattern=("full_dense",),
    layer_pattern=("full",),
    moe=MoEConfig(n_experts=64, n_shared_experts=2, top_k=6, expert_d_ff=1408),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    subquadratic=False,
)
