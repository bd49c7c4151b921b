"""xlstm-1.3b [ssm] — mLSTM blocks with sLSTM every 8th (7:1)
[arXiv:2405.04517].  d_ff=0: blocks carry their own projections."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab=50304,
    layer_pattern=("mlstm",) * 7 + ("slstm",),
    norm="rmsnorm",
    subquadratic=True,
)
