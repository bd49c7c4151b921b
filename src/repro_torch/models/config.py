"""Unified model configuration covering all assigned architecture families:
dense/GQA transformers, local+global alternating attention, MoE (coarse and
fine-grained with shared experts), Mamba2 hybrids, xLSTM, and enc-dec.

The port's own copy of ``repro.models.config`` (the port imports nothing of
the JAX package): the same frozen dataclasses and the same ``reduced``, so a
config built here and one built there describe the same model."""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    n_shared_experts: int = 0  # deepseek-style always-on experts
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2
    d_conv: int = 4
    head_dim: int = 64
    chunk: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 256
    vocab: int = 256

    # attention details
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0  # stablelm: partial rotary
    window: int = 0  # sliding-window size for 'swa' layers (0 = unused)
    layer_pattern: tuple[str, ...] = ("full",)  # cycled over layers:
    #   'full' | 'swa' | 'mamba2' | 'mlstm' | 'slstm'
    prefix_pattern: tuple[str, ...] = ()  # static leading layers (deepseek: dense first layer)
    attn_softcap: float = 0.0  # gemma2: 50.0
    final_softcap: float = 0.0  # gemma2: 30.0
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    act: str = "swiglu"  # 'swiglu' | 'gelu' | 'gelu_mlp'
    post_norm: bool = False  # gemma2 pre+post block norms
    qk_norm: bool = False
    embed_scale: bool = False  # gemma: embeddings * sqrt(d_model)

    # MoE / SSM subconfigs (None → dense FFN / no ssm layers)
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # MoE dispatch locality: 0 = global top-C per expert; G > 1 = top-C
    # within each of G token groups (aligned with the `data` shards, so
    # the dispatch gather/scatter stays device-local and the only
    # cross-device movement is the EP all-to-all)  [§Perf iteration]
    moe_dispatch_groups: int = 0

    # zamba2: shared (weight-tied) attention block applied every group
    shared_attn_every: int = 0  # period in layers (0 = none)

    # enc-dec (seamless): encoder layer count; n_layers = decoder layers
    n_enc_layers: int = 0

    # modality frontend (STUB: precomputed embeddings enter via input_specs)
    frontend: str = "none"  # 'none' | 'patch' | 'frames'
    frontend_len: int = 0  # embeddings per sample at train/prefill

    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # does the arch support ~500k-token decode? (sub-quadratic / windowed)
    subquadratic: bool = False

    # remat policy for train: 'none' | 'full' | 'dots'
    remat: str = "full"

    # pad the embedding/vocab param dim so TP over `model` always divides
    # (MaxText-style); logits over padded ids are masked to -inf.
    vocab_pad_multiple: int = 16

    # run the sLSTM recurrence in the VMEM-resident-weights Pallas kernel
    # (TPU only / interpret mode on CPU; see kernels/slstm_cell.py)
    slstm_kernel: bool = False
    # run full-sequence attention in the Pallas flash kernel (scores stay
    # in VMEM; see kernels/flash_attention.py).  Off by default: Mosaic
    # cannot lower in the CPU dry-run, and the chunked-jnp path is the
    # numerics oracle.
    flash_kernel: bool = False

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab + m - 1) // m * m

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    def blocks(self) -> list[str]:
        """Resolved per-layer block kinds (prefix + cycled pattern)."""
        body = self.n_layers - len(self.prefix_pattern)
        out = list(self.prefix_pattern)
        for i in range(body):
            out.append(self.layer_pattern[i % self.pattern_period])
        return out

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: same block pattern /
    feature set, small dims."""
    period = cfg.pattern_period
    n_layers = max(2 * period, len(cfg.prefix_pattern) + period)
    if cfg.shared_attn_every:
        n_layers = max(n_layers, 2 * cfg.shared_attn_every)
    moe = None
    if cfg.moe:
        ne = min(cfg.moe.n_experts, 4)
        tk = min(cfg.moe.top_k, 2)
        moe = MoEConfig(
            n_experts=ne,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            top_k=tk,
            expert_d_ff=64,
            # worst-case capacity (cap == T): smoke-scale routers are
            # untrained and heavily skewed, and capacity drops would break
            # prefill/decode parity (decode never competes for capacity)
            capacity_factor=max(cfg.moe.capacity_factor, ne / max(tk, 1)),
        )
    ssm = None
    if cfg.ssm:
        ssm = SSMConfig(d_state=16, expand=2, d_conv=4, head_dim=16, chunk=16)
    return replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        window=min(cfg.window, 32) if cfg.window else 0,
        moe=moe,
        ssm=ssm,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        frontend_len=4 if cfg.frontend != "none" else 0,
        shared_attn_every=min(cfg.shared_attn_every, 3) if cfg.shared_attn_every else 0,
        dtype="float32",
        remat="none",
    )
