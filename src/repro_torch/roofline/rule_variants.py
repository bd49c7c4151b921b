"""Named sharding-rule variants used by the §Perf hillclimbing loop.

The port of ``repro.roofline.rule_variants``, the same six tables.  Each
variant is a full Rules table, looked up by name with ``get``.  The dry
run counts under ``BASELINE`` (``GRIDLOCAL`` for a GridLocal cell) only.
"""

from __future__ import annotations

from repro_torch.sharding import BASELINE, Rules

_REGISTRY: dict[str, Rules] = {}


def register(name: str, table: dict) -> Rules:
    r = Rules(name=name, table=table)
    _REGISTRY[name] = r
    return r


def get(name: str) -> Rules:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown rules variant {name!r}; known: {sorted(_REGISTRY)}")


# --- variants -------------------------------------------------------------

# V1: no FSDP — weights replicated over `data` (pure DP+TP). Trades memory
# for the removal of the per-step weight all-gathers.
register("no_fsdp", {**BASELINE.table, "embed": ()})

# V2: sequence-sharded activations (sequence parallelism for the norm/ffn
# segments): batch over data, seq over model for activations.
register("seqpar", {**BASELINE.table, "seq": ("model",)})

# V3: decode cache sharded over model axis too (more shards for the
# long-context cache; frees `data` for batch).
register("cache_model", {**BASELINE.table, "kv_seq": ("model",), "batch": ("pod", "data")})

# V4: expert-parallel preference for MoE dispatch capacity over model
register("ep_cap_model", {**BASELINE.table, "expert_cap": ("model",)})

# V5: vocab unsharded (replicated head) — for small-vocab archs where the
# gather/all-reduce of the sharded head dominates.
register("vocab_replicated", {**BASELINE.table, "vocab": ()})

# V6: 2D-factorised MoE mesh (data, expert, model): true expert parallelism
# for coarse-expert models (pairs with launch.mesh.make_variant_mesh("moe2d")).
register(
    "moe_2d",
    {
        **BASELINE.table,
        # experts get EP over `expert` (8) x TP over `model` (2); everything
        # NON-expert keeps full 16-way TP by sharding over the combined
        # (expert, model) axes — attention must not pay for the mesh split.
        "experts": ("expert",),
        "expert_cap": ("data",),
        "expert_mlp": ("model",),
        "heads": ("expert", "model"),
        "kv_heads": ("expert",),
        "mlp": ("expert", "model"),
        "vocab": ("expert", "model"),
        "embed": ("data",),
        "ssm_inner": ("expert", "model"),
        "mlstm_inner": ("expert", "model"),
    },
)
