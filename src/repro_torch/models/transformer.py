"""Model assembly for the attention kinds (full, sliding-window, with a
dense or an MoE FFN) and the recurrent kinds (Mamba-2, mLSTM, sLSTM), with
zamba2's weight-shared attention block, the seamless-style encoder-decoder
(an encoder stack, cross-attention in every decoder layer) and the patch
frontend of phi-3-vision: the layer stack, the embedding and logits, and
the three entry points.

The port of ``repro.models.transformer``.  Layers are laid out as in the
JAX package, [prefix] + [G groups x P pattern slots] + [tail], but the port
keeps one module per layer in layer order, where the JAX package stacks
each slot's parameters on a leading G axis for ``lax.scan``: layer
``len(prefix) + g·P + slot`` is group g, slot ``slot`` (``convert`` maps
between the two).  The stack is a Python loop.  zamba2's shared
attention+FFN block is one more module (``Model.shared_attn``), run before
the first slot of every group and not before the tail; its K/V cache for
group g is entry ``n_layers + g`` of the decode cache, after the layers'.

The frontends are stubs, as in the JAX package: the caller passes
precomputed embeddings ``frontend_embeds`` (B, frontend_len, d_model).  An
encoder-decoder runs them through the encoder (``Model.encoder``, one
module a layer in layer order, and ``Model.encoder_norm``), whose output
every decoder layer cross-attends to; its decode cache holds that
memory's K/V (``ck``, ``cv``, frontend_len positions) beside each layer's
own K/V.  A decoder-only model (phi-3-vision) prepends them to the token
embeddings: positions run over the prefix, so decode continues at
``frontend_len + S_tok``, and the logits cover the token positions only.

  forward_train  — full-sequence logits, or the hidden states for the
                   chunked CE (scoring, and the train step's loss, which
                   autograd differentiates; groups recompute under
                   ``cfg.remat``)
  prefill        — full-sequence forward that also builds the decode cache
  decode_step    — single-token step against the cache
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import constrain, local_heads, local_offset, redistributed, use_weight
from repro_torch.models.layers import (
    ParamTree,
    ShapeAxes,
    apply_ffn,
    apply_norm,
    ffn_spec,
    init_from_specs,
    norm_spec,
    softcap,
    spec,
    spec_leaves,
    torch_dtype,
)

# ---------------------------------------------------------------------------
# Structure helpers
# ---------------------------------------------------------------------------

_RECURRENT_KINDS = ("mamba2", "mlstm", "slstm")
_ATTN_KINDS = ("full", "swa", "full_dense", "swa_dense")


def _is_attn(kind: str) -> bool:
    return kind in _ATTN_KINDS


def _window(cfg, kind: str) -> int:
    return cfg.window if kind.startswith("swa") else 0


def _layout(cfg: ModelConfig):
    """(prefix kinds, pattern, G, tail kinds)."""
    blocks = cfg.blocks()
    n_prefix = len(cfg.prefix_pattern)
    body = blocks[n_prefix:]
    p = cfg.pattern_period
    g = len(body) // p
    tail = body[g * p :]
    return blocks[:n_prefix], cfg.layer_pattern, g, tail


def layer_places(cfg: ModelConfig) -> list[tuple]:
    """Where each layer, in layer order, sits in the JAX package's
    parameter and cache trees: ``("prefix", i)``, ``("groups", g, slot)``
    or ``("tail", i)``."""
    prefix, pattern, g, tail = _layout(cfg)
    out: list[tuple] = [("prefix", i) for i in range(len(prefix))]
    out += [("groups", gi, slot) for gi in range(g) for slot in range(len(pattern))]
    out += [("tail", i) for i in range(len(tail))]
    return out


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port cannot run: an unknown block kind."""
    for kind in set(cfg.blocks()):
        if kind not in _RECURRENT_KINDS and not _is_attn(kind):
            raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def block_spec(cfg: ModelConfig, kind: str, cross: bool = False) -> dict:
    """One decoder layer; ``cross`` adds the encoder-decoder's
    cross-attention (``ln_cross``, ``cross``) to an attention layer."""
    if _is_attn(kind):
        p: dict[str, Any] = {"ln1": norm_spec(cfg), "attn": attn.attn_spec(cfg)}
        if cfg.post_norm:
            p["ln1_post"] = norm_spec(cfg)
        if cross:
            p["ln_cross"] = norm_spec(cfg)
            p["cross"] = attn.attn_spec(cfg, cross=True)
        p["ln2"] = norm_spec(cfg)
        if cfg.moe is not None and not kind.endswith("_dense"):
            p["moe"] = moe_mod.moe_spec(cfg)
        elif cfg.d_ff:
            p["ffn"] = ffn_spec(cfg)
        if cfg.post_norm:
            p["ln2_post"] = norm_spec(cfg)
        return p
    if kind == "mamba2":
        return {"ln1": norm_spec(cfg), "mixer": ssm_mod.mamba2_spec(cfg)}
    if kind == "mlstm":
        return {"ln1": norm_spec(cfg), "mixer": xlstm_mod.mlstm_spec(cfg)}
    if kind == "slstm":
        return {"ln1": norm_spec(cfg), "mixer": xlstm_mod.slstm_spec(cfg)}
    raise ValueError(f"unknown block kind {kind!r}")


def _stack_specs(tree, g: int):
    """Prepend a stacked 'layers' axis of size g to every ShapeAxes leaf."""
    if isinstance(tree, ShapeAxes):
        return spec((g, *tree.shape), ("layers", *tree.axes), tree.dtype)
    return {k: _stack_specs(v, g) for k, v in tree.items()}


def _encoder_block_spec(cfg: ModelConfig) -> dict:
    """One encoder layer: non-causal self-attention and a dense FFN."""
    return {"ln1": norm_spec(cfg), "attn": attn.attn_spec(cfg), "ln2": norm_spec(cfg), "ffn": ffn_spec(cfg)}


def _top_specs(cfg: ModelConfig) -> dict:
    """Every parameter outside the layers: the embedding, the final norm,
    the untied lm_head, and zamba2's shared attention+FFN block."""
    p: dict[str, Any] = {
        "embed": spec((cfg.vocab_padded, cfg.d_model), ("vocab", "embed")),
        "final_norm": norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = spec((cfg.d_model, cfg.vocab_padded), ("embed", "vocab"))
    if cfg.shared_attn_every:
        p["shared_attn"] = {
            "ln1": norm_spec(cfg),
            "attn": attn.attn_spec(cfg),
            "ln2": norm_spec(cfg),
            "ffn": ffn_spec(cfg),
        }
    return p


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree in the JAX package's layout (each slot stacked
    over its G groups), as ``repro.models.transformer.param_specs``."""
    check_supported(cfg)
    prefix, pattern, g, tail = _layout(cfg)
    cross = cfg.is_encdec
    p = _top_specs(cfg)
    if prefix:
        p["prefix"] = [block_spec(cfg, k, cross) for k in prefix]
    if g:
        p["groups"] = {str(slot): _stack_specs(block_spec(cfg, pattern[slot], cross), g)
                       for slot in range(len(pattern))}
    if tail:
        p["tail"] = [block_spec(cfg, k, cross) for k in tail]
    if cfg.is_encdec:
        p["encoder"] = {"blocks": _stack_specs(_encoder_block_spec(cfg), cfg.n_enc_layers),
                        "final_norm": norm_spec(cfg)}
    return p


def param_count(cfg: ModelConfig) -> int:
    """Parameters counted from the specs, never materialised."""
    return sum(math.prod(leaf.shape) for _, leaf in spec_leaves(param_specs(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters a token meets: the MoE layers count the shared experts
    and top_k of the routed ones."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.expert_d_ff
    n_moe = sum(1 for k in cfg.blocks() if _is_attn(k) and not k.endswith("_dense"))
    return total - n_moe * (m.n_experts - m.top_k) * per_expert


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------


def _attn_cache_spec(cfg, batch: int, seq: int, cross_len: int = 0) -> dict:
    """The K/V cache of one attention layer, (B, seq, Kv, Dh) in
    ``cfg.dtype``; with ``cross_len`` also the encoder memory's K/V for the
    cross-attention, ``ck`` and ``cv`` (B, cross_len, Kv, Dh)."""
    shape, axes = (batch, seq, cfg.n_kv_heads, cfg.head_dim), ("batch", "kv_seq", "kv_heads", None)
    c = {"k": spec(shape, axes, cfg.dtype), "v": spec(shape, axes, cfg.dtype)}
    if cross_len:
        cshape, caxes = (batch, cross_len, cfg.n_kv_heads, cfg.head_dim), ("batch", None, "kv_heads", None)
        c["ck"] = spec(cshape, caxes, cfg.dtype)
        c["cv"] = spec(cshape, caxes, cfg.dtype)
    return c


def _cross_len(cfg: ModelConfig) -> int:
    """Positions of the cross K/V in each decoder layer's cache (0 without
    an encoder)."""
    return cfg.frontend_len if cfg.is_encdec else 0


def _kind_cache_spec(cfg, kind: str, batch: int, seq: int, cross_len: int = 0):
    if _is_attn(kind):
        return _attn_cache_spec(cfg, batch, seq, cross_len)
    if kind == "mamba2":
        return ssm_mod.mamba2_cache_spec(cfg, batch)
    if kind == "mlstm":
        return xlstm_mod.mlstm_cache_spec(cfg, batch)
    if kind == "slstm":
        return xlstm_mod.slstm_cache_spec(cfg, batch)
    raise ValueError(f"unknown block kind {kind!r}")


def cache_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The decode cache in the JAX package's layout (stacked by group):
    K/V of ``seq`` positions for the attention kinds; the recurrent kinds'
    state does not grow with ``seq``."""
    check_supported(cfg)
    prefix, pattern, g, tail = _layout(cfg)
    cross = _cross_len(cfg)
    c: dict[str, Any] = {}
    if prefix:
        c["prefix"] = [_kind_cache_spec(cfg, k, batch, seq, cross) for k in prefix]
    if g:
        c["groups"] = {
            str(slot): _stack_specs(_kind_cache_spec(cfg, pattern[slot], batch, seq, cross), g)
            for slot in range(len(pattern))
        }
    if tail:
        c["tail"] = [_kind_cache_spec(cfg, k, batch, seq, cross) for k in tail]
    if cfg.shared_attn_every and g:
        c["shared"] = _stack_specs(_attn_cache_spec(cfg, batch, seq), g)
    return c


def n_shared_runs(cfg: ModelConfig) -> int:
    """How many times the shared attention block runs in a forward: once a
    group (0 without the block)."""
    return _layout(cfg)[2] if cfg.shared_attn_every else 0


def init_cache(cfg: ModelConfig, batch: int, seq: int, device=None) -> list[dict[str, torch.Tensor]]:
    """A zero decode cache in the port's layout: one dict per layer, in
    layer order (an encoder-decoder's with the cross K/V, ``ck`` and
    ``cv``), then one K/V dict for each run of the shared attention block
    (entry ``n_layers + g`` for group g); each leaf in ``cfg.dtype`` on
    ``device`` (the card unless the CPU is asked for).  ``seq`` counts every
    position the decoder attends to, a frontend's prefix included."""
    dev = resolve_device(device)
    return [{k: torch.zeros(s.shape, dtype=torch_dtype(s.dtype), device=dev) for k, s in leaves.items()}
            for leaves in cache_leaf_specs(cfg, batch, seq)]


def cache_leaf_specs(cfg: ModelConfig, batch: int, seq: int) -> list[dict[str, ShapeAxes]]:
    """``init_cache``'s layout as ShapeAxes (their logical axes place a
    sharded cache): one dict a layer, then one a run of the shared block."""
    check_supported(cfg)
    specs = [_kind_cache_spec(cfg, kind, batch, seq, _cross_len(cfg)) for kind in cfg.blocks()]
    return specs + [_attn_cache_spec(cfg, batch, seq) for _ in range(n_shared_runs(cfg))]


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class Model(nn.Module):
    """The parameters of one model: ``embed``, ``final_norm`` (and
    ``lm_head`` when untied, ``shared_attn`` with a shared block), and
    ``layers``, one ``ParamTree`` per layer in layer order; an
    encoder-decoder also has ``encoder``, one ``ParamTree`` per encoder
    layer, and ``encoder_norm``.  Built on
    ``device`` (the card when None), drawn by ``init_from_specs`` from
    ``generator`` (seeded 0 on that device when
    None), or taken from ``params`` (a dict in the same layout, as
    ``convert.model_params_from_reference`` makes one)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict | None = None,
        *,
        device=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            specs = {**_top_specs(cfg), "layers": [block_spec(cfg, k, cfg.is_encdec) for k in cfg.blocks()]}
            if cfg.is_encdec:
                specs["encoder"] = {"layers": [_encoder_block_spec(cfg)] * cfg.n_enc_layers,
                                    "final_norm": norm_spec(cfg)}
            params = init_from_specs(specs, generator, dev)
        self.embed = nn.Parameter(params["embed"].to(dev))
        self.final_norm = ParamTree({k: v.to(dev) for k, v in params["final_norm"].items()})
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(params["lm_head"].to(dev))
        if cfg.shared_attn_every:
            self.shared_attn = ParamTree(_to(params["shared_attn"], dev))
        self.layers = nn.ModuleList(ParamTree(_to(p, dev)) for p in params["layers"])
        if cfg.is_encdec:
            self.encoder = nn.ModuleList(ParamTree(_to(p, dev)) for p in params["encoder"]["layers"])
            self.encoder_norm = ParamTree(_to(params["encoder"]["final_norm"], dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# Block application and the stack
# ---------------------------------------------------------------------------


def _residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y``, a branch's output placed as the residual stream first:
    on a mesh the output of a projection that contracts over sharded
    heads or mlp is a Partial sum, reduced here (the all-reduce the
    reference's partitioner puts after it) so that the norms and matmuls
    after it run on the rank's own rows; the identity unsharded."""
    return x + constrain(y, ("batch", "seq", None))


def _apply_ffn_part(cfg, p, x: torch.Tensor, aux: dict) -> tuple[torch.Tensor, dict]:
    """The FFN half of an attention block, residual: the MoE (its aux
    losses added to ``aux``), the dense FFN, or nothing."""
    h = apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        y, a = moe_mod.apply_moe(cfg, p["moe"], h)
        aux = {k: aux[k] + a[k] for k in aux}
    elif "ffn" in p:
        y = apply_ffn(cfg, p["ffn"], h)
    else:
        return x, aux
    if cfg.post_norm:
        y = apply_norm(cfg, p["ln2_post"], y)
    return _residual(x, y), aux


def _self_attention(cfg, p, h, q_pos, *, mode, cache, pos, window, chunk):
    """Causal self-attention of the normed h in every mode.  In prefill
    the sequence's K/V are padded out to the cache length, as in the JAX
    package; in decode the cache is written in place.  Returns (y, K/V or
    None)."""
    if mode == "train":
        return attn.attention(cfg, p, h, q_pos, causal=True, window=window, chunk=chunk), None
    if mode == "prefill":
        y, kv = attn.attention_with_cache(cfg, p, h, q_pos, window=window, chunk=chunk)
        pad = cache["k"].shape[1] - kv["k"].shape[1]
        return y, {name: constrain(F.pad(t, (0, 0, 0, 0, 0, pad)).to(cache[name].dtype),
                                   ("batch", "kv_seq", "kv_heads", None)) for name, t in kv.items()}
    return attn.decode_attention(cfg, p, h, pos, cache, window=window)


def _cross_attention(cfg, p, h, q_pos, *, mode, cache, memory, chunk):
    """The encoder-decoder's cross-attention of the normed h over the
    encoder's output ``memory``: no RoPE, non-causal (train, prefill); in
    prefill also the memory's K/V for the cache, in decode the cached K/V,
    carried on unchanged.  Returns (y, {"ck", "cv"} or None)."""
    if mode == "decode":
        return _cross_decode(cfg, p, h, cache["ck"], cache["cv"]), {"ck": cache["ck"], "cv": cache["cv"]}
    kp = torch.arange(memory.shape[1], dtype=torch.int32, device=memory.device)
    y = attn.attention(cfg, p, h, q_pos, causal=False, kv_x=memory, kv_pos=kp, rope=False, chunk=chunk)
    if mode == "train":
        return y, None
    dt, axes = cache["ck"].dtype, ("batch", None, "kv_heads", None)
    return y, {"ck": constrain(attn._heads(memory, p["wk"]).to(dt), axes),
               "cv": constrain(attn._heads(memory, p["wv"]).to(dt), axes)}


def _cross_decode(cfg, p, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """Single-token cross-attention against the cached encoder K/V, as the
    JAX package rounds it: q divided by sqrt(Dh) in x's dtype, the scores'
    softmax in f32, p cast back to x's dtype for PV."""
    dt = x.dtype

    def core(q, ck, cv):
        b, _, h, dh = q.shape
        qg = attn._grouped(q, ck.shape[2])
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg / math.sqrt(dh), ck.to(dt))
        pr = torch.softmax(s.float(), dim=-1)
        out = torch.einsum("bhgqk,bkhd->bhgqd", pr.to(dt), cv.to(dt))
        return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, dh)

    q = constrain(attn._heads(x, p["wq"]), ("batch", "seq", "heads", None))
    return attn._out_proj(p, local_heads(core, q, ck, cv), dt)


def _attn_block(cfg, kind, p, x, q_pos, *, mode, cache, pos, memory, chunk, aux):
    """Attention (with post-norm), the cross-attention of an
    encoder-decoder, and the FFN part, each residual."""
    y, kv = _self_attention(cfg, p["attn"], apply_norm(cfg, p["ln1"], x), q_pos, mode=mode, cache=cache,
                            pos=pos, window=_window(cfg, kind), chunk=chunk)
    if cfg.post_norm:
        y = apply_norm(cfg, p["ln1_post"], y)
    x = _residual(x, y)
    if "cross" in p:
        y, ckv = _cross_attention(cfg, p["cross"], apply_norm(cfg, p["ln_cross"], x), q_pos, mode=mode,
                                  cache=cache, memory=memory, chunk=chunk)
        x = _residual(x, y)
        if ckv is not None:
            kv = {**kv, **ckv}
    x, aux = _apply_ffn_part(cfg, p, x, aux)
    return x, kv, aux


def _shared_attn_block(cfg, p, x, q_pos, *, mode, cache, pos, chunk):
    """zamba2's weight-shared attention+FFN block (full causal attention,
    a dense FFN), run once a group.  Returns (x, K/V or None)."""
    y, kv = _self_attention(cfg, p["attn"], apply_norm(cfg, p["ln1"], x), q_pos, mode=mode, cache=cache,
                            pos=pos, window=0, chunk=chunk)
    x = _residual(x, y)
    return _residual(x, apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x))), kv


def apply_block(
    cfg: ModelConfig,
    kind: str,
    p,
    x: torch.Tensor,
    q_pos: torch.Tensor | None,
    *,
    mode: str,
    cache: dict | None = None,
    pos=None,
    memory: torch.Tensor | None = None,
    chunk: int = 1024,
    aux: dict,
):
    """One block, pre-norm and residual.  ``mode`` is 'train', 'prefill'
    or 'decode'; ``q_pos`` the positions of x's tokens (train, prefill),
    ``pos`` the decode position; ``memory`` the encoder's output, which an
    encoder-decoder's layers cross-attend to (train, prefill); ``aux`` the
    MoE aux losses so far.  Returns (x, new_cache, aux); prefill ignores
    the incoming cache's contents and builds it from the sequence, as in
    JAX."""
    x = constrain(x, ("batch", "seq", None))
    if _is_attn(kind):
        return _attn_block(cfg, kind, p, x, q_pos, mode=mode, cache=cache, pos=pos, memory=memory, chunk=chunk,
                           aux=aux)
    h = apply_norm(cfg, p["ln1"], x)
    if kind == "mamba2":
        if mode == "decode":
            y, new_cache = ssm_mod.mamba2_decode(cfg, p["mixer"], h, cache)
        else:
            y, new_cache = ssm_mod.apply_mamba2(cfg, p["mixer"], h)
    elif kind == "mlstm":
        if mode == "decode":
            y, new_cache = xlstm_mod.mlstm_decode(cfg, p["mixer"], h, cache)
        else:
            y, new_cache = xlstm_mod.apply_mlstm(cfg, p["mixer"], h)
    elif kind == "slstm":
        if mode == "decode":
            y, new_cache = xlstm_mod.slstm_decode(cfg, p["mixer"], h, cache)
        else:
            y, new_cache = xlstm_mod.apply_slstm(cfg, p["mixer"], h)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if mode == "train":
        new_cache = None
    return _residual(x, y), new_cache, aux


_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the matmuls' outputs, recompute the rest
    (``jax.checkpoint_policies.checkpoint_dots``)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _stack_units(cfg: ModelConfig) -> list[tuple[int | None, list[int], bool]]:
    """The stack in run order as (shared run or None, layers, is a group):
    each prefix layer alone, each group (its shared run, when there is one,
    then its P slots), each tail layer alone."""
    prefix, pattern, g, tail = _layout(cfg)
    n_shared = n_shared_runs(cfg)
    units: list[tuple[int | None, list[int], bool]] = [(None, [i], False) for i in range(len(prefix))]
    for gi in range(g):
        first = len(prefix) + gi * len(pattern)
        units.append((gi if gi < n_shared else None, list(range(first, first + len(pattern))), True))
    first = len(prefix) + g * len(pattern)
    units += [(None, [i], False) for i in range(first, first + len(tail))]
    return units


def _run_stack(
    cfg: ModelConfig,
    model: Model,
    x: torch.Tensor,
    q_pos: torch.Tensor | None,
    *,
    mode: str,
    cache: list | None,
    pos=None,
    memory: torch.Tensor | None = None,
    chunk: int = 1024,
):
    """Apply every layer in order (prefix, then groups g = 0..G-1 with their
    slots, each group led by the shared block when there is one, then
    tail).  In train mode under autograd with ``cfg.remat`` "full" or
    "dots", each group runs under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint`` of its scanned group body; "dots" keeps
    the matmul outputs); prefix and tail layers are not checkpointed, as
    there.  Returns (x, new cache or None, aux)."""
    blocks = cfg.blocks()
    aux = _zero_aux(x.device)
    new_cache: list = [None] * (len(blocks) + n_shared_runs(cfg))
    remat = mode == "train" and cfg.remat != "none" and torch.is_grad_enabled()
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r} (want 'none', 'full' or 'dots')")

    def run_unit(shared, layers, x, aux_loss, z_loss):
        a = {"aux_loss": aux_loss, "z_loss": z_loss}
        if shared is not None:
            j = len(blocks) + shared
            x, new_cache[j] = _shared_attn_block(cfg, model.shared_attn, x, q_pos, mode=mode,
                                                 cache=cache[j] if cache else None, pos=pos, chunk=chunk)
        for i in layers:
            x, new_cache[i], a = apply_block(
                cfg, blocks[i], model.layers[i], x, q_pos, mode=mode, cache=cache[i] if cache else None,
                pos=pos, memory=memory, chunk=chunk, aux=a,
            )
        return x, a["aux_loss"], a["z_loss"]

    for shared, layers, group in _stack_units(cfg):
        args = (shared, layers, x, aux["aux_loss"], aux["z_loss"])
        if remat and group:
            ctx = {} if cfg.remat == "full" else {
                "context_fn": functools.partial(create_selective_checkpoint_contexts, _dots_policy)}
            out = checkpoint(run_unit, *args, use_reentrant=False, **ctx)
        else:
            out = run_unit(*args)
        x, aux = out[0], {"aux_loss": out[1], "z_loss": out[2]}
    return x, (new_cache if mode != "train" else None), aux


# ---------------------------------------------------------------------------
# Embedding / logits / encoder
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, model: Model, tokens: torch.Tensor,
                 frontend_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """The table's rows, cast to ``cfg.dtype`` (times sqrt(d_model) with
    ``embed_scale``); a decoder-only model's ``frontend_embeds`` (B, F, D),
    cast to that dtype, go in front of them."""
    x = _lookup(use_weight(model.embed), tokens).to(torch_dtype(cfg.dtype))
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    if frontend_embeds is not None and not cfg.is_encdec:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    return constrain(x, ("batch", "seq", None))


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table is read on each rank's shards,
    as the reference's partitioned gather: the rank's batch rows of the
    ids against its slice of the vocabulary, rows of other slices zero,
    summed over the vocabulary's ranks by the next constraint (a Partial
    sum); the table's gradient comes back a Partial sum over the batch's
    ranks.  (DTensor's own strategy for the lookup's backward fails on
    some torch releases.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    n = mesh.ndim
    vocab = [j for j in range(n) if table.placements[j].is_shard(0)]
    batch = [j for j in range(n) if j not in vocab and tokens.placements[j].is_shard(0)]
    t_pl = [Shard(0) if j in vocab else Replicate() for j in range(n)]
    ids_pl = [Shard(0) if j in batch else Replicate() for j in range(n)]
    table, tokens = table.redistribute(mesh, t_pl), redistributed(tokens, mesh, ids_pl)
    local = table.to_local(grad_placements=[Partial() if j in batch else p for j, p in enumerate(t_pl)])
    ids = tokens.to_local()
    if math.prod(mesh.size(j) for j in vocab) > 1:
        ids = ids - local_offset(table, 0)
        mine = (ids >= 0) & (ids < local.shape[0])
        x = local[ids.clamp(0, local.shape[0] - 1)] * mine[..., None].to(local.dtype)
    else:
        x = local[ids]
    shape = (*tokens.shape, table.shape[1])
    return DTensor.from_local(x, mesh, [Partial() if j in vocab else p for j, p in enumerate(ids_pl)], shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def logits_from(cfg: ModelConfig, model: Model, x: torch.Tensor) -> torch.Tensor:
    """f32 logits over the padded vocabulary; padded ids masked to -1e30."""
    h = apply_norm(cfg, model.final_norm, x)
    if cfg.tie_embeddings:
        lg = h @ use_weight(model.embed).to(h.dtype).T
    else:
        lg = h @ use_weight(model.lm_head).to(h.dtype)
    lg = lg.float()
    if cfg.final_softcap:
        lg = softcap(lg, cfg.final_softcap)
    if cfg.vocab_padded > cfg.vocab:
        # padded vocabulary ids never win sampling
        ids = torch.arange(cfg.vocab_padded, device=lg.device)
        lg = torch.where(ids < cfg.vocab, lg, -1e30)
    return lg


def encode(cfg: ModelConfig, model: Model, frames: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """The encoder stack over the stub frame embeddings (B, S_enc, D), cast
    to ``cfg.dtype`` (no embed scale): each layer non-causal self-attention
    with RoPE over the frame positions and a dense FFN, pre-norm and
    residual, then the encoder's final norm."""
    x = frames.to(torch_dtype(cfg.dtype))
    q_pos = _positions(x)
    for p in model.encoder:
        x = _residual(x, attn.attention(cfg, p["attn"], apply_norm(cfg, p["ln1"], x), q_pos, causal=False,
                                        chunk=chunk))
        x = _residual(x, apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x)))
    return apply_norm(cfg, model.encoder_norm, x)


def _zero_aux(device) -> dict:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"aux_loss": z, "z_loss": z.clone()}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _positions(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def _decoder_input(cfg: ModelConfig, model: Model, tokens, frontend_embeds, chunk: int):
    """(the decoder's input embeddings, the encoder's output or None): an
    encoder-decoder encodes ``frontend_embeds`` and embeds the tokens
    alone; any other model prepends them, when given, to the tokens."""
    if not cfg.is_encdec:
        return embed_tokens(cfg, model, tokens, frontend_embeds), None
    if frontend_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass the frame embeddings, frontend_embeds")
    return embed_tokens(cfg, model, tokens), encode(cfg, model, frontend_embeds, chunk)


def forward_train(cfg: ModelConfig, model: Model, tokens: torch.Tensor, frontend_embeds: torch.Tensor | None = None,
                  *, chunk: int = 1024, return_hidden: bool = False):
    """Returns (logits over the token positions (B, S_tok, V_padded) f32,
    aux); with ``return_hidden`` the final hidden states (B, S_tok, D)
    instead of logits (the chunked CE forms the logits chunk by chunk).
    Differentiable: under autograd in train mode each layer group is
    checkpointed as ``cfg.remat`` says (``_run_stack``).
    ``frontend_embeds`` (B, F, D): an encoder-decoder's
    frames, or the prefix a decoder-only model's tokens follow.  ``chunk``
    is the chunked attention oracle's KV chunk; ``aux`` the MoE layers'
    summed aux and z losses (zeros without MoE)."""
    x, memory = _decoder_input(cfg, model, tokens, frontend_embeds, chunk)
    x, _, aux = _run_stack(cfg, model, x, _positions(x), mode="train", cache=None, memory=memory, chunk=chunk)
    if frontend_embeds is not None and not cfg.is_encdec:
        x = x[:, frontend_embeds.shape[1] :, :]
    if return_hidden:
        return x, aux
    return logits_from(cfg, model, x), aux


def prefill(cfg: ModelConfig, model: Model, tokens: torch.Tensor, cache: list,
            frontend_embeds: torch.Tensor | None = None, *, chunk: int = 1024):
    """Full forward building the decode cache (``frontend_embeds`` as in
    ``forward_train``; a prefix counts in the cache's positions).  Returns
    (logits of the last position (B, 1, V_padded), cache)."""
    x, memory = _decoder_input(cfg, model, tokens, frontend_embeds, chunk)
    x, new_cache, _ = _run_stack(cfg, model, x, _positions(x), mode="prefill", cache=cache, memory=memory,
                                 chunk=chunk)
    return logits_from(cfg, model, x[:, -1:, :]), new_cache


def decode_step(cfg: ModelConfig, model: Model, token: torch.Tensor, pos, cache: list):
    """token (B, 1) int; ``pos`` the token's position (an int; after a
    frontend's prefix it counts the prefix); returns (logits (B, 1,
    V_padded), cache').  The attention layers write their K/V into the
    cache in place; an encoder-decoder's cross K/V are read, not written."""
    x = embed_tokens(cfg, model, token)
    x, new_cache, _ = _run_stack(cfg, model, x, None, mode="decode", cache=cache, pos=pos)
    return logits_from(cfg, model, x), new_cache
