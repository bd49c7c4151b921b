"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX
package's, on the CPU.

``reduced(seamless-m4t-large-v2)`` on both sides: 2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16, LayerNorm, the GELU MLP, an untied
lm_head, 4 frames.  The JAX package draws the parameters;
``convert.model_params_from_reference`` hands them to the port.  Seeded
numpy tokens (B = 2, S = 37, not a multiple of the oracle's chunk of 16)
and seeded numpy frame embeddings go through both.

The pieces first: ``attention`` as cross-attention (K/V from the memory,
no RoPE, non-causal, Sq ≠ Skv), ``_cross_decode`` and ``encode``.  Then
the whole model: ``forward_train`` logits, hidden states and the chunked
CE; ``prefill`` logits and every cache leaf, the cross K/V (``ck``,
``cv``) included; one ``decode_step``; the cache round trip bit for bit;
the parameter count at full width.  The flash kernel path runs at
``frontend_len=16``: the JAX package's non-causal flash refuses a KV
length that is not a multiple of its key block (``repro/kernels/ops.py``,
"non-causal flash requires Skv % block_k == 0"), which the reduced
default of 4 frames is not; the port takes any length
(``test_port_flash_takes_a_ragged_memory``).  With the flash path off,
the reduced default and 20 frames (the oracle pads 20 keys to 32).

Tolerances, as tests/test_torch_gemma2.py: float32 1e-4 (the sums run in
other orders); bfloat16 3e-2, the JAX smoke test's bound, the unnormed
hidden states held normwise there; the CE within 1e-5 (f32) and 1e-3
(bf16).  ``TokenStream.batch_at`` equals the JAX package's bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.data.pipeline import TokenStream as JTokenStream
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.models.layers import init_from_specs as jax_init
from repro.sharding import ShapeAxes
from repro.train.losses import chunked_softmax_ce as jax_ce
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.train.losses import chunked_softmax_ce
from repro_torch.train.steps import make_decode_step, make_prefill_step

ARCH = "seamless-m4t-large-v2"
B, S, CHUNK = 2, 37, 16
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CE_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
PARITY_TOL = 3e-2  # tests/test_models_smoke.py's prefill/decode tolerance
# (flash_kernel, frontend_len): the flash path at a length the JAX package's
# non-causal flash takes; the oracle at the reduced default and past a chunk
CASES = [(False, 4), (False, 20), (True, 16)]


def _configs(dtype: str = "float32", **kw):
    j = JC.reduced(JC.get(ARCH)).scaled(dtype=dtype, **kw)
    t = TC.reduced(TC.get(ARCH)).scaled(dtype=dtype, **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_host(got), _host(want), rtol=tol, atol=tol)


def _both(a: np.ndarray, dtype: str):
    return jnp.asarray(a).astype(jnp.dtype(dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _frames(jcfg, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(B, jcfg.frontend_len, jcfg.d_model)).astype(np.float32)


def _setup(flash: bool, frontend_len: int, dtype: str):
    jcfg, tcfg = _configs(dtype, flash_kernel=flash, frontend_len=frontend_len)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.model_params_from_reference(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    return jcfg, tcfg, jparams, model, toks, torch.from_numpy(toks).long(), _frames(jcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash,skv", [(False, 4), (False, 20), (True, 16)])
def test_cross_attention_matches_jax(flash, skv, dtype):
    """``attention`` with ``kv_x`` (the memory), ``kv_pos`` and
    ``rope=False``, non-causal, 37 queries over ``skv`` keys."""
    jcfg, tcfg = _configs(dtype, flash_kernel=flash)
    jp = jax_init(jax.random.PRNGKey(3), JA.attn_spec(jcfg, cross=True))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    assert sorted(TA.attn_spec(tcfg, cross=True)) == sorted(jp)
    rng = np.random.default_rng(4)
    jx, tx = _both(rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32), dtype)
    jm, tm = _both(rng.normal(size=(B, skv, jcfg.d_model)).astype(np.float32), dtype)
    q_pos, k_pos = np.arange(S, dtype=np.int32), np.arange(skv, dtype=np.int32)
    want = JA.attention(jcfg, jp, jx, jnp.asarray(q_pos), causal=False, kv_x=jm, kv_pos=jnp.asarray(k_pos),
                        rope=False, chunk=CHUNK)
    got = TA.attention(tcfg, tp, tx, torch.from_numpy(q_pos), causal=False, kv_x=tm, kv_pos=torch.from_numpy(k_pos),
                       rope=False, chunk=CHUNK)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, jcfg.d_model)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_decode_matches_jax(dtype):
    """One token against random cached K/V of 20 frames: q divided by
    sqrt(Dh) in the compute dtype, the softmax in f32."""
    jcfg, tcfg = _configs(dtype)
    jp = jax_init(jax.random.PRNGKey(3), JA.attn_spec(jcfg, cross=True))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(6)
    jx, tx = _both(rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32), dtype)
    kv_shape = (B, 20, jcfg.n_kv_heads, jcfg.head_dim)
    (jk, tk), (jv, tv) = (_both(rng.normal(size=kv_shape).astype(np.float32), dtype) for _ in range(2))
    want = JT._cross_decode(jcfg, jp, jx, jk, jv)
    got = TT._cross_decode(tcfg, tp, tx, tk, tv)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, 1, jcfg.d_model)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash,frontend_len", CASES)
def test_encode_matches_jax(flash, frontend_len, dtype):
    """The encoder stack over the frames (non-causal, RoPE over the frame
    positions, the encoder's final norm): normed, so held elementwise."""
    jcfg, tcfg, jparams, model, _, _, frames = _setup(flash, frontend_len, dtype)
    assert len(model.encoder) == jcfg.n_enc_layers == 2
    want = JT.encode(jcfg, jparams, jnp.asarray(frames), chunk=CHUNK)
    with torch.inference_mode():
        got = TT.encode(tcfg, model, torch.from_numpy(frames), chunk=CHUNK)
    assert got.dtype == getattr(torch, dtype) and got.shape == frames.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash,frontend_len", CASES)
def test_seamless_forward_matches_jax(flash, frontend_len, dtype):
    """Logits over the decoder's tokens, then the hidden states and the
    chunked CE with every fifth label at -1."""
    jcfg, tcfg, jparams, model, toks, ttoks, frames = _setup(flash, frontend_len, dtype)
    tol = TOL[dtype]
    labels = np.roll(toks, -1, axis=1)
    labels[:, ::5] = -1
    jhid, _ = JT.forward_train(jcfg, jparams, jnp.asarray(toks), jnp.asarray(frames), chunk=CHUNK,
                               return_hidden=True)
    jce, jn = jax_ce(jcfg, jparams, jhid, jnp.asarray(labels), chunk=32)
    tframes = torch.from_numpy(frames)
    with torch.inference_mode():
        tfull, aux = TT.forward_train(tcfg, model, ttoks, tframes, chunk=CHUNK)
        thid, _ = TT.forward_train(tcfg, model, ttoks, tframes, chunk=CHUNK, return_hidden=True)
        tce, tn = chunked_softmax_ce(tcfg, model, thid, torch.from_numpy(labels), chunk=32)
    assert tfull.shape == (B, S, tcfg.vocab_padded) and tfull.dtype == torch.float32
    assert float(aux["aux_loss"]) == 0.0
    _close(tfull, JT.logits_from(jcfg, jparams, jhid), tol)
    assert thid.shape == (B, S, tcfg.d_model) and int(tn) == int(jn)
    if dtype == "float32":
        _close(thid, jhid, tol)
    else:  # the residual stream, unnormed: held normwise
        got, want = _host(thid), _host(jhid)
        assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)
    np.testing.assert_allclose(float(tce), float(jce), rtol=CE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash,frontend_len", CASES)
def test_seamless_serving_matches_jax(flash, frontend_len, dtype):
    """Prefill of S-1 = 36 tokens with the frames (through ``make_prefill_step``'s
    ``"frontend"``) into a cache of S, then one decode step: logits and
    every cache leaf, each layer's K/V and its cross K/V; the cross K/V
    carried through decode unchanged; the port's own prefill/decode parity
    against its forward."""
    jcfg, tcfg, jparams, model, toks, ttoks, frames = _setup(flash, frontend_len, dtype)
    tol = TOL[dtype]
    jcache0 = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), JT.cache_specs(jcfg, B, S),
                           is_leaf=lambda x: isinstance(x, ShapeAxes))
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :-1]), jcache0, jnp.asarray(frames), chunk=CHUNK)
    tframes = torch.from_numpy(frames)
    tlg, tcache = make_prefill_step(tcfg, chunk=CHUNK)(
        model, {"tokens": ttoks[:, :-1], "frontend": tframes}, TT.init_cache(tcfg, B, S, "cpu"))
    _close(tlg, jlg, tol)
    assert sorted(tcache[0]) == ["ck", "cv", "k", "v"]
    assert tcache[0]["ck"].shape == (B, frontend_len, tcfg.n_kv_heads, tcfg.head_dim)
    got, want = convert.cache_to_reference(tcfg, tcache), jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        _close(g, w, tol)
    ck = [c["ck"].clone() for c in tcache]
    jd, jcache2 = JT.decode_step(jcfg, jparams, jnp.asarray(toks[:, -1:]), jnp.int32(S - 1), jcache)
    td, tcache2 = make_decode_step(tcfg)(model, {"token": ttoks[:, -1:], "pos": S - 1}, tcache)
    _close(td, jd, tol)
    for g, w in zip(jax.tree.leaves(convert.cache_to_reference(tcfg, tcache2)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jcache2))):
        _close(g, w, tol)
    assert all(torch.equal(c["ck"], k) for c, k in zip(tcache2, ck))
    with torch.inference_mode():
        tfull, _ = TT.forward_train(tcfg, model, ttoks, tframes, chunk=CHUNK)
    _close(td[:, 0], tfull[:, -1], PARITY_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_flash_takes_a_ragged_memory(dtype):
    """At the reduced default of 4 frames the JAX package's non-causal
    flash refuses (4 keys pad to 8); the port's flash path takes them and
    agrees with the JAX package's oracle path at the dtype's tolerance."""
    jcfg, tcfg, jparams, model, toks, ttoks, frames = _setup(True, 4, dtype)
    with pytest.raises(AssertionError, match="non-causal flash"):
        JT.forward_train(jcfg, jparams, jnp.asarray(toks), jnp.asarray(frames), chunk=CHUNK)
    want, _ = JT.forward_train(jcfg.scaled(flash_kernel=False), jparams, jnp.asarray(toks), jnp.asarray(frames),
                               chunk=CHUNK)
    with torch.inference_mode():
        got, _ = TT.forward_train(tcfg, model, ttoks, torch.from_numpy(frames), chunk=CHUNK)
    _close(got, want, TOL[dtype])


def test_an_encoder_decoder_needs_its_frames():
    _, tcfg, _, model, _, ttoks, _ = _setup(False, 4, "float32")
    with pytest.raises(ValueError, match="frontend_embeds"):
        TT.forward_train(tcfg, model, ttoks)


def test_seamless_cache_round_trip_keeps_bits():
    """The JAX cache -> the port's -> back, bf16 leaves included, the cross
    K/V through the same per-layer walk as the layers' K/V."""
    jcfg, tcfg = _configs("bfloat16", frontend_len=20)
    rng = np.random.default_rng(1)
    jcache = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape), s.dtype),
                          JT.cache_specs(jcfg, B, S), is_leaf=lambda x: isinstance(x, ShapeAxes))
    tcache = convert.cache_from_reference(tcfg, jax.tree.map(np.asarray, jcache), "cpu")
    assert len(tcache) == tcfg.n_layers and tcache[1]["ck"].dtype == torch.bfloat16
    assert tcache[1]["ck"].shape == (B, 20, tcfg.n_kv_heads, tcfg.head_dim)
    back = convert.cache_to_reference(tcfg, tcache)
    assert jax.tree.structure(back) == jax.tree.structure(jcache)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
        np.testing.assert_array_equal(g, _host(w))
    # one slot ("full"), so layer g is group g
    np.testing.assert_array_equal(_host(tcache[1]["cv"]), _host(jcache["groups"]["0"]["cv"][1]))
    zero = TT.init_cache(tcfg, B, S, "cpu")
    assert [sorted(c) for c in zero] == [sorted(c) for c in tcache]
    assert all(zero[i][k].shape == tcache[i][k].shape for i in range(len(zero)) for k in zero[i])


def test_seamless_param_specs_and_count_match_jax():
    """The reduced trees leaf for leaf (each decoder layer's cross leaves,
    the encoder stacked on its layers), the port's model holding the same
    count, and the count at full width."""
    jcfg, tcfg = _configs()
    leaves = lambda specs: [(leaf.shape, leaf.axes) for leaf in jax.tree.leaves(  # noqa: E731
        specs, is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "shape"))]
    assert leaves(TT.param_specs(tcfg)) == leaves(JT.param_specs(jcfg))
    model = TT.Model(tcfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == TT.param_count(tcfg) == JT.param_count(jcfg)
    assert "cross" in model.layers[0] and "ln_cross" in model.layers[0] and len(model.encoder) == 2
    full_t, full_j = TC.get(ARCH), JC.get(ARCH)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert TT.param_count(full_t) == JT.param_count(full_j) == 1_632_260_096


@pytest.mark.parametrize("frontend_len,d_model", [(0, 0), (4, 64)])
def test_token_stream_batch_equals_jax(frontend_len, d_model):
    """``batch_at`` is numpy in (seed, step) on both sides: equal bit for
    bit at every step; without a process group ``host_batch_at`` is the
    whole batch."""
    kw = dict(vocab=512, global_batch=3, seq_len=S, seed=7, frontend_len=frontend_len, d_model=d_model)
    ours, theirs = TokenStream(**kw), JTokenStream(**kw)
    for step in (0, 1, 12):
        got, want = ours.batch_at(step), theirs.batch_at(step)
        assert sorted(got) == sorted(want) == sorted(["tokens", "labels"] + (["frontend"] if frontend_len else []))
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert all(np.array_equal(a, b) for a, b in zip(ours.host_batch_at(2).values(), ours.batch_at(2).values()))


def test_token_stream_host_batch_strides_by_rank(monkeypatch):
    """In a group of 2, rank 1 draws rows 1::2 of the global batch, as the
    JAX package's host 1 of 2 does."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    kw = dict(vocab=512, global_batch=5, seq_len=8, seed=3, frontend_len=2, d_model=4)
    got, want = TokenStream(**kw).host_batch_at(4), JTokenStream(**kw).host_batch_at(4)
    assert got["tokens"].shape == (2, 8)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
