"""The port's patch frontend (phi-3-vision-4.2b) against the JAX package's,
on the CPU.

``reduced(phi-3-vision-4.2b)`` on both sides: the phi3-mini backbone
reduced (2 layers, d_model 64, 4 heads of 16, RMSNorm, SwiGLU) with 4
patch embeddings prepended to the tokens.  The JAX package draws the
parameters; ``convert.model_params_from_reference`` hands them to the
port.  Seeded numpy tokens (B = 2, S = 37) and seeded numpy patch
embeddings go through both, with the flash kernel path off and on (both
causal over the whole prefix + tokens, so the JAX package's flash takes
any length), in float32 and bfloat16.

Checked: ``embed_tokens`` puts the patches in front of the tokens after
the embed scale, cast to the compute dtype; ``forward_train`` logits,
hidden states and the chunked CE over the token positions only;
``prefill`` logits and every cache leaf, the K/V over the patch prefix
included; one ``decode_step`` at position ``frontend_len + S - 1``; the
cache round trip bit for bit; the parameter count at full width.
Tolerances as tests/test_torch_gemma2.py: float32 1e-4, bfloat16 3e-2
(hidden states normwise there); the CE within 1e-5 (f32) and 1e-3 (bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import transformer as JT
from repro.sharding import ShapeAxes
from repro.train.losses import chunked_softmax_ce as jax_ce
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import transformer as TT
from repro_torch.train.losses import chunked_softmax_ce
from repro_torch.train.steps import make_decode_step, make_prefill_step

ARCH = "phi-3-vision-4.2b"
B, S, CHUNK = 2, 37, 16
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CE_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
PARITY_TOL = 3e-2  # tests/test_models_smoke.py's prefill/decode tolerance


def _configs(dtype: str = "float32", **kw):
    j = JC.reduced(JC.get(ARCH)).scaled(dtype=dtype, **kw)
    t = TC.reduced(TC.get(ARCH)).scaled(dtype=dtype, **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()  # the parameters require grad, so an embedding carries a graph
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_host(got), _host(want), rtol=tol, atol=tol)


def _setup(flash: bool, dtype: str, **kw):
    jcfg, tcfg = _configs(dtype, flash_kernel=flash, **kw)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.model_params_from_reference(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    patches = rng.normal(size=(B, jcfg.frontend_len, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, model, toks, torch.from_numpy(toks).long(), patches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("embed_scale", [False, True])
def test_embed_tokens_prepends_the_patches(embed_scale, dtype):
    """The patches, cast to the compute dtype, go in front of the scaled
    token embeddings (the scale never touches them)."""
    jcfg, tcfg, jparams, model, toks, ttoks, patches = _setup(False, dtype, embed_scale=embed_scale)
    want = JT.embed_tokens(jcfg, jparams, jnp.asarray(toks), jnp.asarray(patches))
    got = TT.embed_tokens(tcfg, model, ttoks, torch.from_numpy(patches))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, jcfg.frontend_len + S, jcfg.d_model)
    np.testing.assert_array_equal(_host(got), _host(want))
    np.testing.assert_array_equal(_host(got[:, : jcfg.frontend_len]),
                                  _host(torch.from_numpy(patches).to(getattr(torch, dtype))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [False, True])
def test_phi3_vision_forward_matches_jax(flash, dtype):
    """Logits over the token positions only, then the hidden states and the
    chunked CE with every fifth label at -1."""
    jcfg, tcfg, jparams, model, toks, ttoks, patches = _setup(flash, dtype)
    tol = TOL[dtype]
    labels = np.roll(toks, -1, axis=1)
    labels[:, ::5] = -1
    jhid, _ = JT.forward_train(jcfg, jparams, jnp.asarray(toks), jnp.asarray(patches), chunk=CHUNK,
                               return_hidden=True)
    jce, jn = jax_ce(jcfg, jparams, jhid, jnp.asarray(labels), chunk=32)
    tpatches = torch.from_numpy(patches)
    with torch.inference_mode():
        tfull, _ = TT.forward_train(tcfg, model, ttoks, tpatches, chunk=CHUNK)
        thid, _ = TT.forward_train(tcfg, model, ttoks, tpatches, chunk=CHUNK, return_hidden=True)
        tce, tn = chunked_softmax_ce(tcfg, model, thid, torch.from_numpy(labels), chunk=32)
    assert tfull.shape == (B, S, tcfg.vocab_padded) and tfull.dtype == torch.float32
    _close(tfull, JT.logits_from(jcfg, jparams, jhid), tol)
    assert thid.shape == (B, S, tcfg.d_model) and int(tn) == int(jn)
    if dtype == "float32":
        _close(thid, jhid, tol)
    else:  # the residual stream, unnormed: held normwise
        got, want = _host(thid), _host(jhid)
        assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)
    np.testing.assert_allclose(float(tce), float(jce), rtol=CE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [False, True])
def test_phi3_vision_serving_matches_jax(flash, dtype):
    """Prefill of the patches and S-1 = 36 tokens (``make_prefill_step``'s
    ``"frontend"``) into a cache of frontend_len + S positions, then one
    decode step at frontend_len + S - 1: logits and every cache leaf (the
    prefix's K/V at positions 0..frontend_len-1); the port's own
    prefill/decode parity against its forward."""
    jcfg, tcfg, jparams, model, toks, ttoks, patches = _setup(flash, dtype)
    tol, n = TOL[dtype], jcfg.frontend_len + S
    jcache0 = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), JT.cache_specs(jcfg, B, n),
                           is_leaf=lambda x: isinstance(x, ShapeAxes))
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :-1]), jcache0, jnp.asarray(patches), chunk=CHUNK)
    tpatches = torch.from_numpy(patches)
    tlg, tcache = make_prefill_step(tcfg, chunk=CHUNK)(
        model, {"tokens": ttoks[:, :-1], "frontend": tpatches}, TT.init_cache(tcfg, B, n, "cpu"))
    _close(tlg, jlg, tol)
    assert sorted(tcache[0]) == ["k", "v"] and bool(tcache[0]["k"][:, : jcfg.frontend_len].abs().sum() > 0)
    got, want = convert.cache_to_reference(tcfg, tcache), jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        _close(g, w, tol)
    jd, jcache2 = JT.decode_step(jcfg, jparams, jnp.asarray(toks[:, -1:]), jnp.int32(n - 1), jcache)
    td, tcache2 = make_decode_step(tcfg)(model, {"token": ttoks[:, -1:], "pos": n - 1}, tcache)
    _close(td, jd, tol)
    for g, w in zip(jax.tree.leaves(convert.cache_to_reference(tcfg, tcache2)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jcache2))):
        _close(g, w, tol)
    with torch.inference_mode():
        tfull, _ = TT.forward_train(tcfg, model, ttoks, tpatches, chunk=CHUNK)
    _close(td[:, 0], tfull[:, -1], PARITY_TOL)


def test_phi3_vision_cache_round_trip_keeps_bits():
    """The JAX cache over the prefix and the tokens -> the port's -> back,
    bf16 leaves included."""
    jcfg, tcfg = _configs("bfloat16")
    n = jcfg.frontend_len + S
    rng = np.random.default_rng(1)
    jcache = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape), s.dtype),
                          JT.cache_specs(jcfg, B, n), is_leaf=lambda x: isinstance(x, ShapeAxes))
    tcache = convert.cache_from_reference(tcfg, jax.tree.map(np.asarray, jcache), "cpu")
    assert len(tcache) == tcfg.n_layers and tcache[0]["k"].shape == (B, n, tcfg.n_kv_heads, tcfg.head_dim)
    back = convert.cache_to_reference(tcfg, tcache)
    assert jax.tree.structure(back) == jax.tree.structure(jcache)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
        np.testing.assert_array_equal(g, _host(w))


def test_phi3_vision_param_specs_and_count_match_jax():
    """The frontend is a stub: the same parameters as phi3-mini, leaf for
    leaf, and the count at full width."""
    jcfg, tcfg = _configs()
    leaves = lambda specs: [(leaf.shape, leaf.axes) for leaf in jax.tree.leaves(  # noqa: E731
        specs, is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "shape"))]
    assert leaves(TT.param_specs(tcfg)) == leaves(JT.param_specs(jcfg))
    full_t, full_j = TC.get(ARCH), JC.get(ARCH)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert full_t.frontend == "patch" and full_t.frontend_len == 576 and full_t.head_dim == 96
    assert TT.param_count(full_t) == JT.param_count(full_j) == 3_722_578_944
    assert TT.param_count(full_t) == TT.param_count(TC.get("phi3-mini-3.8b"))
