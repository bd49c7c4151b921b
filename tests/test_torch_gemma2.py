"""The port's dense attention models against the JAX package's, on the CPU.

``reduced(gemma2-2b)`` (the same reduction on both sides: 4 layers of
(swa, full), d_model 64, 4 heads on 2, head_dim 16, window 32, vocab 512),
and the other dense decoders on the same modules: ``phi3-mini-3.8b``
(SwiGLU), ``stablelm-1.6b`` (LayerNorm, partial RoPE at 25%, untied
lm_head) and ``granite-20b`` (the GELU MLP, MQA).  Each with the flash
kernel path off and on, in float32 and bfloat16.  The JAX package draws
the parameters; ``convert.model_params_from_reference`` hands them to the
port.  B = 2, S = 72 seeded numpy tokens: past twice the window, and not a
multiple of the oracle's chunk of 16, so its ``PAD_POS`` padding is taken.

Checked: ``forward_train`` logits; ``forward_train(return_hidden=True)``
then ``chunked_softmax_ce`` with every fifth label at -1 (flash on and
off); ``prefill`` of ``toks[:, :-1]``, its logits and every K/V cache
leaf; ``decode_step`` at the last position; and the port's own
prefill/decode parity against its forward.  Tolerances:

* float32: 1e-4 (relative and absolute), as tests/test_torch_model.py: the
  two sides differ by the order of sums only, through 4 layers.
* bfloat16: 3e-2, the JAX smoke test's prefill/decode bound: both round
  every op's result to bf16, in places that differ.  The hidden states are
  the unnormed residual stream (values up to ~20 in gemma2, whose bf16 ulp
  there is 0.125), so a bf16 ulp of a large entry is a large error on a
  small one: in bf16 they are held normwise, ``‖got − want‖ <= 3e-2
  ‖want‖``, and elementwise through the logits.  The CE, a mean over 114
  tokens of values near 6, within 1e-5 in f32 and 1e-3 in bf16.
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

B, S, CHUNK = 2, 72, 16
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CE_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
PARITY_TOL = 3e-2  # tests/test_models_smoke.py's prefill/decode tolerance
ARCHS = ["gemma2-2b", "phi3-mini-3.8b", "stablelm-1.6b", "granite-20b"]


def _configs(arch: str, flash: bool, dtype: str):
    j = JC.reduced(JC.get(arch)).scaled(flash_kernel=flash, dtype=dtype)
    t = TC.reduced(TC.get(arch)).scaled(flash_kernel=flash, dtype=dtype)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_host(got), _host(want), rtol=tol, atol=tol)


def _zero_cache(jcfg):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), JT.cache_specs(jcfg, B, S),
                        is_leaf=lambda x: isinstance(x, ShapeAxes))


def _setup(arch, flash, dtype):
    jcfg, tcfg = _configs(arch, flash, dtype)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.model_params_from_reference(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    return jcfg, tcfg, jparams, model, toks, torch.from_numpy(toks).long()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_model_forward_matches_jax(arch, flash, dtype):
    """The full-sequence forward: logits, then the hidden states and the
    chunked CE (the JAX side's logits are its ``logits_from`` of its hidden
    states, which is what its ``forward_train`` returns)."""
    jcfg, tcfg, jparams, model, toks, ttoks = _setup(arch, flash, dtype)
    tol = TOL[dtype]
    labels = np.roll(toks, -1, axis=1)
    labels[:, ::5] = -1
    jhid, _ = JT.forward_train(jcfg, jparams, jnp.asarray(toks), chunk=CHUNK, return_hidden=True)
    jce, jn = jax_ce(jcfg, jparams, jhid, jnp.asarray(labels), chunk=32)
    with torch.inference_mode():
        tfull, aux = TT.forward_train(tcfg, model, ttoks, chunk=CHUNK)
        thid, _ = TT.forward_train(tcfg, model, ttoks, chunk=CHUNK, return_hidden=True)
        tce, tn = chunked_softmax_ce(tcfg, model, thid, torch.from_numpy(labels), chunk=32)
    assert tfull.shape == (B, S, tcfg.vocab_padded) and tfull.dtype == torch.float32
    assert float(aux["aux_loss"]) == 0.0
    _close(tfull, JT.logits_from(jcfg, jparams, jhid), tol)
    assert thid.shape == (B, S, tcfg.d_model) and int(tn) == int(jn) == int((labels >= 0).sum())
    if dtype == "float32":
        _close(thid, jhid, tol)
    else:  # the residual stream, unnormed: held normwise (see the module docstring)
        got, want = _host(thid), _host(jhid)
        assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)
    np.testing.assert_allclose(float(tce), float(jce), rtol=CE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_model_serving_matches_jax(arch, dtype):
    """Prefill of S-1 tokens into a cache of S (the chunked oracle, whatever
    ``flash_kernel`` says), then one decode step; and the port's own
    prefill/decode parity against its flash-kernel forward."""
    jcfg, tcfg, jparams, model, toks, ttoks = _setup(arch, True, dtype)
    tol = TOL[dtype]
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :-1]), _zero_cache(jcfg), chunk=CHUNK)
    tlg, tcache = make_prefill_step(tcfg, chunk=CHUNK)(
        model, {"tokens": ttoks[:, :-1]}, TT.init_cache(tcfg, B, S, "cpu"))
    _close(tlg, jlg, tol)
    got_cache = convert.cache_to_reference(tcfg, tcache)
    want_cache = jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(got_cache) == jax.tree.structure(want_cache)
    for g, w in zip(jax.tree.leaves(got_cache), jax.tree.leaves(want_cache)):
        assert g.shape == w.shape
        _close(g, w, tol)
    jd, _ = JT.decode_step(jcfg, jparams, jnp.asarray(toks[:, -1:]), jnp.int32(S - 1), jcache)
    td, _ = make_decode_step(tcfg)(model, {"token": ttoks[:, -1:], "pos": S - 1}, tcache)
    _close(td, jd, tol)
    with torch.inference_mode():
        tfull, _ = TT.forward_train(tcfg, model, ttoks, chunk=CHUNK)
    # the port's own prefill/decode parity, at the JAX smoke test's tolerance
    _close(td[:, 0], tfull[:, -1], PARITY_TOL)


def test_gemma2_cache_specs_and_round_trip():
    """The K/V cache layout equals the JAX package's, and the JAX cache ->
    the port's -> back keeps every bit (bf16 leaves included)."""
    jcfg, tcfg = _configs("gemma2-2b", True, "bfloat16")
    want = JT.cache_specs(jcfg, B, S)["groups"]
    got = TT.cache_specs(tcfg, B, S)["groups"]
    assert {s: {k: (v.shape, v.dtype) for k, v in got[s].items()} for s in got} == \
        {s: {k: (v.shape, v.dtype) for k, v in want[s].items()} for s in want}
    rng = np.random.default_rng(1)
    jcache = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape), s.dtype), JT.cache_specs(jcfg, B, S),
                          is_leaf=lambda x: isinstance(x, ShapeAxes))
    tcache = convert.cache_from_reference(tcfg, jax.tree.map(np.asarray, jcache), "cpu")
    assert len(tcache) == tcfg.n_layers and tcache[0]["k"].dtype == torch.bfloat16
    back = convert.cache_to_reference(tcfg, tcache)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, jcache))):
        np.testing.assert_array_equal(g, _host(w))
    # layer g·P + slot is group g, slot `slot`: layer 3 is group 1's full layer
    np.testing.assert_array_equal(_host(tcache[3]["v"]), _host(jcache["groups"]["1"]["v"][1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch):
    jcfg, tcfg = _configs(arch, False, "bfloat16")
    leaves = lambda specs: [(leaf.shape, leaf.axes) for leaf in jax.tree.leaves(  # noqa: E731
        specs, is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "shape"))]
    assert leaves(TT.param_specs(tcfg)) == leaves(JT.param_specs(jcfg))
    full_j, full_t = JC.get(arch), TC.get(arch)
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert TT.param_count(full_t) == JT.param_count(full_j)
