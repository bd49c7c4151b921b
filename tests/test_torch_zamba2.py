"""The port's Mamba-2 mixer and zamba2 against the JAX package's, on the CPU.

The mixer's parts first, on ``reduced(zamba2-1.2b)``'s widths (d_model 64,
16 heads of 16 over a state of 16, conv width 4, scan chunk 16) with
parameters drawn by the JAX package: ``causal_conv`` and
``causal_conv_step``; ``apply_mamba2`` from a nonzero initial state over 37
tokens (not a multiple of the chunk, so the scan's identity padding runs),
its output and its cache; and ``mamba2_decode`` from a random cache.  Then
the whole model, reduced as it is (two groups of six Mamba-2 layers, each
led by the shared attention+FFN block, no tail) and scaled to 14 layers
(a tail of two Mamba-2 layers, which no shared block leads):
``forward_train`` logits (flash kernel path off and on), ``prefill`` and
``decode_step`` logits and every cache leaf (the shared block's K/V for
each group included), and the cache round trip bit for bit.  The parameter
count at full width comes from specs on both sides.

Tolerances, as tests/test_torch_model.py and tests/test_torch_gemma2.py:
float32 1e-4 (the sums run in other orders); bfloat16 3e-2, the JAX smoke
test's bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.layers import init_from_specs as jax_init
from repro.sharding import ShapeAxes
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.train.steps import make_decode_step, make_prefill_step

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PARITY_TOL = 3e-2  # tests/test_models_smoke.py's prefill/decode tolerance
B, S, CHUNK = 2, 37, 16
DEPTHS = [12, 14]  # reduced as it is (G = 2, no tail), and with a tail of 2


def _configs(dtype: str = "float32", **kw):
    j = JC.reduced(JC.get("zamba2-1.2b")).scaled(dtype=dtype, **kw)
    t = TC.reduced(TC.get("zamba2-1.2b")).scaled(dtype=dtype, **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_host(got), _host(want), rtol=tol, atol=tol)


def _to_torch(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(_host(a)))
    return t.to(getattr(torch, dtype)) if dtype else t


def _mixer(seed: int = 0):
    jcfg, tcfg = _configs()
    jp = jax_init(jax.random.PRNGKey(seed), JS.mamba2_spec(jcfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = JS.causal_conv(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd))
    got = TS.causal_conv(_to_torch(x, dtype), _to_torch(w, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    _close(got, want, TOL[dtype])
    # one step at a time from a zero state gives the same outputs
    state = torch.zeros((B, 3, 24), dtype=getattr(torch, dtype))
    for t in range(S):
        y, state = TS.causal_conv_step(_to_torch(x[:, t], dtype), state, _to_torch(w, dtype))
        _close(y, want[:, t], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_step_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x, state, w = (rng.normal(size=s).astype(np.float32) for s in ((B, 24), (B, 3, 24), (4, 24)))
    jd = jnp.dtype(dtype)
    jy, jst = JS.causal_conv_step(*(jnp.asarray(a).astype(jd) for a in (x, state, w)))
    ty, tst = TS.causal_conv_step(*(_to_torch(a, dtype) for a in (x, state, w)))
    _close(ty, jy, TOL[dtype])
    np.testing.assert_array_equal(_host(tst), _host(jst))  # the shifted inputs, moved not computed


@pytest.mark.parametrize("s", [S, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba2_matches_jax(dtype, s):
    """From a random initial state; 37 tokens take the scan's identity
    padding to 48, 48 tokens none.  The output, the final state and the
    conv tails of the cache."""
    jcfg, tcfg, jp, tp = _mixer()
    jcfg, tcfg = jcfg.scaled(dtype=dtype), tcfg.scaled(dtype=dtype)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, s, jcfg.d_model)).astype(np.float32)
    h = jcfg.ssm.expand * jcfg.d_model // jcfg.ssm.head_dim
    h0 = (0.1 * rng.normal(size=(B, h, jcfg.ssm.d_state, jcfg.ssm.head_dim))).astype(np.float32)
    jd = jnp.dtype(dtype)
    jy, jc = JS.apply_mamba2(jcfg, jp, jnp.asarray(x).astype(jd), h0=jnp.asarray(h0).astype(jd))
    ty, tc = TS.apply_mamba2(tcfg, tp, _to_torch(x, dtype), h0=_to_torch(h0, dtype))
    assert ty.dtype == getattr(torch, dtype) and ty.shape == x.shape
    _close(ty, jy, TOL[dtype])
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tc[k].dtype == getattr(torch, dtype) and tuple(tc[k].shape) == jc[k].shape, k
        _close(tc[k], jc[k], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_jax(dtype):
    """Three steps from a random cache in ``cfg.dtype``, each step's output
    and the whole cache after it."""
    jcfg, tcfg, jp, tp = _mixer(1)
    jcfg, tcfg = jcfg.scaled(dtype=dtype), tcfg.scaled(dtype=dtype)
    rng = np.random.default_rng(3)
    specs = JS.mamba2_cache_spec(jcfg, B)
    assert {k: (v.shape, v.dtype) for k, v in TS.mamba2_cache_spec(tcfg, B).items()} == \
        {k: (v.shape, v.dtype) for k, v in specs.items()}
    jcache = {k: jnp.asarray(0.5 * rng.normal(size=v.shape)).astype(v.dtype) for k, v in specs.items()}
    tcache = {k: _to_torch(v, dtype) for k, v in jcache.items()}
    for _ in range(3):
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        jy, jcache = JS.mamba2_decode(jcfg, jp, jnp.asarray(x).astype(jnp.dtype(dtype)), jcache)
        ty, tcache = TS.mamba2_decode(tcfg, tp, _to_torch(x, dtype), tcache)
        _close(ty, jy, TOL[dtype])
        for k in jcache:
            assert tcache[k].dtype == getattr(torch, dtype)
            _close(tcache[k], jcache[k], TOL[dtype])


def _setup(n_layers, flash, dtype):
    jcfg, tcfg = _configs(dtype, n_layers=n_layers, flash_kernel=flash)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.model_params_from_reference(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    return jcfg, tcfg, jparams, model, toks, torch.from_numpy(toks).long()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_zamba2_forward_matches_jax(n_layers, flash, dtype):
    jcfg, tcfg, jparams, model, toks, ttoks = _setup(n_layers, flash, dtype)
    assert TT.n_shared_runs(tcfg) == 2 and len(model.layers) == n_layers
    jfull, _ = JT.forward_train(jcfg, jparams, jnp.asarray(toks), chunk=CHUNK)
    with torch.inference_mode():
        tfull, aux = TT.forward_train(tcfg, model, ttoks, chunk=CHUNK)
    assert tfull.shape == (B, S, tcfg.vocab_padded) and tfull.dtype == torch.float32
    assert float(aux["aux_loss"]) == 0.0 and float(aux["z_loss"]) == 0.0
    _close(tfull, jfull, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_zamba2_serving_matches_jax(n_layers, dtype):
    """Prefill of S-1 = 36 tokens (not a multiple of the chunk) into a cache
    of S, then one decode step: logits and every cache leaf, the Mamba-2
    states and conv tails and the shared block's K/V for each group; and the
    port's own prefill/decode parity against its forward."""
    jcfg, tcfg, jparams, model, toks, ttoks = _setup(n_layers, True, dtype)
    tol = TOL[dtype]
    jcache0 = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), JT.cache_specs(jcfg, B, S),
                           is_leaf=lambda x: isinstance(x, ShapeAxes))
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :-1]), jcache0, chunk=CHUNK)
    tlg, tcache = make_prefill_step(tcfg, chunk=CHUNK)(
        model, {"tokens": ttoks[:, :-1]}, TT.init_cache(tcfg, B, S, "cpu"))
    _close(tlg, jlg, tol)
    got, want = convert.cache_to_reference(tcfg, tcache), jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert ("tail" in want) == (n_layers == 14) and want["shared"]["k"].shape[0] == 2
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        _close(g, w, tol)
    jd, jcache2 = JT.decode_step(jcfg, jparams, jnp.asarray(toks[:, -1:]), jnp.int32(S - 1), jcache)
    td, tcache2 = make_decode_step(tcfg)(model, {"token": ttoks[:, -1:], "pos": S - 1}, tcache)
    _close(td, jd, tol)
    for g, w in zip(jax.tree.leaves(convert.cache_to_reference(tcfg, tcache2)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jcache2))):
        _close(g, w, tol)
    with torch.inference_mode():
        tfull, _ = TT.forward_train(tcfg, model, ttoks, chunk=CHUNK)
    _close(td[:, 0], tfull[:, -1], PARITY_TOL)


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_zamba2_cache_round_trip_keeps_bits(n_layers):
    """The JAX cache -> the port's -> back, bf16 leaves included: the
    layers' caches in layer order, then the shared block's for each group."""
    jcfg, tcfg = _configs("bfloat16", n_layers=n_layers)
    rng = np.random.default_rng(1)
    jcache = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape), s.dtype),
                          JT.cache_specs(jcfg, B, S), is_leaf=lambda x: isinstance(x, ShapeAxes))
    tcache = convert.cache_from_reference(tcfg, jax.tree.map(np.asarray, jcache), "cpu")
    assert len(tcache) == n_layers + 2 and tcache[0]["h"].dtype == torch.bfloat16
    back = convert.cache_to_reference(tcfg, tcache)
    assert jax.tree.structure(back) == jax.tree.structure(jcache)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
        np.testing.assert_array_equal(g, _host(w))
    # group 1's shared K/V is entry n_layers + 1; layer 6 + 2 is group 1, slot 2
    np.testing.assert_array_equal(_host(tcache[n_layers + 1]["k"]), _host(jcache["shared"]["k"][1]))
    np.testing.assert_array_equal(_host(tcache[8]["conv_x"]), _host(jcache["groups"]["2"]["conv_x"][1]))
    zero = TT.init_cache(tcfg, B, S, "cpu")
    assert [sorted(c) for c in zero] == [sorted(c) for c in tcache]
    assert all(zero[i][k].shape == tcache[i][k].shape for i in range(len(zero)) for k in zero[i])


def test_zamba2_param_specs_and_count_match_jax():
    """The reduced trees leaf for leaf (the shared block included), and the
    count at full width: 38 Mamba-2 layers and one shared block."""
    jcfg, tcfg = _configs(n_layers=14)
    leaves = lambda specs: [(leaf.shape, leaf.axes) for leaf in jax.tree.leaves(  # noqa: E731
        specs, is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "shape"))]
    assert leaves(TT.param_specs(tcfg)) == leaves(JT.param_specs(jcfg))
    full_t, full_j = TC.get("zamba2-1.2b"), JC.get("zamba2-1.2b")
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert TT.param_count(full_t) == JT.param_count(full_j) == 1_104_777_344
    assert TT.active_param_count(full_t) == JT.active_param_count(full_j) == 1_104_777_344
    assert TT.n_shared_runs(full_t) == 6 and full_t.blocks() == ["mamba2"] * 38
