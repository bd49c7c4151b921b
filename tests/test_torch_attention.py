"""The port's attention, RoPE and FFN pieces against the JAX package's, on
the CPU.

The same seeded numpy arrays go to ``repro.models.{attention,layers}`` and
to their ``repro_torch`` counterparts; the parameters are drawn by the JAX
package's ``init_from_specs`` and handed over as numpy.  Tolerances:

* float32: 1e-5 (relative and absolute).  Both sides compute the same
  f32 ops; only the order of the sums inside the matmuls differs, over at
  most a few hundred O(1) terms.
* bfloat16: 3e-2, the JAX smoke test's bound.  Both round every op's
  result to bf16, in places that differ (XLA may keep a fusion's
  intermediates in f32), so an output may land a bf16 ulp or two away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.config import ModelConfig

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S = 2, 72  # past twice the window of 32, and not a multiple of the chunk of 16

# gemma2-like: GQA 4 on 2, a 32-token window, the logit softcap
FIELDS = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, window=32,
              attn_softcap=50.0)


def _cfgs(dtype, **kw):
    fields = {**FIELDS, "dtype": dtype, **kw}
    return JModelConfig(**fields), ModelConfig(**fields)


def _params(spec_tree, seed=0):
    jp = jlayers.init_from_specs(jax.random.PRNGKey(seed), spec_tree)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), jp)


def _x(shape, dtype, seed=1):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(TDT[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0), (True, 32, 50.0), (False, 0, 30.0), (False, 16, 0.0)])
def test_chunked_attention_matches_jax(dtype, causal, window, cap):
    """The oracle with its KV padding (72 keys in chunks of 16), GQA groups,
    the window, the softcap and the per-row guard."""
    rng = np.random.default_rng(2)
    arrays = [rng.normal(size=shape).astype(np.float32) for shape in ((B, S, 2, 2, 16), (B, S, 2, 16), (B, S, 2, 16))]
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in arrays)
    pos = np.arange(S, dtype=np.int32)
    want = jattn.chunked_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), causal, window, cap, chunk=16)
    got = tattn.chunked_attention(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(pos), causal, window, cap,
                                  chunk=16)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, 2, 2, 16)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("window", [0, 32])
def test_attention_matches_jax(dtype, flash, window):
    jcfg, tcfg = _cfgs(dtype, flash_kernel=flash)
    jp, tp = _params(jattn.attn_spec(jcfg))
    jx, tx = _x((B, S, 64), dtype)
    pos = np.arange(S, dtype=np.int32)
    want = jattn.attention(jcfg, jp, jx, jnp.asarray(pos), window=window, chunk=16)
    got = tattn.attention(tcfg, tp, tx, torch.from_numpy(pos), window=window, chunk=16)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, 64)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 32])
def test_prefill_then_decode_attention_matches_jax(dtype, window):
    """``attention_with_cache`` over S-1 tokens, its K/V padded into a cache
    of S, then ``decode_attention`` of the last token at position S-1."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jattn.attn_spec(jcfg))
    jx, tx = _x((B, S, 64), dtype)
    pos = np.arange(S - 1, dtype=np.int32)
    wy, wkv = jattn.attention_with_cache(jcfg, jp, jx[:, :-1], jnp.asarray(pos), None, window=window, chunk=16)
    gy, gkv = tattn.attention_with_cache(tcfg, tp, tx[:, :-1], torch.from_numpy(pos), window=window, chunk=16)
    _close(gy, wy, TOL[dtype])
    for name in ("k", "v"):
        _close(gkv[name], wkv[name], TOL[dtype])
    jcache = {n: jnp.pad(wkv[n], ((0, 0), (0, 1), (0, 0), (0, 0))) for n in ("k", "v")}
    tcache = {n: torch.nn.functional.pad(gkv[n], (0, 0, 0, 0, 0, 1)) for n in ("k", "v")}
    wy, wc = jattn.decode_attention(jcfg, jp, jx[:, -1:], jnp.int32(S - 1), jcache, window=window)
    gy, gc = tattn.decode_attention(tcfg, tp, tx[:, -1:], S - 1, tcache, window=window)
    assert gc["k"] is tcache["k"]  # written in place
    _close(gy, wy, TOL[dtype])
    for name in ("k", "v"):
        _close(gc[name], wc[name], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pct,theta", [(1.0, 10_000.0), (0.25, 10_000.0), (0.5, 500_000.0)])
def test_apply_rope_matches_jax(dtype, pct, theta):
    jx, tx = _x((B, S, 4, 16), dtype)
    pos = np.random.default_rng(3).integers(0, 9000, (B, S)).astype(np.int32)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), theta, pct)
    got = tlayers.apply_rope(tx, torch.from_numpy(pos), theta, pct)
    assert got.dtype == TDT[dtype]
    _close(got, want, TOL[dtype])
    if pct < 1.0:
        rot = int(16 * pct)
        np.testing.assert_array_equal(got[..., rot:].float().numpy(), tx[..., rot:].float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu_mlp"])
def test_apply_ffn_matches_jax(dtype, act):
    jcfg, tcfg = _cfgs(dtype, act=act)
    jp, tp = _params(jlayers.ffn_spec(jcfg))
    assert sorted(tp) == sorted(tlayers.ffn_spec(tcfg))
    jx, tx = _x((B, S, 64), dtype)
    _close(tlayers.apply_ffn(tcfg, tp, tx), jlayers.apply_ffn(jcfg, jp, jx), TOL[dtype])
