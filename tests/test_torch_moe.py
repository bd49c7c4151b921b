"""The port's MoE FFN and its two MoE architectures against the JAX
package's, on the CPU.

``apply_moe`` alone, on the parameters of ``reduced(deepseek-moe-16b)`` (4
routed experts top-2 and one shared expert) and ``reduced(mixtral-8x22b)``
(4 experts top-2), drawn by the JAX package: both dispatches (the global
per-expert top-C, and the local one under ``moe_dispatch_groups=2``), at the
reduced config's capacity (C = T, nothing dropped) and at a binding
``capacity_factor=1.0``, where the tokens an expert drops must be the same
ones; and with two experts' router columns equal, so that the top-k meets
ties and must take the lower index first.  Then the whole reduced models:
``forward_train`` logits and summed aux losses (flash kernel path off and
on), ``prefill`` and ``decode_step`` logits and every cache leaf, and the
cache round trip bit for bit.  The parameter counts at full width come from
specs on both sides, never materialised.

Tolerances, as tests/test_torch_model.py and tests/test_torch_gemma2.py:
float32 1e-4 (the sums run in other orders); bfloat16 3e-2, the JAX smoke
test's bound (both round every op's result to bf16, in places that differ).
In a whole bf16 model one more difference is not a fault: the router's
top-k compares f32 probabilities of bf16 activations, so where the two
sides' activations differ by an ulp a token whose k-th and (k+1)-th router
logits lie within a hair of each other can go to another expert, and its
output moves by a whole expert's share.  There the bf16 logits and caches
are held normwise (``‖got − want‖ <= 3e-2 ‖want‖``) and elementwise at
every token whose router logits at the top-k cut are NEAR_TIE apart or more
in every MoE layer of the port's run (the rest, at most a tenth of the
tokens, are where the two sides may route otherwise).  ``apply_moe`` alone
takes the same bits on both sides and is held elementwise everywhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.layers import init_from_specs as jax_init
from repro.sharding import ShapeAxes
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.train.steps import make_decode_step, make_prefill_step

ARCHS = ["deepseek-moe-16b", "mixtral-8x22b"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PARITY_TOL = 3e-2  # tests/test_models_smoke.py's prefill/decode tolerance
B, S, CHUNK = 2, 72, 16
# router-logit gap at the top-k cut below which the two sides may route a
# bf16 token otherwise: a few bf16 ulps of the activations times the
# router's column norms (the flips seen here had gaps of 1.2e-3 and 1.6e-3)
NEAR_TIE = 1e-2


def _configs(arch: str, dtype: str = "float32", **kw):
    j = JC.reduced(JC.get(arch)).scaled(dtype=dtype, **kw)
    t = TC.reduced(TC.get(arch)).scaled(dtype=dtype, **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_host(got), _host(want), rtol=tol, atol=tol)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _moe_inputs(jcfg, seed: int, tie: bool):
    jp = jax_init(jax.random.PRNGKey(seed), JM.moe_spec(jcfg))
    if tie:  # experts 1 and 2 get the same router column: their probs tie
        jp["router"] = jp["router"].at[:, 2].set(jp["router"][:, 1])
    x = np.random.default_rng(seed).normal(size=(B, 64, jcfg.d_model)).astype(np.float32)
    return jp, x


def _dropped(jcfg, jp, x) -> int:
    """(token, expert) routings past the capacity, from the reference's router."""
    m = jcfg.moe
    xt = jnp.asarray(x).astype(jnp.float32).reshape(-1, jcfg.d_model)
    _, top_i = jax.lax.top_k(jax.nn.softmax(xt @ jp["router"], axis=-1), m.top_k)
    groups = jcfg.moe_dispatch_groups or 1
    per_group = np.asarray(top_i).reshape(groups, -1, m.top_k)
    cap = JM._capacity(per_group.shape[1], m)
    counts = [np.bincount(g.ravel(), minlength=m.n_experts) for g in per_group]
    return int(sum(np.maximum(c - cap, 0).sum() for c in counts))


@pytest.mark.parametrize("case", ["reduced", "binding", "tied_router"])
@pytest.mark.parametrize("groups", [0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, dtype, groups, case):
    jcfg, tcfg = _configs(arch, dtype, moe_dispatch_groups=groups)
    if case == "binding":
        jcfg = jcfg.scaled(moe=dataclasses.replace(jcfg.moe, capacity_factor=1.0))
        tcfg = tcfg.scaled(moe=dataclasses.replace(tcfg.moe, capacity_factor=1.0))
    jp, x = _moe_inputs(jcfg, seed=groups + len(case), tie=case == "tied_router")
    dropped = _dropped(jcfg, jp, x)
    assert (dropped > 0) == (case == "binding"), dropped
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    jout, jaux = JM.apply_moe(jcfg, jp, jx)
    tout, taux = TM.apply_moe(tcfg, _torch_tree(jax.tree.map(np.asarray, jp)),
                              torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tout.dtype == getattr(torch, dtype) and tout.shape == x.shape
    _close(tout, jout, TOL[dtype])
    assert sorted(taux) == ["aux_loss", "z_loss"]
    for k in taux:
        assert taux[k].dtype == torch.float32
        _close(taux[k], jaux[k], TOL[dtype])


def test_top_k_keeps_the_lower_index_first_on_ties():
    """Small integers, so most values tie; the same values and the same
    indices as ``jax.lax.top_k``, on a row and on a stack of rows."""
    a = np.random.default_rng(0).integers(0, 4, size=(3, 5, 40)).astype(np.float32)
    for k in (1, 7, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(a), k)
        tv, ti = TM.top_k(torch.from_numpy(a), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


class _RouterGaps:
    """A spy on the port's router: each call's gap between the k-th and
    the (k+1)-th router logit of every token."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = TM.route

        def spy(cfg, p, xt):
            out = real(cfg, p, xt)
            lg = torch.sort(out[0], dim=-1, descending=True).values
            self.calls.append(lg[:, cfg.moe.top_k - 1] - lg[:, cfg.moe.top_k])
            return out

        monkeypatch.setattr(TM, "route", spy)

    def near_ties(self, shape) -> np.ndarray:
        """(B, S) bool over the calls so far, then forget them: tokens
        within NEAR_TIE of the cut in some layer."""
        gaps = torch.stack(self.calls).min(dim=0).values.reshape(shape)
        self.calls.clear()
        return (gaps < NEAR_TIE).numpy()


def _hold(got, want, dtype, near=None):
    """float32: elementwise.  bfloat16: normwise, and elementwise at the
    tokens (the leading (B, S) axes) that are not near ties."""
    tol = TOL[dtype]
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    if dtype == "float32" or near is None:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        return
    assert near.mean() <= 0.1, near.mean()
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)
    keep = ~near[(...,) + (None,) * (got.ndim - near.ndim)] if got.ndim > near.ndim else ~near
    keep = np.broadcast_to(keep, got.shape)
    np.testing.assert_allclose(got[keep], want[keep], rtol=tol, atol=tol)


def _setup(arch, flash, dtype):
    jcfg, tcfg = _configs(arch, dtype, flash_kernel=flash)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.model_params_from_reference(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    return jcfg, tcfg, jparams, model, toks, torch.from_numpy(toks).long()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_forward_matches_jax(arch, flash, dtype, monkeypatch):
    """``forward_train``: the logits and the aux and z losses summed over
    the MoE layers (deepseek's dense first layer adds none)."""
    jcfg, tcfg, jparams, model, toks, ttoks = _setup(arch, flash, dtype)
    gaps = _RouterGaps(monkeypatch)
    jfull, jaux = JT.forward_train(jcfg, jparams, jnp.asarray(toks), chunk=CHUNK)
    with torch.inference_mode():
        tfull, taux = TT.forward_train(tcfg, model, ttoks, chunk=CHUNK)
    assert tfull.shape == (B, S, tcfg.vocab_padded) and tfull.dtype == torch.float32
    _hold(tfull, jfull, dtype, gaps.near_ties((B, S)))
    for k in ("aux_loss", "z_loss"):
        assert float(taux[k]) > 0.0
        _close(taux[k], jaux[k], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_serving_matches_jax(arch, dtype, monkeypatch):
    """Prefill of S-1 tokens into a cache of S (mixtral's window of 32 is
    passed), then one decode step: logits and every cache leaf; and the
    port's own prefill/decode parity against its forward (the reduced
    capacity is C = T, so the prefill drops no token)."""
    jcfg, tcfg, jparams, model, toks, ttoks = _setup(arch, True, dtype)
    gaps = _RouterGaps(monkeypatch)
    jcache0 = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), JT.cache_specs(jcfg, B, S),
                           is_leaf=lambda x: isinstance(x, ShapeAxes))
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :-1]), jcache0, chunk=CHUNK)
    tlg, tcache = make_prefill_step(tcfg, chunk=CHUNK)(
        model, {"tokens": ttoks[:, :-1]}, TT.init_cache(tcfg, B, S, "cpu"))
    near = np.pad(gaps.near_ties((B, S - 1)), ((0, 0), (0, 1)))  # the cache's last row is still zeros
    _hold(tlg, jlg, dtype, near[:, -2:-1])
    got, want = convert.cache_to_reference(tcfg, tcache), jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        # the layers' K/V, (layers,) + (B, S, Kv, Dh) or (B, S, Kv, Dh)
        _hold(g, w, dtype, np.broadcast_to(near, g.shape[:-2]) if g.ndim == 5 else near)
    jd, _ = JT.decode_step(jcfg, jparams, jnp.asarray(toks[:, -1:]), jnp.int32(S - 1), jcache)
    td, _ = make_decode_step(tcfg)(model, {"token": ttoks[:, -1:], "pos": S - 1}, tcache)
    _hold(td, jd, dtype, gaps.near_ties((B, 1)))
    with torch.inference_mode():
        tfull, _ = TT.forward_train(tcfg, model, ttoks, chunk=CHUNK)
    _close(td[:, 0], tfull[:, -1], PARITY_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_cache_round_trip_keeps_bits(arch):
    """The JAX cache -> the port's -> back, bf16 leaves included; deepseek's
    dense first layer is the prefix."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    rng = np.random.default_rng(1)
    jcache = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape), s.dtype),
                          JT.cache_specs(jcfg, B, S), is_leaf=lambda x: isinstance(x, ShapeAxes))
    tcache = convert.cache_from_reference(tcfg, jax.tree.map(np.asarray, jcache), "cpu")
    assert len(tcache) == tcfg.n_layers and tcache[-1]["k"].dtype == torch.bfloat16
    back = convert.cache_to_reference(tcfg, tcache)
    assert jax.tree.structure(back) == jax.tree.structure(jcache)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
        np.testing.assert_array_equal(g, _host(w))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_param_specs_match_jax(arch):
    """The reduced trees leaf for leaf, the (G, E, D, F) expert stacks and
    the shared experts included."""
    jcfg, tcfg = _configs(arch)
    leaves = lambda specs: [(leaf.shape, leaf.axes) for leaf in jax.tree.leaves(  # noqa: E731
        specs, is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "shape"))]
    assert leaves(TT.param_specs(tcfg)) == leaves(JT.param_specs(jcfg))


@pytest.mark.parametrize("arch,total,active", [
    ("deepseek-moe-16b", 16_375_728_128, 2_828_650_496),
    ("mixtral-8x22b", 140_630_071_296, 39_161_468_928),
])
def test_moe_param_counts_at_full_width(arch, total, active):
    full_t, full_j = TC.get(arch), JC.get(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert TT.param_count(full_t) == JT.param_count(full_j) == total
    assert TT.active_param_count(full_t) == JT.active_param_count(full_j) == active
