"""``qk_norm`` in the port against the JAX package, on the CPU.

No architecture of the repo sets ``qk_norm``; the JAX package normalises q
and k over the head dim (with the config's own norm) after the projection
and before RoPE in every self-attention, in train, prefill and decode, and
never in a cross-attention.  Reduced configs of three archs with the flag
set (stablelm-1.6b: LayerNorm and partial RoPE; gemma2-2b: RMSNorm, the
window and the softcap; seamless-m4t-large-v2: the encoder's self-attention
norms, none in the cross-attention), one set of parameters drawn by the
JAX package and carried across by ``convert``, seeded numpy tokens.
Tolerances, float32: logits and caches within 1e-5 (relative and
absolute: summation order only); the loss within 1e-5 relative and every
gradient within 1e-4 of its leaf's largest magnitude, as in
``tests/test_torch_train_archs.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import transformer as JT
from repro.sharding import ShapeAxes as JShapeAxes
from repro.train.losses import chunked_softmax_ce as j_ce
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TA
from repro_torch.train import steps as TS
from repro_torch.train.steps import make_decode_step, make_prefill_step

ARCHS = ["stablelm-1.6b", "gemma2-2b", "seamless-m4t-large-v2"]
B, S, CHUNK = 2, 24, 8
F32_TOL, LOSS_RTOL, TOL = 1e-5, 1e-5, 1e-4


def configs(arch):
    return (JC.reduced(JC.get(arch)).scaled(qk_norm=True), TC.reduced(TC.get(arch)).scaled(qk_norm=True))


def setup(arch, seed=0):
    jcfg, tcfg = configs(arch)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    model = convert.model_params_from_reference(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (B, S + 1), dtype=np.int32)
    frames = (rng.standard_normal((B, jcfg.frontend_len, jcfg.d_model)).astype(np.float32)
              if jcfg.frontend != "none" else None)
    return jcfg, tcfg, jparams, model, toks, frames


def close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_specs_carry_the_norms_on_self_attention_only():
    """The port's parameters, leaf for leaf, are the JAX package's: q_norm
    and k_norm (scale, and bias under LayerNorm) of head_dim in every
    self-attention, none in seamless's cross-attention; the count equals
    the JAX package's."""
    for arch in ARCHS:
        jcfg, tcfg = configs(arch)
        assert TT.param_count(tcfg) == JT.param_count(jcfg) > TT.param_count(tcfg.scaled(qk_norm=False))
        shape = lambda s: (tuple(s.shape), s.dtype)  # noqa: E731
        assert (jax.tree.map(shape, JT.param_specs(jcfg), is_leaf=lambda x: isinstance(x, JShapeAxes))
                == jax.tree.map(shape, TT.param_specs(tcfg), is_leaf=lambda x: hasattr(x, "axes")))
        names = list(dict(TT.Model(tcfg, device="cpu").named_parameters()))
        assert any(".attn.q_norm.scale" in n for n in names) and any(".attn.k_norm.scale" in n for n in names)
        assert not any(".cross.q_norm" in n or ".cross.k_norm" in n for n in names)
        if tcfg.norm == "layernorm":
            assert any(".attn.k_norm.bias" in n for n in names)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    """Logits of the whole sequence, the prefill's last logits and its
    cache, then one decode step's logits and cache."""
    jcfg, tcfg, jparams, model, toks, frames = setup(arch)
    toks = toks[:, :S]
    ttoks = torch.from_numpy(toks).long()
    jfr = None if frames is None else jnp.asarray(frames)
    tfr = None if frames is None else torch.from_numpy(frames)

    jfull, _ = JT.forward_train(jcfg, jparams, jnp.asarray(toks), jfr, chunk=CHUNK)
    with torch.inference_mode():
        tfull, _ = TT.forward_train(tcfg, model, ttoks, tfr, chunk=CHUNK)
    close(tfull, jfull)

    jcache0 = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), JT.cache_specs(jcfg, B, S),
                           is_leaf=lambda x: isinstance(x, JShapeAxes))
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :-1]), jcache0, jfr, chunk=CHUNK)
    batch = {"tokens": ttoks[:, :-1]} if tfr is None else {"tokens": ttoks[:, :-1], "frontend": tfr}
    tlg, tcache = make_prefill_step(tcfg, chunk=CHUNK)(model, batch, TT.init_cache(tcfg, B, S, "cpu"))
    close(tlg, jlg)
    for got, want in zip(jax.tree.leaves(convert.cache_to_reference(tcfg, tcache)), jax.tree.leaves(jcache)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=F32_TOL, atol=F32_TOL)

    jd, jcache2 = JT.decode_step(jcfg, jparams, jnp.asarray(toks[:, -1:]), jnp.int32(S - 1), jcache)
    td, tcache2 = make_decode_step(tcfg)(model, {"token": ttoks[:, -1:], "pos": S - 1}, tcache)
    close(td, jd)
    for got, want in zip(jax.tree.leaves(convert.cache_to_reference(tcfg, tcache2)), jax.tree.leaves(jcache2)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=F32_TOL, atol=F32_TOL)
    close(td[:, 0], tfull[:, -1], 3e-2)  # the port's own prefill/decode parity, the smoke test's bound


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_gradients_match_jax(arch, monkeypatch):
    """The train step's loss and its gradients, taken where it hands them
    to AdamW, against ``jax.value_and_grad``; the norms' own gradients
    among them."""
    jcfg, tcfg, jparams, model, toks, frames = setup(arch, seed=1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if frames is not None:
        batch["frontend"] = frames

    def loss_fn(p, b):
        h, aux = JT.forward_train(jcfg, p, b["tokens"], b.get("frontend"), return_hidden=True)
        ce, _ = j_ce(jcfg, p, h, b["labels"], chunk=CHUNK)
        return ce + aux["aux_loss"] + aux["z_loss"]

    loss, grads = jax.value_and_grad(loss_fn)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    named = TS.named_params(tcfg, model)
    grabbed, real = {}, TS.adamw_update

    def grab(cfg, g, st, p):
        grabbed.update(g)
        return real(cfg, g, st, p)

    monkeypatch.setattr(TS, "adamw_update", grab)
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in batch.items()}
    state = {"params": model, "opt": TA.adamw_init(named)}
    _, met = TS.make_train_step(tcfg, TA.AdamWConfig(lr=0.0, weight_decay=0.0), loss_chunk=CHUNK)(state, tb)
    np.testing.assert_allclose(float(met["loss"]), float(loss), rtol=LOSS_RTOL)
    assert any("q_norm" in k and bool(g.any()) for k, g in grabbed.items())
    got = convert.params_to_reference(tcfg, grabbed)
    for path, w in jax.tree_util.tree_flatten_with_path(grads)[0]:
        node = got
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(node, w, rtol=0, atol=TOL * float(np.abs(w).max()) + 1e-30,
                                   err_msg=jax.tree_util.keystr(path))


def test_flash_path_normalises_too():
    """With ``flash_kernel`` (its plain version for CPU tensors) the
    normalised q and k reach the kernel: the logits equal the oracle's."""
    _, tcfg, _, model, toks, _ = setup("stablelm-1.6b")
    ttoks = torch.from_numpy(toks[:, :16]).long()
    with torch.inference_mode():
        oracle, _ = TT.forward_train(tcfg, model, ttoks, chunk=CHUNK)
        flash, _ = TT.forward_train(tcfg.scaled(flash_kernel=True), model, ttoks, chunk=CHUNK)
        plain, _ = TT.forward_train(tcfg.scaled(qk_norm=False), model, ttoks, chunk=CHUNK)
    close(flash, oracle.numpy())
    assert not torch.allclose(plain, oracle, atol=1e-3)
