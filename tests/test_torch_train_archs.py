"""The train step's loss and gradients for every architecture of the port
against the JAX package's ``jax.value_and_grad``, on the CPU.

``reduced(cfg)`` of each of the ten archs in ``repro_torch/configs/`` (the
same reduction on both sides, float32, remat off), one state drawn by the
JAX package and carried across by ``repro_torch.convert``, and seeded
numpy tokens (and, for seamless and phi-3-vision, frontend embeddings).
So MoE aux and z losses, Mamba-2, zamba2's shared block, the mLSTM and
sLSTM cells, the encoder-decoder and the patch prefix are all held.
Tolerances: the loss within 1e-5 relative; every gradient, and every
parameter and moment after one AdamW step, within 1e-4 of its leaf's
largest magnitude (summation order only), the parameters after the step
plus 1% of its learning rate (AdamW's normalised step turns a gradient's
relative error into up to that share of a step).  Where the reference
gradient is not zero but lies within the 1e-4 band of it, its sign is not
fixed by the tolerance, and AdamW's first step lr·g/(|g| + ε) may then
move the parameter by up to lr either way, so there the parameter is held
within 2·lr more (and fewer than 1 in 1,000 elements may need it).  The JAX
side is computed once an arch (a module fixture) and runs eagerly: about
70 s for the ten.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train.losses import chunked_softmax_ce as j_ce
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.optim import adamw as TA
from repro_torch.train import steps as TS

B, S, CHUNK = 2, 24, 8
LOSS_RTOL, TOL = 1e-5, 1e-4
OPT = dict(lr=3e-3, warmup=0, decay_steps=10)


def _batch(cfg):
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.frontend != "none":
        batch["frontend"] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


_REF: dict = {}


@pytest.fixture(scope="module")
def reference():
    """arch -> (the JAX config, its parameters, the batch, loss, gradients,
    the parameters and moments after one AdamW step), computed on first use."""

    def get(arch):
        if arch not in _REF:
            jcfg = JC.reduced(JC.get(arch))
            params = JT.init_params(jcfg, jax.random.PRNGKey(0))
            batch = _batch(jcfg)

            def loss_fn(p, b):
                h, aux = JT.forward_train(jcfg, p, b["tokens"], b.get("frontend"), return_hidden=True)
                ce, _ = j_ce(jcfg, p, h, b["labels"], chunk=CHUNK)
                return ce + aux["aux_loss"] + aux["z_loss"]

            loss, grads = jax.value_and_grad(loss_fn)(params, {k: jnp.asarray(v) for k, v in batch.items()})
            new_p, new_opt, met = JA.adamw_update(JA.AdamWConfig(**OPT), grads, JA.adamw_init(params), params)
            _REF[arch] = (jcfg, params, batch, loss, grads, new_p, new_opt, met)
        return _REF[arch]

    return get


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key if hasattr(p, "key") else p.idx]
    return tree


def _close(got: dict, want, band_of=None, slack=0.0, lr=0.0):
    """Every leaf of ``got`` (numpy, the JAX layout) within TOL of the
    leaf's largest magnitude of ``want``; with ``band_of`` (a gradient tree
    like ``want``), within ``slack`` more where that gradient is not zero
    but lies within TOL of its leaf's largest magnitude of zero, and fewer
    than 1 in 1,000 elements needing it; everywhere 1% of ``lr`` more."""
    n_used = n_all = 0
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node, w = _leaf(got, path), np.asarray(w, np.float32)
        assert node.shape == w.shape, jax.tree_util.keystr(path)
        strict = TOL * (float(np.max(np.abs(w))) if w.size else 0.0) + 1e-2 * lr
        atol = np.full(w.shape, strict, np.float32)
        err = np.abs(node - w)
        if band_of is not None and w.size:
            g = np.asarray(_leaf(band_of, path), np.float32)
            band = (np.abs(g) <= TOL * float(np.max(np.abs(g)))) & (g != 0)
            atol = np.where(band, atol + slack, atol)
            n_used += int((band & (err > strict)).sum())
        n_all += w.size
        np.testing.assert_array_less(err, np.maximum(atol, 1e-30) * (1 + 1e-6) + 1e-30,
                                     err_msg=jax.tree_util.keystr(path))
    assert n_used * 1000 < max(n_all, 1), (n_used, n_all)


def _port(arch, jcfg, params, batch):
    tcfg = TC.reduced(TC.get(arch))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    model = convert.model_params_from_reference(tcfg, jax.tree.map(np.asarray, params), "cpu")
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in batch.items()}
    return tcfg, model, tb


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_loss_and_gradients_match_jax(arch, reference, monkeypatch):
    """The train step's own loss and gradients (taken where it hands them
    to AdamW, with a zero learning rate and no decay)."""
    jcfg, params, batch, loss, grads, *_ = reference(arch)
    tcfg, model, tb = _port(arch, jcfg, params, batch)
    named = TS.named_params(tcfg, model)
    grabbed = {}
    real = TS.adamw_update

    def grab(cfg, g, st, p):
        grabbed.update(g)
        return real(cfg, g, st, p)

    monkeypatch.setattr(TS, "adamw_update", grab)
    state = {"params": model, "opt": TA.adamw_init(named)}
    _, met = TS.make_train_step(tcfg, TA.AdamWConfig(lr=0.0, weight_decay=0.0), loss_chunk=CHUNK)(state, tb)
    np.testing.assert_allclose(float(met["loss"]), float(loss), rtol=LOSS_RTOL)
    assert list(grabbed) == list(named)
    _close(convert.params_to_reference(tcfg, grabbed), grads)


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_one_adamw_step_matches_jax(arch, reference):
    """The port's whole train step from the same state: the parameters and
    both moments after it, and its grad norm and learning rate."""
    jcfg, params, batch, loss, grads, new_p, new_opt, met = reference(arch)
    tcfg, model, tb = _port(arch, jcfg, params, batch)
    state = {"params": model, "opt": TA.adamw_init(TS.named_params(tcfg, model))}
    state, tm = TS.make_train_step(tcfg, TA.AdamWConfig(**OPT), loss_chunk=CHUNK)(state, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(met["grad_norm"]), rtol=TOL)
    np.testing.assert_allclose(float(tm["lr"]), float(met["lr"]), rtol=1e-6)
    _close(convert.params_to_reference(tcfg, state["params"]), new_p, band_of=grads, slack=2 * float(met["lr"]),
           lr=float(met["lr"]))
    _close(convert.params_to_reference(tcfg, state["opt"]["m"]), new_opt["m"])
    _close(convert.params_to_reference(tcfg, state["opt"]["v"]), new_opt["v"])
