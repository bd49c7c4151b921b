"""The synchronous train step of the port against the JAX package's, on
the CPU: the chunked CE and its backward, AdamW, gradient accumulation,
the whole step, and the port's own remat and kernel-flag guards.

Mirrors ``tests/test_train_steps.py``'s ``TestChunkedCE``,
``TestGradAccum`` and ``TestAdamW``.  Both packages start from one state:
the JAX package draws the parameters (and, where it matters, the AdamW
state), and ``repro_torch.convert`` carries them across; seeded numpy
tokens feed both.  Tolerances, float32 throughout: a CE within 1e-5
relative of the JAX package's (the reference's own CE tolerance);
gradients, parameters and moments within 1e-4 of the leaf's largest
magnitude (the two sides differ by summation order only); remat against
none, bit for bit.  After whole train steps the parameters are held
within 1e-4 of the leaf's largest magnitude plus 1% of the summed
learning rate: AdamW's normalised step m̂/(√v̂ + ε) turns a gradient's
relative error into up to that share of a step.  Where a step's gradient
is not zero but lies within 2e-4 of its leaf's largest magnitude of it,
its sign is not fixed by the tolerance and the step may go either way:
there they are held within 2 x the summed learning rate more, and fewer
than 1 in 1,000 elements may need it.  ``chip_smoke.py`` phase 28 holds
the card's step to the CPU's by the same rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adamw as JA
from repro.train import steps as JS
from repro.train.losses import chunked_softmax_ce as j_ce
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw as TA
from repro_torch.train import steps as TS
from repro_torch.train.losses import chunked_softmax_ce

FIELDS = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, vocab=64, dtype="float32",
              remat="none")
CFG, JCFG = ModelConfig(**FIELDS), JModelConfig(**FIELDS)
CE_RTOL = 1e-5
TOL = 1e-4


def batch_of(seed=0, b=4, s=16, vocab=64):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, vocab, (b, s + 1), dtype=np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in batch.items()}


def both_models(jcfg, tcfg, seed=0):
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, convert.model_params_from_reference(tcfg, jax.tree.map(np.asarray, jp), "cpu")


def assert_tree_close(got: dict, want, tol=TOL, band=None, slack=0.0, lr_sum=0.0):
    """``got`` (the port's tree in the JAX layout, numpy) against ``want``
    (a JAX tree): every leaf within ``tol`` of the leaf's largest
    magnitude plus 1% of ``lr_sum``; with ``band`` (a tree of bool masks
    like ``want``) within ``slack`` more where the mask is set, and fewer
    than 1 in 1,000 elements needing it."""
    n_used = n_all = 0
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        w = np.asarray(w, np.float32)
        assert node.shape == w.shape, jax.tree_util.keystr(path)
        strict = tol * (float(np.max(np.abs(w))) if w.size else 0.0) + 1e-2 * lr_sum
        err = np.abs(node - w)
        atol = np.full(w.shape, strict, np.float32)
        if band is not None:
            mask = band
            for p in path:
                mask = mask[p.key if hasattr(p, "key") else p.idx]
            atol = np.where(mask, atol + slack, atol)
            n_used += int((mask & (err > strict)).sum())
        n_all += w.size
        np.testing.assert_array_less(err, np.maximum(atol, 1e-30) * (1 + 1e-6) + 1e-30,
                                     err_msg=jax.tree_util.keystr(path))
    assert n_used * 1000 < max(n_all, 1), (n_used, n_all)


def near_zero(grads: dict) -> dict:
    """Per element: the gradient is not zero but within 2·TOL of its
    leaf's largest magnitude of it (its sign is not fixed by the
    tolerance)."""
    return {k: (g.abs() <= 2 * TOL * g.abs().max()) & (g != 0) for k, g in grads.items()}


class TestChunkedCE:
    @pytest.mark.parametrize("chunk", [4, 8, 16])
    def test_matches_jax_and_direct_ce(self, chunk):
        jp, model = both_models(JCFG, CFG)
        batch = batch_of()
        jh, _ = JT.forward_train(JCFG, jp, jnp.asarray(batch["tokens"]), return_hidden=True, chunk=16)
        want, wn = j_ce(JCFG, jp, jh, jnp.asarray(batch["labels"]), chunk=chunk)
        tb = torch_batch(batch)
        with torch.inference_mode():
            h, _ = TT.forward_train(CFG, model, tb["tokens"], return_hidden=True, chunk=16)
            ce, n = chunked_softmax_ce(CFG, model, h, tb["labels"], chunk=chunk)
            logp = torch.log_softmax(TT.logits_from(CFG, model, h), dim=-1)
            direct = -torch.gather(logp, -1, tb["labels"][..., None]).mean()
        np.testing.assert_allclose(float(ce), float(want), rtol=CE_RTOL)
        np.testing.assert_allclose(float(ce), float(direct), rtol=CE_RTOL)
        assert int(n) == int(wn) == batch["labels"].size and n.dtype == torch.int32

    @pytest.mark.parametrize("chunk", [8, 5])
    def test_label_masking(self, chunk):
        """Half the labels ignored (-1): the count halves and the CE equals
        the JAX package's; chunk 5 pads the sequence with ignored labels."""
        jp, model = both_models(JCFG, CFG)
        batch = batch_of()
        batch["labels"][:, :8] = -1
        jh, _ = JT.forward_train(JCFG, jp, jnp.asarray(batch["tokens"]), return_hidden=True, chunk=16)
        want, _ = j_ce(JCFG, jp, jh, jnp.asarray(batch["labels"]), chunk=chunk)
        tb = torch_batch(batch)
        with torch.inference_mode():
            h, _ = TT.forward_train(CFG, model, tb["tokens"], return_hidden=True, chunk=16)
            ce, n = chunked_softmax_ce(CFG, model, h, tb["labels"], chunk=chunk)
        assert int(n) == batch["labels"].size // 2
        np.testing.assert_allclose(float(ce), float(want), rtol=CE_RTOL)

    @pytest.mark.parametrize("chunk", [4, 16])
    def test_backward_matches_jax(self, chunk):
        """The CE's gradient (each chunk's logits recomputed in the
        backward) with respect to the hidden states and the parameters."""
        jp, model = both_models(JCFG, CFG)
        batch = batch_of()
        jh, _ = JT.forward_train(JCFG, jp, jnp.asarray(batch["tokens"]), return_hidden=True, chunk=16)
        (_, _), (gp, gh) = jax.value_and_grad(
            lambda p, h: j_ce(JCFG, p, h, jnp.asarray(batch["labels"]), chunk=chunk), argnums=(0, 1), has_aux=True
        )(jp, jh)
        h = torch.from_numpy(np.array(jh)).requires_grad_()
        params = TS.named_params(CFG, model)
        ce, _ = chunked_softmax_ce(CFG, model, h, torch_batch(batch)["labels"], chunk=chunk)
        grads = torch.autograd.grad(ce, [h, *params.values()], allow_unused=True)
        np.testing.assert_allclose(grads[0].numpy(), np.asarray(gh), rtol=0, atol=TOL * float(jnp.abs(gh).max()))
        used = {k: g for k, g in zip(params, grads[1:]) if g is not None}
        assert sorted(used) == ["embed", "final_norm.scale"]  # the tied head and the final norm
        assert_tree_close(convert.params_to_reference(CFG, used), {"embed": gp["embed"], "final_norm": gp["final_norm"]})


class TestGradAccum:
    def test_accum_equals_full_batch(self):
        """grad_accum=4 gives the update of grad_accum=1 (mean of the
        microbatch gradients == the full batch's for mean losses over
        equal microbatches), at the reference test's tolerance, and both
        equal the JAX package's step."""
        jp, _ = both_models(JCFG, CFG, seed=1)
        batch = batch_of(b=8)
        opt = TA.AdamWConfig(lr=1e-3, warmup=0, grad_clip=0.0)
        jopt = JA.AdamWConfig(**opt._asdict())
        out = {}
        for accum in (1, 4):
            state = {"params": convert.model_params_from_reference(CFG, jax.tree.map(np.asarray, jp), "cpu")}
            state["opt"] = TA.adamw_init(TS.named_params(CFG, state["params"]))
            state, met = TS.make_train_step(CFG, opt, loss_chunk=16, grad_accum=accum)(state, torch_batch(batch))
            out[accum] = (met, convert.params_to_reference(CFG, state["params"]))
        np.testing.assert_allclose(float(out[1][0]["loss"]), float(out[4][0]["loss"]), rtol=1e-5)
        assert int(out[1][0]["n_tok"]) == int(out[4][0]["n_tok"]) == batch["labels"].size
        for a, b in zip(jax.tree.leaves(out[1][1]), jax.tree.leaves(out[4][1])):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)
        js, jm = JS.make_train_step(JCFG, jopt, loss_chunk=16, grad_accum=4)(
            {"params": jp, "opt": JA.adamw_init(jp)}, jax_batch(batch))
        np.testing.assert_allclose(float(out[4][0]["loss"]), float(jm["loss"]), rtol=CE_RTOL)
        assert_tree_close(out[4][1], js["params"])

    def test_batch_not_divisible_asserts(self):
        state = TS.materialize_state(CFG, torch.Generator().manual_seed(0), device="cpu")
        with pytest.raises(AssertionError):
            TS.make_train_step(CFG, grad_accum=3)(state, torch_batch(batch_of(b=4)))


class TestAdamW:
    def test_lr_schedule_warmup_then_decay(self):
        cfg = TA.AdamWConfig(lr=1.0, warmup=10, decay_steps=100, min_lr_frac=0.1)
        assert float(TA.lr_at(cfg, torch.tensor(5, dtype=torch.int32))) == pytest.approx(0.5)
        assert float(TA.lr_at(cfg, torch.tensor(10, dtype=torch.int32))) == pytest.approx(1.0, rel=1e-3)
        assert float(TA.lr_at(cfg, torch.tensor(100, dtype=torch.int32))) == pytest.approx(0.1, rel=1e-3)
        jcfg = JA.AdamWConfig(**cfg._asdict())
        for step in (0, 1, 5, 9, 10, 11, 37, 99, 100, 150):
            got = TA.lr_at(cfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(JA.lr_at(jcfg, jnp.int32(step))), rtol=1e-6)

    def test_grad_clip_bounds_update(self):
        params = {"w": torch.zeros((4,))}
        st = TA.adamw_init(params)
        huge = {"w": torch.full((4,), 1e9)}
        cfg = TA.AdamWConfig(lr=0.1, warmup=0, grad_clip=1.0, weight_decay=0.0)
        new_p, _, metrics = TA.adamw_update(cfg, huge, st, params)
        assert float(metrics["grad_norm"]) > 1e8
        assert bool((new_p["w"].abs() < 1.0).all())

    def test_weight_decay_shrinks(self):
        params = {"w": torch.ones((4,))}
        st = TA.adamw_init(params)
        zero_g = {"w": torch.zeros((4,))}
        cfg = TA.AdamWConfig(lr=0.1, warmup=0, weight_decay=0.5, grad_clip=0.0)
        new_p, _, _ = TA.adamw_update(cfg, zero_g, st, params)
        assert bool((new_p["w"] < 1.0).all())

    @pytest.mark.parametrize("grad_clip", [1.0, 0.0])
    def test_three_updates_match_jax(self, grad_clip):
        """Parameters and both moments after 3 ``adamw_update`` steps
        (warmup then cosine decay, clipping on and off) equal the JAX
        package's, from the same parameters and gradients."""
        rng = np.random.default_rng(0)
        shapes = {"a": (7, 5), "b": (16,), "c": (3, 4, 2)}
        jp = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
        tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
        cfg = TA.AdamWConfig(lr=3e-2, warmup=2, decay_steps=5, grad_clip=grad_clip)
        jcfg = JA.AdamWConfig(**cfg._asdict())
        jst, tst = JA.adamw_init(jp), TA.adamw_init(tp)
        for _ in range(3):
            g = {k: rng.standard_normal(s).astype(np.float32) * 3 for k, s in shapes.items()}
            jp, jst, jm = JA.adamw_update(jcfg, {k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
            tp, tst, tm = TA.adamw_update(cfg, {k: torch.from_numpy(v) for k, v in g.items()}, tst, tp)
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
            np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        assert int(tst["step"]) == int(jst["step"]) == 3 and tst["step"].dtype == torch.int32
        for name, got, want in (("params", tp, jp), ("m", tst["m"], jst["m"]), ("v", tst["v"], jst["v"])):
            for k in shapes:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7,
                                           err_msg=f"{name}.{k}")


class TestTrainStep:
    @pytest.mark.parametrize("arch,accum", [("stablelm-1.6b", 1), ("deepseek-moe-16b", 2)])
    def test_three_steps_match_jax(self, arch, accum, monkeypatch):
        """Three whole train steps of a reduced arch from one state (the
        JAX package's parameters and AdamW state, carried across): every
        metric, and the parameters and moments after the third."""
        jcfg, tcfg = JC.reduced(JC.get(arch)), TC.reduced(TC.get(arch))
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        opt = TA.AdamWConfig(lr=3e-3, warmup=2, decay_steps=10)
        jstate = JS.materialize_state(jcfg, jax.random.PRNGKey(0))
        host = jax.tree.map(np.asarray, jstate)
        tstate = {"params": convert.model_params_from_reference(tcfg, host["params"], "cpu"),
                  "opt": convert.opt_state_from_reference(tcfg, host["opt"], "cpu")}
        assert list(tstate["opt"]["m"]) == list(TS.named_params(tcfg, tstate["params"]))
        jstep = jax.jit(JS.make_train_step(jcfg, JA.AdamWConfig(**opt._asdict()), loss_chunk=8, grad_accum=accum))
        tstep = TS.make_train_step(tcfg, opt, loss_chunk=8, grad_accum=accum)
        band, real = {}, TS.adamw_update

        def grab(cfg, g, st, p):  # the union over the steps of each step's near-zero gradients
            for k, m in near_zero(g).items():
                band[k] = band[k] | m if k in band else m
            return real(cfg, g, st, p)

        monkeypatch.setattr(TS, "adamw_update", grab)
        lr_sum = 0.0
        for i in range(3):
            batch = batch_of(seed=i, b=4, s=24, vocab=jcfg.vocab)
            jstate, jm = jstep(jstate, jax_batch(batch))
            tstate, tm = tstep(tstate, torch_batch(batch))
            assert sorted(tm) == sorted(jm) == ["aux", "ce", "grad_norm", "loss", "lr", "n_tok"]
            for k in ("loss", "ce", "grad_norm", "lr"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL, err_msg=f"step {i + 1} {k}")
            np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=TOL, atol=1e-7)
            assert int(tm["n_tok"]) == int(jm["n_tok"])
            lr_sum += float(jm["lr"])
        assert int(tstate["opt"]["step"]) == 3
        band = convert.params_to_reference(tcfg, band)
        assert_tree_close(convert.params_to_reference(tcfg, tstate["params"]), jstate["params"], band=band,
                          slack=2 * lr_sum, lr_sum=lr_sum)
        assert_tree_close(convert.params_to_reference(tcfg, tstate["opt"]["m"]), jstate["opt"]["m"])
        assert_tree_close(convert.params_to_reference(tcfg, tstate["opt"]["v"]), jstate["opt"]["v"])

    def test_state_specs_and_conversion_roundtrip(self):
        """``train_state_specs`` has the JAX package's shapes and dtypes
        (no pod axis), and ``params_to_reference`` inverts
        ``model_params_from_reference`` bit for bit."""
        jcfg, tcfg = JC.reduced(JC.get("zamba2-1.2b")), TC.reduced(TC.get("zamba2-1.2b"))
        jspecs = JS.train_state_specs(jcfg)
        tspecs = TS.train_state_specs(tcfg)
        shape = lambda s: (tuple(s.shape), s.dtype)  # noqa: E731
        assert (jax.tree.map(shape, jspecs, is_leaf=lambda x: hasattr(x, "axes"))
                == jax.tree.map(shape, tspecs, is_leaf=lambda x: hasattr(x, "axes")))
        host = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(3)))
        back = convert.params_to_reference(tcfg, convert.model_params_from_reference(tcfg, host, "cpu"))
        assert jax.tree.structure(back) == jax.tree.structure(host)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


class TestRemat:
    @pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-1.2b", "deepseek-moe-16b", "seamless-m4t-large-v2",
                                      "xlstm-1.3b"])
    @pytest.mark.parametrize("remat", ["full", "dots"])
    def test_remat_is_bit_neutral(self, arch, remat, monkeypatch):
        """With remat "full" or "dots" the loss and every gradient are the
        same bits as with "none", and each group's layers do run again in
        the backward (prefix and tail layers do not)."""
        base = TC.reduced(TC.get(arch))
        rng = np.random.default_rng(0)
        tok = torch.from_numpy(rng.integers(0, base.vocab, (2, 25))).long()
        fr = (torch.from_numpy(rng.standard_normal((2, base.frontend_len, base.d_model)).astype(np.float32))
              if base.frontend != "none" else None)
        calls = {"n": 0}
        real = TT.apply_block

        def counting(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)

        monkeypatch.setattr(TT, "apply_block", counting)
        out = {}
        for r in ("none", remat):
            cfg = base.scaled(remat=r)
            model = TT.Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
            params = TS.named_params(cfg, model)
            calls["n"] = 0
            h, aux = TT.forward_train(cfg, model, tok[:, :-1], fr, return_hidden=True, chunk=8)
            ce, _ = chunked_softmax_ce(cfg, model, h, tok[:, 1:], chunk=8)
            grads = torch.autograd.grad(ce + aux["aux_loss"] + aux["z_loss"], list(params.values()))
            out[r] = (ce.detach(), grads, calls["n"])
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1]))
        prefix, pattern, g, tail = TT._layout(base)
        assert out["none"][2] == base.n_layers
        assert out[remat][2] == base.n_layers + g * len(pattern)


class TestKernelFlags:
    @pytest.mark.parametrize("arch,flag", [("stablelm-1.6b", "flash_kernel"), ("xlstm-1.3b", "slstm_kernel")])
    def test_kernel_flags_refused(self, arch, flag):
        """The JAX package cannot differentiate its Pallas kernels (an
        assertion in Pallas's JVP rule); the port's train step refuses the
        flag with a ValueError that names it."""
        jcfg = JC.reduced(JC.get(arch)).scaled(**{flag: True})
        jstate = JS.materialize_state(jcfg, jax.random.PRNGKey(0))
        batch = jax_batch(batch_of(b=2, s=16, vocab=jcfg.vocab))
        with pytest.raises(AssertionError):
            JS.make_train_step(jcfg, loss_chunk=8)(jstate, batch)
        tcfg = TC.reduced(TC.get(arch)).scaled(**{flag: True})
        with pytest.raises(ValueError, match=flag):
            TS.make_train_step(tcfg)

    def test_materialize_state_on_the_cpu(self):
        state = TS.materialize_state(CFG, device="cpu")
        params = TS.named_params(CFG, state["params"])
        assert all(p.requires_grad and p.device.type == "cpu" for p in params.values())
        assert list(state["opt"]["m"]) == list(params) and state["opt"]["step"].dtype == torch.int32
        assert all(m.dtype == torch.float32 and not m.any() for m in state["opt"]["v"].values())
