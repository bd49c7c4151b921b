"""GridLocal in the port against the JAX package, on the CPU: the outer
optimiser (``optim/outer.py``), the single-host simulation
(``core/gridlocal.py``) and the multi-pod train step
(``train.steps.make_gridlocal_train_step``, ``gridlocal_init``).

Mirrors ``tests/test_train_steps.py``'s ``TestGridLocalSimulation`` and
``TestOuterCompression``.  The JAX package's GridLocal step reads only the
pod count off its mesh and constrains nothing outside a sharding context,
so it runs here on one CPU device with a stand-in mesh.  Both packages
start from one state (the JAX package's ``gridlocal_init``, carried
across by ``convert.state_from_reference``) and take the same seeded numpy
batches.  Tolerances, float32 throughout: losses within 1e-5 relative,
grad norms and learning rates within 1e-4; ``quantize_delta``'s q and
scale and ``outer_update`` bit for bit; AdamW's moments after whole
GridLocal steps normwise within 1e-4 a leaf.  Parameters after whole steps are
held by ``tests/test_torch_train.py``'s band rule (1e-4 of the leaf's
largest magnitude plus 1% of Σlr, and 2·Σlr more where a step's gradient
was non-zero but within 2e-4 of zero, fewer than 1 in 1,000 elements
needing it), with Σlr carried through the outer steps: the merge of round
j enters the final anchor times ``g_j = outer_lr·(1 + Σ_{t=1}^{M−j+1}
μ^t)`` for M merges (the Nesterov step's lr·(1 + μ), then μ·lr again
through the momentum at each later merge), so Σlr is ``Σ_j g_j·Σ_{i in
round j} lr_i``.  In int8 a delta that lies within the other package's
error of a rounding boundary may round the other way: one quantum
(``scale/127``) a merge, times the same g_j, comes on top.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.core.gridlocal import simulate as j_simulate
from repro.optim import adamw as JA
from repro.optim import outer as JO
from repro.train import steps as JS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core.gridlocal import GridLocalReport, param_bytes, simulate
from repro_torch.optim import adamw as TA
from repro_torch.optim import outer as TO
from repro_torch.train import steps as TS

LOSS_RTOL = 1e-5
TOL = 1e-4
ARCH = "stablelm-1.6b"


def regression_data(n_steps, n_sites, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(8, 1)).astype(np.float32)
    xs = rng.normal(size=(n_steps, n_sites, 64, 8)).astype(np.float32)
    ys = xs @ w_true + 0.01 * rng.normal(size=(n_steps, n_sites, 64, 1)).astype(np.float32)
    return w_true, {"x": xs, "y": ys}


def t_loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def j_loss(params, batch):
    return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


class TestGridLocalSimulation:
    def test_technique_trains_and_cuts_comm(self):
        """The paper's minimal-sync training: the loss falls AND the
        communication ledger shows the H x reduction against synchronous
        data parallelism."""
        w_true, data = regression_data(64, 4)
        batches = {k: torch.from_numpy(v) for k, v in data.items()}
        params0 = {"w": torch.zeros((8, 1))}
        opt = TA.AdamWConfig(lr=5e-2, warmup=0, decay_steps=10**9, weight_decay=0.0)

        # paper-faithful aggregation (plain size-weighted merge) recovers w
        outer = TO.OuterConfig(h_steps=8, outer_lr=1.0, outer_momentum=0.0)
        final, rep = simulate(t_loss, params0, batches, 4, opt_cfg=opt, outer_cfg=outer)
        assert isinstance(rep, GridLocalReport) and rep.n_merges == 8
        assert rep.losses[-1] < rep.losses[0] * 0.5
        assert rep.sync_bytes * outer.h_steps == rep.dp_bytes
        np.testing.assert_allclose(final["w"].numpy(), w_true, atol=0.1)
        assert not params0["w"].any()  # the caller's parameters are untouched

        # the outer Nesterov step (DiLoCo-style) also trains
        _, rep2 = simulate(t_loss, params0, batches, 4, opt_cfg=opt,
                           outer_cfg=TO.OuterConfig(h_steps=8, outer_lr=0.7, outer_momentum=0.9))
        assert rep2.losses[-1] < rep2.losses[0] * 0.5

    @pytest.mark.parametrize("h_steps,lr,mu", [(8, 1.0, 0.0), (4, 0.7, 0.9), (5, 0.7, 0.9)])
    def test_matches_jax_simulate(self, h_steps, lr, mu):
        """The same numpy data through both simulations: the report's
        counts equal, the round losses within 1e-5, the final parameters
        within the f32 tolerance (h_steps 5 leaves a partial round)."""
        _, data = regression_data(24, 3, seed=1)
        opt = TA.AdamWConfig(lr=5e-2, warmup=2, decay_steps=30, weight_decay=0.1)
        outer = TO.OuterConfig(h_steps=h_steps, outer_lr=lr, outer_momentum=mu)
        final, rep = simulate(t_loss, {"w": torch.zeros((8, 1))}, {k: torch.from_numpy(v) for k, v in data.items()},
                              3, opt_cfg=opt, outer_cfg=outer)
        jfinal, jrep = j_simulate(j_loss, {"w": jnp.zeros((8, 1))}, {k: jnp.asarray(v) for k, v in data.items()},
                                  3, opt_cfg=JA.AdamWConfig(**opt._asdict()),
                                  outer_cfg=JO.OuterConfig(**outer._asdict()))
        assert (rep.n_merges, rep.sync_bytes, rep.dp_bytes) == (jrep.n_merges, jrep.sync_bytes, jrep.dp_bytes)
        assert rep.n_merges == 24 // h_steps and len(rep.losses) == len(jrep.losses)
        np.testing.assert_allclose(rep.losses, jrep.losses, rtol=LOSS_RTOL)
        w = np.asarray(jfinal["w"])
        np.testing.assert_allclose(final["w"].numpy(), w, rtol=0, atol=TOL * float(np.abs(w).max()))

    def test_param_bytes(self):
        params = {"a": torch.zeros((3, 4)), "b": torch.zeros((5,), dtype=torch.bfloat16),
                  "c": torch.zeros((2,), dtype=torch.int8)}
        assert param_bytes(params) == 3 * 4 * 4 + 5 * 2 + 2


class TestOuterCompression:
    def test_quantize_roundtrip_error_bounded(self):
        rng = np.random.default_rng(0)
        delta = torch.from_numpy(rng.normal(0, 0.01, (64, 32)).astype(np.float32))
        q, scale = TO.quantize_delta(delta)
        back = TO.dequantize_delta(q.float(), scale)
        assert float((back - delta).abs().max()) <= float(scale) / 127.0 + 1e-9
        assert q.dtype == torch.int8

    @staticmethod
    def ties() -> np.ndarray:
        """Deltas at exact rounding ties: x·127 is k + 0.5 in f32 for x the
        f32 nearest (k + 0.5)/127, with max |x| = 1 so the scale is 1."""
        k = np.arange(-127, 127, dtype=np.float32)
        x = ((k + 0.5) / np.float32(127)).astype(np.float32)
        x = x[(x / np.float32(1.0)) * np.float32(127) == k + np.float32(0.5)]
        assert x.size > 100
        return np.concatenate([x, np.float32([1.0, -1.0])])

    @pytest.mark.parametrize("case", ["normal", "ties", "zeros", "given_scale", "stacked"])
    def test_bit_equal_to_jax(self, case):
        """q and scale (and the dequantised values) bit for bit: random
        deltas, exact .5 ties (half to even on both sides), an all-zero
        delta (scale 1e-12), a scale given by the caller, and a pod-stacked
        delta with one scale over all pods."""
        rng = np.random.default_rng(3)
        scale = None
        if case == "ties":
            delta = self.ties()
        elif case == "zeros":
            delta = np.zeros((7, 5), np.float32)
        elif case == "stacked":
            delta = rng.normal(0, 1e-3, (2, 33, 17)).astype(np.float32)
            delta[1] *= 3
        else:
            delta = rng.normal(0, 0.02, (129, 65)).astype(np.float32)
            if case == "given_scale":
                scale = np.float32(0.01)  # smaller than max |delta|: the clip bites
        jq, js = JO.quantize_delta(jnp.asarray(delta), None if scale is None else jnp.float32(scale))
        tq, ts = TO.quantize_delta(torch.from_numpy(delta), None if scale is None else torch.tensor(scale))
        assert tq.dtype == torch.int8 and np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.asarray(ts, np.float32).tobytes() == np.asarray(js, np.float32).tobytes()
        if case == "ties":
            assert set(np.abs(tq.numpy()[:-2]) % 2) == {0}  # every tie went to the even neighbour
        if case == "zeros":
            assert float(ts) == np.float32(1e-12) and not tq.any()
        back, jback = TO.dequantize_delta(tq, ts), JO.dequantize_delta(jq, js)
        assert np.array_equal(back.numpy(), np.asarray(jback))

    def test_outer_update_bit_equal_to_jax(self):
        """The Nesterov outer step, from a non-zero momentum, bit for bit;
        the returned parameters and the new anchor are tensors of their
        own."""
        rng = np.random.default_rng(5)
        shapes = {"a": (6, 4), "b": (9,)}
        draw = lambda: {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}  # noqa: E731
        anchor, mom, merged = draw(), draw(), draw()
        cfg = TO.OuterConfig(outer_lr=0.7, outer_momentum=0.9)
        jnew, jst = JO.outer_update(JO.OuterConfig(**cfg._asdict()),
                                    {"anchor": {k: jnp.asarray(v) for k, v in anchor.items()},
                                     "momentum": {k: jnp.asarray(v) for k, v in mom.items()}},
                                    {k: jnp.asarray(v) for k, v in merged.items()})
        t = lambda d: {k: torch.from_numpy(v.copy()) for k, v in d.items()}  # noqa: E731
        state = {"anchor": t(anchor), "momentum": t(mom)}
        new, st = TO.outer_update(cfg, state, t(merged))
        for k in shapes:
            assert np.array_equal(new[k].numpy(), np.asarray(jnew[k]))
            assert np.array_equal(st["anchor"][k].numpy(), np.asarray(jst["anchor"][k]))
            assert np.array_equal(st["momentum"][k].numpy(), np.asarray(jst["momentum"][k]))
            assert new[k].data_ptr() != st["anchor"][k].data_ptr()
            assert np.array_equal(state["anchor"][k].numpy(), anchor[k])  # the old state is left as it was

    def test_outer_init_copies(self):
        params = {"w": torch.ones((3, 2), requires_grad=True)}
        st = TO.outer_init(params)
        with torch.no_grad():
            params["w"].add_(1.0)
        assert torch.equal(st["anchor"]["w"], torch.ones((3, 2))) and not st["anchor"]["w"].requires_grad
        assert st["momentum"]["w"].dtype == torch.float32 and not st["momentum"]["w"].any()


def near_zero(grads: dict) -> dict:
    return {k: (g.abs() <= 2 * TOL * g.abs().max()) & (g != 0) for k, g in grads.items()}


def hold(got, want, band, lr_eff: float, slack=None, path="") -> tuple[int, int]:
    """The band rule over a JAX-layout tree (numpy): each element within
    TOL of its leaf's largest magnitude plus 1% of ``lr_eff`` (plus
    ``slack``, a like tree, where given), and within 2·``lr_eff`` more where
    ``band`` is set.  Returns (elements that needed the band, elements)."""
    if isinstance(want, dict):
        pairs = [(k, want[k]) for k in want]
    elif isinstance(want, list):
        pairs = list(enumerate(want))
    else:
        w = np.asarray(want, np.float32)
        assert got.shape == w.shape, path
        strict = TOL * float(np.abs(w).max()) + 1e-2 * lr_eff + (0.0 if slack is None else slack)
        err = np.abs(got - w)
        atol = np.where(band, strict + 2 * lr_eff, strict) if band is not None else strict
        np.testing.assert_array_less(err, np.maximum(atol, 1e-30) * (1 + 1e-6) + 1e-30, err_msg=path)
        return (int((band & (err > strict)).sum()) if band is not None else 0), w.size
    used = n = 0
    for k, w in pairs:
        u, m = hold(got[k], w, None if band is None else band[k], lr_eff,
                    None if slack is None else slack[k], f"{path}/{k}")
        used, n = used + u, n + m
    return used, n


def gains(outer: TO.OuterConfig, n_merges: int) -> list[float]:
    """g_j of the module docstring for j = 1..n_merges."""
    mu = outer.outer_momentum
    return [outer.outer_lr * (1 + sum(mu**t for t in range(1, n_merges - j + 2))) for j in range(1, n_merges + 1)]


def stand_in_mesh(n_pods):
    return types.SimpleNamespace(shape={"pod": n_pods})


class TestGridLocalStep:
    @pytest.mark.parametrize("compress", ["none", "int8"])
    def test_four_steps_match_jax(self, compress, monkeypatch):
        """Reduced stablelm in f32, 2 pods, h_steps 2, 4 steps (2 merges)
        from the JAX package's ``gridlocal_init``: every metric each step;
        the pods apart after the odd steps and equal to each other and to
        the anchor after each merge; after step 4 the pods' parameters and
        the anchor by the band rule (int8: plus a quantum a merge, both
        times g_j), the momentum by the same bound, and each leaf of the
        moments normwise within 1e-4 (elementwise they carry the band:
        a parameter that stepped the other way at a near-zero gradient
        moves its neighbours' later gradients by more than 1e-4 of the
        leaf's largest)."""
        jcfg, tcfg = JC.reduced(JC.get(ARCH)), TC.reduced(TC.get(ARCH))
        opt = TA.AdamWConfig(lr=3e-3, warmup=2, decay_steps=10)
        outer = TO.OuterConfig(h_steps=2, outer_lr=0.7, outer_momentum=0.9, compress=compress)
        jstate = JS.gridlocal_init(jcfg, jax.random.PRNGKey(0), 2)
        tstate = convert.state_from_reference(tcfg, jax.tree.map(np.asarray, jstate), "cpu")
        jstep = jax.jit(JS.make_gridlocal_train_step(jcfg, stand_in_mesh(2), JA.AdamWConfig(**opt._asdict()),
                                                     JO.OuterConfig(**outer._asdict()), loss_chunk=8))
        tstep = TS.make_gridlocal_train_step(tcfg, 2, opt, outer, loss_chunk=8)

        bands, scales = [], []
        real_update, real_quant = TS.adamw_update, TO.quantize_delta

        def grab(cfg, g, st, p):
            bands.append(near_zero(g))
            return real_update(cfg, g, st, p)

        def spy(delta, scale=None):
            q, s = real_quant(delta, scale)
            scales.append(float(s))
            return q, s

        monkeypatch.setattr(TS, "adamw_update", grab)
        monkeypatch.setattr(TO, "quantize_delta", spy)
        lrs = []
        for i in range(4):
            rng = np.random.default_rng(i)
            t = rng.integers(0, jcfg.vocab, (4, 25), dtype=np.int32)
            batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            tstate, tm = tstep(tstate, {k: torch.from_numpy(v).long() for k, v in batch.items()})
            assert sorted(tm) == sorted(jm) and all(v.dtype == torch.float32 for v in tm.values())
            for k in ("loss", "ce"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=f"step {i + 1} {k}")
            for k in ("grad_norm", "lr", "n_tok"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL, err_msg=f"step {i + 1} {k}")
            lrs.append(float(jm["lr"]))
            pods = [TS.named_params(tcfg, m) for m in tstate["params"]]
            equal = all(torch.equal(pods[0][k], pods[1][k]) for k in pods[0])
            if i % 2:
                assert equal and all(torch.equal(pods[0][k], a) for k, a in tstate["outer"]["anchor"].items())
            else:
                assert not equal
        assert [int(o["step"]) for o in tstate["opt"]] == [4, 4]

        names = list(tstate["outer"]["anchor"])
        g = gains(outer, 2)
        lr_eff = g[0] * (lrs[0] + lrs[1]) + g[1] * (lrs[2] + lrs[3])
        band = {k: torch.zeros_like(tstate["outer"]["anchor"][k], dtype=torch.bool) for k in names}
        for b in bands:
            band = {k: band[k] | b[k] for k in names}
        slack = None
        if compress == "int8":
            assert len(scales) == 2 * len(names)
            quanta = [dict(zip(names, scales[j * len(names):(j + 1) * len(names)])) for j in range(2)]
            slack = convert.params_to_reference(tcfg, {
                k: torch.full_like(tstate["outer"]["anchor"][k], sum(g[j] * quanta[j][k] / 127 for j in range(2)))
                for k in names})
        else:
            assert not scales
        band = convert.params_to_reference(tcfg, band)
        got = convert.state_to_reference(tcfg, tstate)
        used = n = 0
        for pod in range(2):
            u, m = hold(jax.tree.map(lambda x: x[pod], got["params"]), jax.tree.map(lambda x: x[pod], jstate["params"]),
                        band, lr_eff, slack)
            used, n = used + u, n + m
        for k in ("anchor", "momentum"):
            u, m = hold(got["outer"][k], jstate["outer"][k], band, lr_eff, slack)
            used, n = used + u, n + m
        assert used * 1000 < n, (used, n)
        for k in ("m", "v"):
            for path, w in jax.tree_util.tree_flatten_with_path(jstate["opt"][k])[0]:
                g = got["opt"][k]
                for p in path:
                    g = g[p.key if hasattr(p, "key") else p.idx]
                w = np.asarray(w)
                assert np.linalg.norm(g - w) <= TOL * np.linalg.norm(w), (k, jax.tree_util.keystr(path))

    def test_state_shares_no_storage(self):
        """The anchor, the momentum and every pod's parameters and moments
        are tensors of their own after ``gridlocal_init`` and after a
        merge; the merge leaves the moments where AdamW put them."""
        cfg = TC.reduced(TC.get(ARCH))
        state = TS.gridlocal_init(cfg, torch.Generator().manual_seed(0), n_pods=3, device="cpu")

        def ptrs(st):
            out = [t.data_ptr() for m in st["params"] for t in m.parameters()]
            out += [t.data_ptr() for o in st["opt"] for k in ("m", "v") for t in o[k].values()]
            return out + [t.data_ptr() for k in ("anchor", "momentum") for t in st["outer"][k].values()]

        p = ptrs(state)
        assert len(set(p)) == len(p)
        pods = [TS.named_params(cfg, m) for m in state["params"]]
        assert all(torch.equal(a, pods[i][k]) for k, a in state["outer"]["anchor"].items() for i in range(3))
        step = TS.make_gridlocal_train_step(cfg, 3, TA.AdamWConfig(lr=1e-2, warmup=0),
                                            TO.OuterConfig(h_steps=1), loss_chunk=8)
        t = np.random.default_rng(0).integers(0, cfg.vocab, (3, 17))
        state, _ = step(state, {"tokens": torch.from_numpy(t[:, :-1]), "labels": torch.from_numpy(t[:, 1:])})
        p = ptrs(state)
        assert len(set(p)) == len(p)
        assert all(o["m"][k].any() for o in state["opt"] for k in o["m"])
        first = next(iter(state["outer"]["anchor"]))
        with torch.no_grad():
            TS.named_params(cfg, state["params"][0])[first].add_(1.0)
        anchor, pod1 = state["outer"]["anchor"][first], TS.named_params(cfg, state["params"][1])[first]
        assert torch.equal(anchor, pod1) and not torch.equal(anchor, TS.named_params(cfg, state["params"][0])[first])

    def test_state_specs_match_jax(self):
        jcfg, tcfg = JC.reduced(JC.get(ARCH)), TC.reduced(TC.get(ARCH))
        shape = lambda s: (tuple(s.shape), s.dtype, tuple(s.axes))  # noqa: E731
        leaf = lambda x: hasattr(x, "axes")  # noqa: E731
        for n_pods in (0, 2):
            assert (jax.tree.map(shape, JS.train_state_specs(jcfg, n_pods), is_leaf=leaf)
                    == jax.tree.map(shape, TS.train_state_specs(tcfg, n_pods), is_leaf=leaf))

    def test_batch_split_and_flags(self):
        cfg = TC.reduced(TC.get(ARCH))
        state = TS.gridlocal_init(cfg, n_pods=2, device="cpu")
        t = torch.zeros((3, 9), dtype=torch.long)
        with pytest.raises(ValueError, match="pods"):
            TS.make_gridlocal_train_step(cfg, 2)(state, {"tokens": t, "labels": t})
        with pytest.raises(ValueError, match="flash_kernel"):
            TS.make_gridlocal_train_step(cfg.scaled(flash_kernel=True), 2)
