"""GridLocal on a mesh with a pod axis: a real 4-rank gloo group, mesh
(pod 2, data 1, model 2), two pods running their inner steps at once on
their own sub-meshes and merging by one collective over ``pod`` a leaf;
reduced stablelm and mixtral in f32, h_steps 2, 4 steps (2 merges), both
merge modes, from the JAX package's ``gridlocal_init``.  Held to the JAX
package's single-device GridLocal step (its stand-in mesh, as
``test_torch_gridlocal.py`` runs it) with that file's rules: each step's
metrics (loss and ce within 1e-5, the rest within 1e-4), and after step 4
each pod's parameters, the anchor and the momentum by the band rule (int8:
plus a quantum a merge, both times g_j), and the moments normwise within
1e-4.  Every rank reports its pod; the ranks run while the parent steps
the reference."""

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as JC
from repro.optim import adamw as JA
from repro.optim import outer as JO
from repro.train import steps as JS
from torch_sharded_gloo import run_ranks

LOSS_RTOL, TOL = 1e-5, 1e-4  # test_torch_gridlocal.py's
ARCHS = ["stablelm-1.6b", "mixtral-8x22b"]
MODES = ["none", "int8"]
OPT = dict(lr=3e-3, warmup=2, decay_steps=10)
OUTER = dict(h_steps=2, outer_lr=0.7, outer_momentum=0.9)

BODY = r"""
import numpy as np
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.launch.mesh import make_device_mesh, make_test_mesh
from repro_torch.optim import adamw as TA
from repro_torch.optim import outer as TO
from repro_torch.sharding import GRIDLOCAL, activate
from repro_torch.train import steps as TS

mesh = make_device_mesh(make_test_mesh(1, 2, n_pods=2), "cpu")
pod = mesh.get_local_rank("pod")
real_update, real_quant = TS.adamw_update, TO.quantize_delta
for key, (arch, compress, jstate, batches) in INPUTS["cases"].items():
    cfg = TC.reduced(TC.get(arch))
    state = TS.shard_gridlocal_state(cfg, convert.state_from_reference(cfg, jstate, "cpu"), mesh)
    outer = TO.OuterConfig(compress=compress, **INPUTS["outer"])
    step = TS.make_gridlocal_train_step(cfg, 2, TA.AdamWConfig(**INPUTS["opt"]), outer, loss_chunk=8,
                                        device_mesh=mesh)
    bands, scales, mets = [], [], []

    def grab(c, g, st, p):
        full = {k: v.full_tensor() for k, v in g.items()}
        bands.append({k: ((v.abs() <= 2 * INPUTS["tol"] * v.abs().max()) & (v != 0)).numpy() for k, v in full.items()})
        return real_update(c, g, st, p)

    def spy(delta, scale=None):
        q, s = real_quant(delta, scale)
        scales.append(float(s))
        return q, s

    TS.adamw_update, TO.quantize_delta = grab, spy
    for batch in batches:
        with activate(mesh, GRIDLOCAL):
            state, met = step(state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        mets.append({k: float(v) for k, v in met.items()})
    TS.adamw_update, TO.quantize_delta = real_update, real_quant
    model = state["params"][0]
    RESULTS[key] = {
        "pod": pod, "mets": mets, "bands": bands, "scales": scales,
        "step": int(state["opt"][0]["step"]),
        "params": convert.params_to_reference(cfg, model),
        "m": convert.params_to_reference(cfg, state["opt"][0]["m"]),
        "v": convert.params_to_reference(cfg, state["opt"][0]["v"]),
        "anchor": convert.params_to_reference(cfg, state["outer"]["anchor"]),
        "momentum": convert.params_to_reference(cfg, state["outer"]["momentum"]),
        "names": list(state["outer"]["anchor"]),
    }
"""


def _batches(vocab):
    out = []
    for i in range(4):
        t = np.random.default_rng(i).integers(0, vocab, (4, 25), dtype=np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _reference(arch, compress, jstate, batches):
    jcfg = JC.reduced(JC.get(arch))
    step = jax.jit(JS.make_gridlocal_train_step(jcfg, types.SimpleNamespace(shape={"pod": 2}),
                                                JA.AdamWConfig(**OPT), JO.OuterConfig(compress=compress, **OUTER),
                                                loss_chunk=8))
    mets = []
    for b in batches:
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        mets.append({k: float(v) for k, v in jm.items()})
    return jstate, mets


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases, refs = {}, {}
    for arch in ARCHS:
        jcfg = JC.reduced(JC.get(arch))
        jstate = JS.gridlocal_init(jcfg, jax.random.PRNGKey(0), 2)
        batches = _batches(jcfg.vocab)
        for compress in MODES:
            cases[f"{arch}/{compress}"] = (arch, compress, jax.tree.map(np.asarray, jstate), batches)
            refs[f"{arch}/{compress}"] = (arch, compress, jstate, batches)
    box = {}
    th = threading.Thread(target=lambda: box.update(out=run_ranks(
        BODY, {"cases": cases, "opt": OPT, "outer": OUTER, "tol": TOL}, tmp_path_factory.mktemp("ranks"),
        every_rank=True)))
    th.start()
    done = {k: _reference(*v) for k, v in refs.items()}
    th.join()
    return done, box["out"]


def _gains(n_merges: int) -> list[float]:
    mu, lr = OUTER["outer_momentum"], OUTER["outer_lr"]
    return [lr * (1 + sum(mu**t for t in range(1, n_merges - j + 2))) for j in range(1, n_merges + 1)]


def _hold(got, want, band, lr_eff, slack, path=""):
    """``test_torch_gridlocal.hold``: (elements that needed the band, elements)."""
    if isinstance(want, (dict, list)):
        pairs = list(want.items()) if isinstance(want, dict) else list(enumerate(want))
        used = n = 0
        for k, w in pairs:
            u, m = _hold(got[k], w, band[k], lr_eff, None if slack is None else slack[k], f"{path}/{k}")
            used, n = used + u, n + m
        return used, n
    w = np.asarray(want, np.float32)
    assert got.shape == w.shape, path
    strict = TOL * float(np.abs(w).max()) + 1e-2 * lr_eff + (0.0 if slack is None else slack)
    err = np.abs(got - w)
    atol = np.where(band, strict + 2 * lr_eff, strict)
    np.testing.assert_array_less(err, np.maximum(atol, 1e-30) * (1 + 1e-6) + 1e-30, err_msg=path)
    return int((band & (err > strict)).sum()), w.size


def _stacked(cfg, named):
    from repro_torch import convert

    import torch
    return convert.params_to_reference(cfg, {k: torch.from_numpy(np.asarray(v)) for k, v in named.items()})


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compress", MODES)
def test_sharded_gridlocal_four_steps_match_jax(arch, compress, results):
    from repro_torch import configs as TC

    done, ranks = results
    jstate, jmets = done[f"{arch}/{compress}"]
    tcfg = TC.reduced(TC.get(arch))
    by_pod = {}
    for r in ranks:
        got = r[f"{arch}/{compress}"]
        by_pod.setdefault(got["pod"], got)
    assert sorted(by_pod) == [0, 1]
    for pod, got in by_pod.items():
        assert got["step"] == 4
        for i, (tm, jm) in enumerate(zip(got["mets"], jmets)):
            for k in ("loss", "ce"):
                np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, err_msg=f"pod {pod} step {i + 1} {k}")
            for k in ("grad_norm", "lr", "n_tok"):
                np.testing.assert_allclose(tm[k], jm[k], rtol=TOL, err_msg=f"pod {pod} step {i + 1} {k}")
    names = by_pod[0]["names"]
    lrs = [m["lr"] for m in jmets]
    g = _gains(2)
    lr_eff = g[0] * (lrs[0] + lrs[1]) + g[1] * (lrs[2] + lrs[3])
    band = {k: np.zeros_like(by_pod[0]["bands"][0][k]) for k in names}
    for got in by_pod.values():
        for b in got["bands"]:
            band = {k: band[k] | b[k] for k in names}
    slack = None
    if compress == "int8":
        scales = by_pod[0]["scales"]
        assert len(scales) == 2 * len(names) and scales == by_pod[1]["scales"]
        quanta = [dict(zip(names, scales[j * len(names):(j + 1) * len(names)])) for j in range(2)]
        slack = _stacked(tcfg, {k: np.full(band[k].shape, sum(g[j] * quanta[j][k] / 127 for j in range(2)),
                                           np.float32) for k in names})
    else:
        assert not by_pod[0]["scales"]
    band = _stacked(tcfg, band)
    used = n = 0
    for pod, got in by_pod.items():
        u, m = _hold(got["params"], jax.tree.map(lambda x: x[pod], jstate["params"]), band, lr_eff, slack)
        used, n = used + u, n + m
    for k in ("anchor", "momentum"):
        u, m = _hold(by_pod[0][k], jstate["outer"][k], band, lr_eff, slack)
        used, n = used + u, n + m
    assert used * 1000 < n, (used, n)
    for pod, got in by_pod.items():
        for k in ("m", "v"):
            for path, w in jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda x: x[pod], jstate["opt"][k]))[0]:
                gg = got[k]
                for p in path:
                    gg = gg[p.key if hasattr(p, "key") else p.idx]
                w = np.asarray(w)
                assert np.linalg.norm(gg - w) <= TOL * np.linalg.norm(w), (pod, k, jax.tree_util.keystr(path))
