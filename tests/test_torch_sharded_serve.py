"""Prefill and two decode steps sharded on a real 4-rank gloo group, mesh
(data 2, model 2): gemma2-2b, xlstm-1.3b and seamless-m4t-large-v2,
reduced, f32, from the JAX package's parameters (``convert``), the model
and cache placed by ``BASELINE``.  The logits of the prefill and of each
decode step, and every cache leaf after each (gathered with
``full_tensor()``), held to the JAX package's single-device steps within
``test_torch_model.py``'s float32 tolerance (1e-4, relative and absolute).
The ranks run while the parent computes the reference."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as JC
from repro.models import transformer as JT
from torch_sharded_gloo import run_ranks

B, S = 4, 24  # a prompt of S - 2, then decode at S - 2 and S - 1
F32_TOL = 1e-4  # test_torch_model.py's
ARCHS = ["gemma2-2b", "xlstm-1.3b", "seamless-m4t-large-v2"]

BODY = r"""
import numpy as np
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.data.pipeline import place_batch
from repro_torch.launch.mesh import make_device_mesh, make_test_mesh
from repro_torch.models import transformer as TT
from repro_torch.sharding import BASELINE, activate
from repro_torch.train import steps as TS

mesh = make_device_mesh(make_test_mesh(2, 2), "cpu")
for arch, (params, toks, frames) in INPUTS["cases"].items():
    cfg = TC.reduced(TC.get(arch))
    model = TS.shard_model(cfg, convert.model_params_from_reference(cfg, params, "cpu"), mesh, BASELINE)
    cache = TS.shard_cache(cfg, TT.init_cache(cfg, toks.shape[0], toks.shape[1], "cpu"), mesh, BASELINE)
    t = torch.from_numpy(toks).long()
    s = t.shape[1]
    batch = {"tokens": t[:, :-2]}
    if frames is not None:
        batch["frontend"] = torch.from_numpy(frames)
    out = {}
    with activate(mesh, BASELINE):
        lg, cache = TS.make_prefill_step(cfg)(model, place_batch(batch, mesh, BASELINE), cache)
        out["prefill"] = (lg.full_tensor().numpy(), convert.cache_to_reference(cfg, cache))
        for i, pos in enumerate((s - 2, s - 1)):
            dec = place_batch({"token": t[:, pos:pos + 1], "pos": pos}, mesh, BASELINE)
            lg, cache = TS.make_decode_step(cfg)(model, dec, cache)
            out[f"decode{i}"] = (lg.full_tensor().numpy(), convert.cache_to_reference(cfg, cache))
    RESULTS[arch] = out
"""


def _case(arch):
    jcfg = JC.reduced(JC.get(arch))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    frames = (rng.standard_normal((B, jcfg.frontend_len, jcfg.d_model)).astype(np.float32)
              if jcfg.frontend != "none" else None)
    return jcfg, params, toks, frames


def _reference(jcfg, params, toks, frames):
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), JT.cache_specs(jcfg, B, S),
                         is_leaf=lambda x: hasattr(x, "axes"))
    out = {}
    lg, cache = JT.prefill(jcfg, params, jnp.asarray(toks[:, :-2]), cache,
                           None if frames is None else jnp.asarray(frames))
    out["prefill"] = (np.asarray(lg), jax.tree.map(np.asarray, cache))
    for i, pos in enumerate((S - 2, S - 1)):
        lg, cache = JT.decode_step(jcfg, params, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos), cache)
        out[f"decode{i}"] = (np.asarray(lg), jax.tree.map(np.asarray, cache))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases = {a: _case(a) for a in ARCHS}
    inputs = {a: (jax.tree.map(np.asarray, c[1]), c[2], c[3]) for a, c in cases.items()}
    box = {}
    th = threading.Thread(target=lambda: box.update(out=run_ranks(BODY, {"cases": inputs},
                                                                  tmp_path_factory.mktemp("ranks"))))
    th.start()
    done = {a: _reference(*c) for a, c in cases.items()}
    th.join()
    return done, box["out"]


def _close_trees(got, want, where):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"{where} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("stage", ["prefill", "decode0", "decode1"])
def test_sharded_serving_matches_jax(arch, stage, results):
    done, got = results
    (jlg, jcache), (tlg, tcache) = done[arch][stage], got[arch][stage]
    np.testing.assert_allclose(tlg, np.asarray(jlg), rtol=F32_TOL, atol=F32_TOL, err_msg=f"{arch} {stage} logits")
    _close_trees(tcache, jcache, f"{arch} {stage}")
