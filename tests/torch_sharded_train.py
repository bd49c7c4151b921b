"""One sharded train step of reduced archs on a real 4-rank gloo group,
mesh (data 2, model 2), held to the JAX package's single-device step with
the tolerances of ``test_torch_train_archs.py``: the loss within 1e-5
relative, the grad norm within 1e-4, and the parameters and both moments
after one AdamW step by its band rule.  The state is the JAX package's
draw carried across by ``convert``, placed by ``BASELINE``; each rank's
result comes back whole through ``full_tensor()``.  The ranks run while
the parent computes the reference, so a file costs the longer of the two.
A case is an arch, for the MoE archs a dispatch form (``groups`` 0 is
the global form, 2 the local one, on both sides), and ``grad_accum``.
With ``grad_accum`` > 1 the reference is the JAX package's own
``grad_accum`` step fed the batch in its own order: microbatch i is the
global rows ``[i·B/n, (i+1)·B/n)`` on both sides.  ``run_cases`` also
takes another mesh, batch size and label mask."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as JC
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train import steps as JS
from repro.train.losses import chunked_softmax_ce as j_ce
from torch_sharded_gloo import run_ranks

B, S, CHUNK = 4, 24, 8
DATA = 2  # the mesh's data ranks, over which the batch is split
LOSS_RTOL, TOL = 1e-5, 1e-4  # test_torch_train_archs.py's
OPT = dict(lr=3e-3, warmup=0, decay_steps=10)

BODY = r"""
import numpy as np
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.data.pipeline import place_batch
from repro_torch.launch.mesh import make_device_mesh, make_test_mesh
from repro_torch.optim import adamw as TA
from repro_torch.sharding import BASELINE, activate
from repro_torch.train import steps as TS
import dataclasses

mesh = make_device_mesh(make_test_mesh(*INPUTS["mesh"]), "cpu")
for key, (arch, groups, accum, params, batch) in INPUTS["cases"].items():
    cfg = dataclasses.replace(TC.reduced(TC.get(arch)), moe_dispatch_groups=groups)
    model = convert.model_params_from_reference(cfg, params, "cpu")
    state = TS.shard_state(cfg, {"params": model, "opt": TA.adamw_init(TS.named_params(cfg, model))}, mesh, BASELINE)
    tb = place_batch({k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                              for k, v in batch.items()}, mesh, BASELINE)
    step = TS.make_train_step(cfg, TA.AdamWConfig(**INPUTS["opt"]), loss_chunk=INPUTS["chunk"], grad_accum=accum)
    with activate(mesh, BASELINE):
        state, met = step(state, tb)
    out = {k: float(v.full_tensor() if hasattr(v, "full_tensor") else v) for k, v in met.items()}
    out["params"] = convert.params_to_reference(cfg, state["params"])
    out["m"] = convert.params_to_reference(cfg, state["opt"]["m"])
    out["v"] = convert.params_to_reference(cfg, state["opt"]["v"])
    out["placed"] = sorted({str(p.placements) for p in state["params"].parameters()})
    RESULTS[key] = out
"""


def _batch(cfg, rows=B):
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (rows, S + 1), dtype=np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.frontend != "none":
        batch["frontend"] = rng.standard_normal((rows, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def _config(arch, groups):
    return dataclasses.replace(JC.reduced(JC.get(arch)), moe_dispatch_groups=groups)


def _loss(jcfg, p, b):
    h, aux = JT.forward_train(jcfg, p, b["tokens"], b.get("frontend"), return_hidden=True)
    ce, _ = j_ce(jcfg, p, h, b["labels"], chunk=CHUNK)
    return ce + aux["aux_loss"] + aux["z_loss"]


def _reference(jcfg, params, batch, accum, jit=False):
    """The JAX package's step, eager (or under ``jax.jit``, as its entry
    runs it)."""
    on = jax.jit if jit else (lambda f: f)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    if accum == 1:
        loss, grads = on(jax.value_and_grad(lambda p: _loss(jcfg, p, batch)))(params)
        new_p, new_opt, met = JA.adamw_update(JA.AdamWConfig(**OPT), grads, JA.adamw_init(params), params)
        return loss, grads, new_p, new_opt, met
    step = on(JS.make_train_step(jcfg, JA.AdamWConfig(**OPT), loss_chunk=CHUNK, grad_accum=accum))
    state, met = step({"params": params, "opt": JA.adamw_init(params)}, batch)
    mb = len(batch["tokens"]) // accum
    micro = [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()} for i in range(accum)]
    # the step's mean gradient, for the band rule of ``_close``
    grads = on(jax.grad(lambda p: sum(_loss(jcfg, p, b) for b in micro) / accum))(params)
    return met["loss"], grads, state["params"], state["opt"], met


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key if hasattr(p, "key") else p.idx]
    return tree


def _close(got, want, band_of=None, slack=0.0, lr=0.0):
    """``test_torch_train_archs._close``: every leaf within TOL of its
    largest magnitude (plus 1% of ``lr``), within ``slack`` more where the
    gradient ``band_of`` is not zero but within TOL of it, fewer than 1 in
    1,000 elements needing that."""
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


def key_of(arch, groups, accum=1) -> str:
    return f"{arch}/{groups}" + (f"/ga{accum}" if accum > 1 else "")


def run_cases(cases, tmp_path, mesh=(DATA, 2), rows=B, mask=None, jit=False):
    """cases: (arch, groups[, grad_accum]) -> {key: (reference tuple, rank
    0's result)}, on a (data, model) ``mesh`` of gloo ranks, with ``rows``
    rows a batch; ``mask`` (rows, S) bool sets those labels to -1 (ignored);
    ``jit`` runs the reference under ``jax.jit``."""
    inputs, refs = {}, {}
    for arch, groups, *accum in cases:
        accum = accum[0] if accum else 1
        jcfg = _config(arch, groups)
        params = JT.init_params(jcfg, jax.random.PRNGKey(0))
        batch = _batch(jcfg, rows)
        assert (batch["labels"] >= 0).all()
        if mask is not None:
            batch["labels"] = np.where(mask, -1, batch["labels"]).astype(np.int32)
        inputs[key_of(arch, groups, accum)] = (arch, groups, accum, jax.tree.map(np.asarray, params), batch)
        refs[key_of(arch, groups, accum)] = (jcfg, params, batch, accum, jit)
    import threading

    box = {}
    th = threading.Thread(target=lambda: box.update(
        out=run_ranks(BODY, {"cases": inputs, "opt": OPT, "chunk": CHUNK, "mesh": mesh}, tmp_path,
                      n=mesh[0] * mesh[1])))
    th.start()
    done = {k: _reference(*v) for k, v in refs.items()}
    th.join()
    return {k: (done[k], box["out"][k]) for k in done}


def check(ref, got):
    loss, grads, new_p, new_opt, met = ref
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], float(met["grad_norm"]), rtol=TOL)
    np.testing.assert_allclose(got["lr"], float(met["lr"]), rtol=1e-6)
    lr = float(met["lr"])
    _close(got["params"], new_p, band_of=grads, slack=2 * lr, lr=lr)
    _close(got["m"], new_opt["m"])
    _close(got["v"], new_opt["v"])
    # the state really is sharded: some leaf is split on each mesh dim
    assert any("Shard" in p for p in got["placed"]), got["placed"]
