"""The port's one-card dry run (``repro_torch.launch.dryrun``) and its
whole-step counts, held on the CPU to the JAX package.

For every architecture's ``reduced`` config the train, prefill and decode
steps are counted by the dry run's own builder on fake CPU tensors, and
the FLOPs are held within 5% of ``analyze_hlo`` of the JAX step jitted on
ONE CPU device (no mesh: the seed's sharded dry run fails on this host's
jax with a ShardingTypeError).  The JAX steps are compiled once, together.
Then the dry run's record: its keys, the automatic ``grad_accum``, the
reference's SKIP, the per-device state bytes of the production meshes
against ``NamedSharding``, the GridLocal cell, and where the records land.
"""

import functools
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding

import repro.configs as jconfigs
import repro.configs.shapes as jshapes
import repro.sharding as jsharding
from repro.compat import abstract_mesh
from repro.models import transformer as JT
from repro.models.config import reduced as jreduced
from repro.roofline.hlo_costs import analyze_hlo
from repro.train import steps as JS
from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, Shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import breakdown
from repro_torch.roofline.op_costs import CostCounter
from repro_torch.sharding import BASELINE
from repro_torch.train import steps as PS

B, S = 2, 32
FLOPS_RTOL = 0.05
KINDS = ("train", "prefill", "decode")
RECORD_KEYS = {"arch", "shape", "kind", "global_batch", "seq_len", "mesh", "chips", "device", "card", "rules",
               "gridlocal", "status", "n_params", "n_active_params", "tokens_per_step", "model_flops", "flops",
               "traffic_bytes", "model_vs_counted_flops", "n_ops", "collectives", "memory", "mesh_state_bytes",
               "roofline", "grad_accum", "timing", "hbm_budget_bytes", "fits"}


def _struct(tree):
    return jsharding.specs_to_structs(tree)


@functools.cache
def jax_step_flops() -> dict:
    """``analyze_hlo`` FLOPs of the JAX package's train, prefill and decode
    steps of every reduced arch, ``{(arch, kind): flops}``, each jitted on
    one CPU device: lowered in turn, then compiled on a pool of threads
    (XLA compiles outside the GIL)."""
    lowered = {}
    for arch in jconfigs.ARCHS:
        cfg = jreduced(jconfigs.get(arch))
        params, cache = _struct(JT.param_specs(cfg)), _struct(JT.cache_specs(cfg, B, S))
        lowered[arch, "train"] = jax.jit(JS.make_train_step(cfg)).lower(
            _struct(JS.train_state_specs(cfg)), _jax_inputs(arch, "train"))
        lowered[arch, "prefill"] = jax.jit(JS.make_prefill_step(cfg)).lower(params, _jax_inputs(arch, "prefill"), cache)
        lowered[arch, "decode"] = jax.jit(JS.make_decode_step(cfg)).lower(params, _jax_inputs(arch, "decode"), cache)
    with ThreadPoolExecutor(min(4, os.cpu_count() or 1)) as pool:
        texts = pool.map(lambda lo: lo.compile().as_text(), lowered.values())
        return {key: analyze_hlo(t).flops for key, t in zip(lowered, texts)}


def _jax_inputs(arch: str, kind: str) -> dict:
    """The step's inputs at (B, S): the port's ``input_specs`` of the cut
    cell, whose keys, axes and dtypes equal the reference's
    (``tests/test_torch_sharding.py``)."""
    ours = dryrun.input_specs(configs.reduced(configs.get(arch)), Shape("t", S, B, kind))
    return {k: jax.ShapeDtypeStruct(v.shape, jnp.dtype(v.dtype)) for k, v in ours.items()}


def port_step_flops(arch: str, kind: str) -> float:
    cfg = configs.reduced(configs.get(arch))
    costs, _, _ = dryrun.count_cell(cfg, Shape("t", S, B, kind), False, 1, "cpu")
    return costs.flops


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_whole_step_flops_match_analyze_hlo(arch, kind):
    want = jax_step_flops()[arch, kind]
    got = port_step_flops(arch, kind)
    assert got == pytest.approx(want, rel=FLOPS_RTOL), (arch, kind, got / want)


# ---------------------------------------------------------------------------
# the dry run's record
# ---------------------------------------------------------------------------


@pytest.fixture
def reduced_archs(monkeypatch, tmp_path):
    """Every arch at its reduced config, the records under a temporary
    ``experiments/dryrun_torch``."""
    real = configs.get
    monkeypatch.setattr(dryrun.configs, "get", lambda name: configs.reduced(real(name)))
    out = tmp_path / "experiments" / "dryrun_torch"
    monkeypatch.setattr(dryrun, "OUT_DIR", out)
    return out


def test_records_land_in_dryrun_torch():
    assert dryrun.OUT_DIR.parts[-2:] == ("experiments", "dryrun_torch")
    assert dryrun.OUT_DIR.parent.parent == dryrun.Path(dryrun.__file__).resolve().parents[3]


def test_reduced_record_has_every_key(reduced_archs):
    sh = Shape("train_4k", 64, 4, "train")
    rec = dryrun.run_cell("stablelm-1.6b", sh, grad_accum=1, device="cpu")
    assert set(rec) == RECORD_KEYS
    assert rec["status"] == "OK" and rec["kind"] == "train" and rec["device"] == "cpu" and rec["card"] is None
    cfg = configs.reduced(configs.get("stablelm-1.6b"))
    assert rec["n_params"] == rec["n_active_params"] == PS.T.param_count(cfg)
    assert rec["tokens_per_step"] == 4 * 64 and rec["model_flops"] == 6 * rec["n_active_params"] * 4 * 64
    assert rec["model_vs_counted_flops"] == pytest.approx(rec["model_flops"] / rec["flops"])
    assert 0 < rec["memory"]["state_bytes"] < rec["memory"]["peak_est_bytes"]
    assert set(rec["roofline"]) == {"t_compute_s", "t_memory_s", "t_collective_s", "dominant", "bound_s",
                                    "roofline_fraction"}
    assert rec["roofline"]["t_collective_s"] == 0 and rec["collectives"]["total_bytes"] == 0
    assert set(rec["mesh_state_bytes"]) == {"16x16", "2x16x16"} and rec["fits"] and rec["grad_accum"] == 1
    assert rec["timing"]["trace_s"] > 0
    path = reduced_archs / "stablelm-1.6b__train_4k__b4.json"  # the published shape's batch, cut
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    assert [p.name for p in reduced_archs.parent.iterdir()] == ["dryrun_torch"]  # nothing in experiments/dryrun


def test_the_fake_count_equals_a_real_steps(reduced_archs):
    cfg = configs.reduced(configs.get("stablelm-1.6b"))
    sh = Shape("t", 64, 4, "train")
    fake, state_bytes, _ = dryrun.count_cell(cfg, sh, False, 1, "cpu")
    state = PS.materialize_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros(4, 64, dtype=torch.int64), "labels": torch.zeros(4, 64, dtype=torch.int64)}
    counter = CostCounter()
    counter.track(state, batch)
    counter.reset_peak()
    assert counter.live_bytes == state_bytes
    with counter:
        PS.make_train_step(cfg)(state, batch)
    real = counter.costs
    assert (fake.flops, fake.traffic_bytes, fake.peak_bytes, fake.n_ops) == \
        (real.flops, real.traffic_bytes, real.peak_bytes, real.n_ops)


def test_auto_grad_accum_doubles_to_eight_then_records_no_fit(reduced_archs, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "HBM_BUDGET", 1)
    rec = dryrun.run_cell("stablelm-1.6b", Shape("train_4k", 32, 8, "train"), device="cpu")
    assert rec["grad_accum"] == 8 and rec["fits"] is False and rec["hbm_budget_bytes"] == 1
    assert capsys.readouterr().out.count("retrying with grad_accum=") == 3


def test_auto_grad_accum_stops_where_the_step_fits(reduced_archs, monkeypatch):
    sh = Shape("train_4k", 32, 8, "train")
    peaks = [dryrun._run_cell_once("stablelm-1.6b", sh, False, ga, "cpu",
                                   cfg=configs.reduced(configs.get("stablelm-1.6b")))["memory"]["peak_est_bytes"]
             for ga in (1, 2)]
    assert peaks[1] < peaks[0]
    monkeypatch.setattr(dryrun, "HBM_BUDGET", (peaks[0] + peaks[1]) // 2)
    rec = dryrun.run_cell("stablelm-1.6b", sh, device="cpu")
    assert rec["grad_accum"] == 2 and rec["fits"] is True
    assert rec["memory"]["peak_est_bytes"] == peaks[1]
    serve = dryrun.run_cell("stablelm-1.6b", Shape("prefill_32k", 32, 8, "prefill"), device="cpu")
    assert serve["grad_accum"] == 1  # only a train step doubles


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_skipped_cells_carry_the_references_reason(arch, reduced_archs):
    rec = dryrun.run_cell(arch, "long_500k", device="cpu", save=False)
    jcfg = jconfigs.get(arch)
    if jshapes.cell_is_supported(jcfg, "long_500k"):
        assert rec["status"] == "OK" and rec["kind"] == "decode" and rec["tokens_per_step"] == 1
    else:
        assert rec["status"] == "SKIP" and rec["reason"] == jshapes.skip_reason(jcfg, "long_500k")
        assert "full-attention" in rec["reason"]


@pytest.mark.parametrize("shape,gridlocal", [(s, False) for s in SHAPES] + [("train_4k", True)])
def test_mesh_state_bytes_equal_named_shardings(shape, gridlocal):
    """Full published widths: the dry run's per-device bytes of the step's
    arguments equal the sum of ``NamedSharding.shard_shape`` over the JAX
    package's specs, on both production meshes (GridLocal's on 2x16x16)."""
    sh = SHAPES[shape]
    for arch in ("stablelm-1.6b", "deepseek-moe-16b", "seamless-m4t-large-v2"):
        jcfg, cfg = jconfigs.get(arch), configs.get(arch)
        if not jshapes.cell_is_supported(jcfg, shape):
            continue
        for multi_pod in (False, True) if not gridlocal else (True,):
            jmesh = abstract_mesh((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
                abstract_mesh((16, 16), ("data", "model"))
            inputs = jshapes.input_specs(jcfg, shape)
            if sh.kind == "train":
                trees = [(JS.train_state_specs(jcfg, n_pods=2 if gridlocal else 0),
                          jsharding.GRIDLOCAL if gridlocal else jsharding.BASELINE)]
            else:
                params = jax.tree.map(
                    lambda s: jsharding.ShapeAxes(s.shape, jcfg.dtype if s.dtype.startswith(("float", "bf")) else
                                                  s.dtype, s.axes), JT.param_specs(jcfg),
                    is_leaf=jsharding.is_shape_axes)
                trees = [(params, jsharding.BASELINE),
                         (JT.cache_specs(jcfg, sh.global_batch, sh.seq_len), jsharding.BASELINE)]
            trees.append((inputs, jsharding.GRIDLOCAL if gridlocal else jsharding.BASELINE))
            want = 0
            for tree, rules in trees:
                for leaf in jax.tree.leaves(tree, is_leaf=jsharding.is_shape_axes):
                    ps = jsharding.logical_to_pspec(leaf.axes, leaf.shape, rules, jmesh)
                    n = 1
                    for d in NamedSharding(jmesh, ps).shard_shape(leaf.shape):
                        n *= d
                    want += n * jnp.dtype(leaf.dtype).itemsize
            rules = dryrun.get_rules(gridlocal)
            got = dryrun.mesh_state_bytes(cfg, sh, gridlocal, rules, make_production_mesh(multi_pod=multi_pod))
            assert got == want, (arch, shape, multi_pod)


def test_gridlocal_cell_counts_a_merging_step(reduced_archs, monkeypatch):
    merges = []
    real = PS.gridlocal_merge
    monkeypatch.setattr(PS, "gridlocal_merge", lambda *a: (merges.append(1), real(*a))[1])
    sh = Shape("train_4k", 32, 4, "train")
    rec = dryrun.run_cell("stablelm-1.6b", sh, gridlocal=True, grad_accum=1, device="cpu")
    assert merges == [1] and rec["rules"] == "gridlocal" and set(rec["mesh_state_bytes"]) == {"2x16x16"}
    cfg = configs.reduced(configs.get("stablelm-1.6b"))
    n = PS.T.param_count(cfg)
    leaves = len(list(dryrun.spec_leaves(PS.T.param_specs(cfg))))
    assert rec["gridlocal_merge_bytes"]["float32"] == 2 * 4 * n
    assert rec["gridlocal_merge_bytes"]["int8"] == 2 * (n + 4 * leaves)
    one = dryrun.run_cell("stablelm-1.6b", Shape("train_4k", 32, 2, "train"), grad_accum=1, device="cpu")
    assert rec["flops"] > 2 * one["flops"]  # two pods' steps and the merge
    assert (reduced_archs / "stablelm-1.6b__train_4k__b4__gridlocal.json").exists()


def test_kernel_flags_are_refused(reduced_archs):
    cfg = configs.reduced(configs.get("gemma2-2b"))
    for flag in ("flash_kernel", "slstm_kernel"):
        with pytest.raises(ValueError, match=flag):
            dryrun.count_cell(cfg.scaled(**{flag: True}), Shape("t", 32, 2, "prefill"), False, 1, "cpu")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("cuda", None):
        with pytest.raises(RuntimeError):
            dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k"] +
                        (["--device", device] if device else []))


def test_cli_writes_a_cut_cell(reduced_archs, capsys):
    dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--global-batch", "2", "--device", "cpu"])
    rec = json.loads((reduced_archs / "stablelm-1.6b__decode_32k__b2.json").read_text())
    assert rec["global_batch"] == 2 and rec["seq_len"] == 32_768 and rec["tokens_per_step"] == 2
    assert "dom=" in capsys.readouterr().out


def test_breakdown_cli(reduced_archs, capsys):
    breakdown.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--global-batch", "2", "--device", "cpu",
                    "--top", "5"])
    out = capsys.readouterr().out
    rows = out.split("== top traffic ops")[1].split("== top collectives")[0].strip().splitlines()[1:]
    assert len(rows) == 5 and all("models/" in r or "train/" in r for r in rows), out
