"""The port's sharding rules (``repro_torch.sharding``), cell shapes
(``repro_torch.configs.shapes``), rule variants and production meshes,
held to the JAX package's on the CPU.

Every case of ``tests/test_sharding.py`` is ported; then every leaf of
every architecture (parameters, the train state with 0 and 2 pods, the
cache at each serving shape, the inputs at each shape) is swept over the
four production meshes (16x16, 2x16x16 and both moe2d meshes) under the
eight rules tables: the port's pspec must equal ``repro.sharding``'s on an
``AbstractMesh`` entry for entry, and ``shard_shape`` must equal
``NamedSharding(...).shard_shape``.  Last, ``to_placements`` and
``data.pipeline.place_batch`` on a 2 x 2 gloo ``DeviceMesh`` of 4
processes: every rank's local shard is the numpy slice the pspec names,
and the cost counter counts the group's collectives.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import repro.configs as jconfigs
import repro.configs.shapes as jshapes
import repro.sharding as jsharding
from repro.compat import abstract_mesh
from repro.launch import mesh as jmesh
from repro.models import transformer as JT
from repro.roofline import rule_variants as jvariants
from repro.train import steps as JS
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as T
from repro_torch.models.layers import ShapeAxes, spec_leaves
from repro_torch.roofline import rule_variants
from repro_torch.sharding import (
    BASELINE,
    GRIDLOCAL,
    MeshShape,
    Rules,
    logical_to_pspec,
    mesh_axis_size,
    shard_shape,
    specs_to_placements,
    specs_to_pspecs,
    specs_to_structs,
    struct,
    to_placements,
    tree_pspecs,
)
from repro_torch.train import steps as PS

SRC = str(Path(__file__).resolve().parent.parent / "src")
MESH1 = MeshShape(("data", "model"), (16, 16))
MESH2 = MeshShape(("pod", "data", "model"), (2, 16, 16))
MESHES = {
    "16x16": (MESH1, abstract_mesh((16, 16), ("data", "model"))),
    "2x16x16": (MESH2, abstract_mesh((2, 16, 16), ("pod", "data", "model"))),
    "moe2d": (tmesh.make_variant_mesh("moe2d"), abstract_mesh((16, 8, 2), ("data", "expert", "model"))),
    "moe2d_2pod": (tmesh.make_variant_mesh("moe2d", multi_pod=True),
                   abstract_mesh((2, 16, 8, 2), ("pod", "data", "expert", "model"))),
}
VARIANTS = ("no_fsdp", "seqpar", "cache_model", "ep_cap_model", "vocab_replicated", "moe_2d")
RULES = {"baseline": (BASELINE, jsharding.BASELINE), "gridlocal": (GRIDLOCAL, jsharding.GRIDLOCAL),
         **{v: (rule_variants.get(v), jvariants.get(v)) for v in VARIANTS}}
CHILD_TIMEOUT_S = 120


def _jax_entries(pspec: P) -> tuple:
    """A JAX pspec as the port writes one: a one-axis tuple as its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in pspec)


# ---------------------------------------------------------------------------
# tests/test_sharding.py, ported
# ---------------------------------------------------------------------------


class TestLogicalToPspec:
    def test_basic_tp(self):
        assert logical_to_pspec(("embed", "mlp"), (4096, 16384), BASELINE, MESH1) == ("data", "model")

    def test_batch_uses_pod_and_data(self):
        assert logical_to_pspec(("batch", "seq"), (256, 4096), BASELINE, MESH2) == (("pod", "data"),)

    def test_batch_single_pod_mesh_drops_pod(self):
        assert logical_to_pspec(("batch", "seq"), (256, 4096), BASELINE, MESH1) == ("data",)

    def test_indivisible_dim_falls_back_to_replicated(self):
        # 8 experts cannot shard over model=16
        sp = logical_to_pspec(("experts", "embed", "expert_mlp"), (8, 6144, 16384), BASELINE, MESH1)
        assert sp == (None, "data", "model")
        # 64 experts CAN
        sp2 = logical_to_pspec(("experts", "embed", "expert_mlp"), (64, 2048, 1408), BASELINE, MESH1)
        assert sp2[0] == "model"

    def test_axis_never_reused_across_dims(self):
        # batch takes data; kv_seq would also want data -> dropped
        sp = logical_to_pspec(("batch", "kv_seq", "kv_heads", None), (128, 32768, 4, 256), BASELINE, MESH1)
        assert sp == ("data",)  # trailing Nones trimmed; no double 'data'

    def test_batch1_long_context_gives_data_to_cache(self):
        sp = logical_to_pspec(("batch", "kv_seq", "kv_heads", None), (1, 524288, 4, 256), BASELINE, MESH1)
        assert sp[0] is None
        assert sp[1] == "data"

    def test_partial_divisibility_prefix(self):
        # dim 32 with rule (pod, data) = 2*16: full product divides
        assert logical_to_pspec(("batch",), (32,), BASELINE, MESH2) == (("pod", "data"),)
        # dim 2 only allows pod
        assert logical_to_pspec(("batch",), (2,), BASELINE, MESH2) == ("pod",)


class TestShapeAxes:
    def test_struct_with_and_without_mesh(self):
        sa = ShapeAxes(shape=(64, 128), dtype="float32", axes=("embed", "mlp"))
        s0 = struct(sa)
        assert tuple(s0.shape) == (64, 128) and s0.device.type == "meta"
        assert specs_to_pspecs({"w": sa}, BASELINE, MESH1) == {"w": ("data", "model")}

    def test_default_axes_fill(self):
        assert ShapeAxes(shape=(3, 4, 5), dtype="int32").axes == (None, None, None)

    def test_axes_length_checked(self):
        with pytest.raises(ValueError):
            ShapeAxes(shape=(3, 4), dtype="f4", axes=("a",))


class TestGridlocalRules:
    def test_grid_axis_maps_to_pod(self):
        assert logical_to_pspec(("grid", "vocab", "embed"), (2, 32000, 4096), GRIDLOCAL, MESH2)[0] == "pod"

    def test_gridlocal_batch_excludes_pod(self):
        assert logical_to_pspec(("batch", "seq"), (256, 4096), GRIDLOCAL, MESH2) == ("data",)


def test_axes_and_shape_lengths_checked():
    with pytest.raises(ValueError):
        logical_to_pspec(("batch",), (2, 3), BASELINE, MESH1)


def test_tree_pspecs_maps_parallel_trees():
    axes = {"a": ("embed", "mlp"), "b": [("batch", "seq")]}
    shp = {"a": (64, 32), "b": [(32, 8)]}
    assert tree_pspecs(axes, shp, BASELINE, MESH2) == {"a": ("data", "model"), "b": [(("pod", "data"),)]}


def test_to_placements_on_a_mesh_description():
    from types import SimpleNamespace

    from torch.distributed.tensor import Replicate, Shard

    dm = SimpleNamespace(mesh_dim_names=("pod", "data", "model"), mesh=torch.zeros(2, 16, 16))
    assert to_placements((("pod", "data"), None, "model"), dm) == (Shard(0), Shard(0), Shard(2))
    assert to_placements((), dm) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        to_placements((("data", "pod"),), dm)  # against the mesh's order: not the reference's shards
    with pytest.raises(ValueError):
        to_placements(("expert",), dm)
    tree = {"w": ShapeAxes((64, 32), "float32", ("embed", "mlp")), "b": [ShapeAxes((256, 8), "int32", ("batch", None))]}
    assert specs_to_placements(tree, BASELINE, dm) == {"w": (Replicate(), Shard(0), Shard(1)),
                                                       "b": [(Shard(0), Shard(0), Replicate())]}
    structs = specs_to_structs(tree)
    assert structs["w"].device.type == "meta" and structs["b"][0].dtype == torch.int32


def test_shard_shape_refuses_an_uneven_split():
    with pytest.raises(ValueError):
        shard_shape((30,), ("data",), MESH1)


# ---------------------------------------------------------------------------
# the meshes, the rule tables, the shapes
# ---------------------------------------------------------------------------


def test_production_meshes_have_the_references_axes():
    assert tmesh.make_production_mesh() == MESH1 and tmesh.make_production_mesh(multi_pod=True) == MESH2
    assert (MESH1.tag, MESH2.tag) == ("16x16", "2x16x16")
    for mp in (False, True):
        v = tmesh.make_variant_mesh("moe2d", multi_pod=mp)
        assert dict(v.shape) == dict(MESHES["moe2d_2pod" if mp else "moe2d"][1].shape)
    assert tmesh.make_test_mesh(2, 2, 2) == MeshShape(("pod", "data", "model"), (2, 2, 2))
    with pytest.raises(KeyError):
        tmesh.make_variant_mesh("nope")
    assert mesh_axis_size(MESH2, ("pod", "data", "absent")) == 32


def test_rule_tables_equal_the_references():
    for name, (ours, theirs) in RULES.items():
        assert dict(ours.table) == dict(theirs.table), name
        assert ours.name == theirs.name
    with pytest.raises(KeyError):
        rule_variants.get("nope")
    assert isinstance(rule_variants.register("x_test", dict(BASELINE.table)), Rules)


def test_hw_is_the_h100_data_sheet():
    assert set(tmesh.HW) == set(jmesh.HW)
    assert tmesh.HW == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9, "chips_per_pod": 8,
                        "dcn_bw": 50e9}


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_cells_and_input_specs_equal_the_references(arch):
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    for name in jshapes.SHAPES:
        assert shapes.SHAPES[name].__dict__ == jshapes.SHAPES[name].__dict__
        assert shapes.cell_is_supported(cfg, name) == jshapes.cell_is_supported(jcfg, name)
        assert shapes.skip_reason(cfg, name) == jshapes.skip_reason(jcfg, name)
        ours, theirs = shapes.input_specs(cfg, name), jshapes.input_specs(jcfg, name)
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            assert (ours[k].shape, ours[k].dtype, ours[k].axes) == (theirs[k].shape, theirs[k].dtype, theirs[k].axes)


# ---------------------------------------------------------------------------
# the sweep: every leaf of every arch, four meshes, eight tables
# ---------------------------------------------------------------------------


def _jax_leaves(tree) -> list:
    out = []

    def walk(t, path):
        if isinstance(t, jsharding.ShapeAxes):
            out.append((path, t))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}.{k}" if path else str(k))
        else:
            for i, v in enumerate(t):
                walk(v, f"{path}.{i}" if path else str(i))

    walk(tree, "")
    return out


def _trees(arch):
    """(port tree, JAX tree) pairs: every leaf set the dry run places."""
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    pairs = [(T.param_specs(cfg), JT.param_specs(jcfg))]
    for n_pods in (0, 2):
        pairs.append((PS.train_state_specs(cfg, n_pods), JS.train_state_specs(jcfg, n_pods)))
    for name, sh in jshapes.SHAPES.items():
        if not jshapes.cell_is_supported(jcfg, name):
            continue
        pairs.append((shapes.input_specs(cfg, name), jshapes.input_specs(jcfg, name)))
        if sh.kind != "train":
            pairs.append((T.cache_specs(cfg, sh.global_batch, sh.seq_len),
                          JT.cache_specs(jcfg, sh.global_batch, sh.seq_len)))
    return pairs


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_leaf_places_as_the_reference(arch, mesh_name):
    ours_mesh, jax_mesh = MESHES[mesh_name]
    n = 0
    for ours, theirs in _trees(arch):
        a, b = list(spec_leaves(ours)), _jax_leaves(theirs)
        assert [(p, s.shape, s.dtype, s.axes) for p, s in a] == [(p, s.shape, s.dtype, s.axes) for p, s in b]
        for _, leaf in a:
            for rname, (rules, jrules) in RULES.items():
                got = logical_to_pspec(leaf.axes, leaf.shape, rules, ours_mesh)
                want = jsharding.logical_to_pspec(leaf.axes, leaf.shape, jrules, jax_mesh)
                assert got == _jax_entries(want), (arch, mesh_name, rname, leaf)
                assert shard_shape(leaf.shape, got, ours_mesh) == \
                    tuple(NamedSharding(jax_mesh, want).shard_shape(leaf.shape)), (arch, mesh_name, rname, leaf)
                n += 1
    assert n > 100


# ---------------------------------------------------------------------------
# placements on a 2 x 2 gloo DeviceMesh, 4 processes
# ---------------------------------------------------------------------------

PLACEMENT_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.data.pipeline import place_batch
    from repro_torch.roofline.op_costs import CostCounter
    from repro_torch.sharding import BASELINE, MeshShape, Rules, logical_to_pspec, to_placements

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=4, rank=rank)
    dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    mesh = MeshShape(("data", "model"), (2, 2))
    d, m = dm.get_coordinate()
    out = {"rank": rank, "coord": [d, m], "checks": []}

    def slices(shape, pspec):
        # the numpy slice one device holds: dim i split by the axes its entry names, major first
        idx = []
        for i, n in enumerate(shape):
            entry = pspec[i] if i < len(pspec) else None
            axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
            k, size = 0, 1
            for a in axes:
                c, s = {"data": (d, 2), "model": (m, 2)}[a]
                k, size = k * s + c, size * s
            idx.append(slice(k * n // size, (k + 1) * n // size))
        return tuple(idx)

    def check(name, full, local, pspec):
        want = full[slices(full.shape, pspec)]
        out["checks"].append([name, list(pspec), bool(np.array_equal(local, want))])

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 100, (8, 6)).astype(np.int64), "frontend": rng.normal(size=(8, 4, 6))}
    placed = place_batch(batch, dm, BASELINE, axes=("batch", "seq"))
    for k, v in batch.items():
        ax = ("batch", "seq", None)[: v.ndim]
        check("place_batch." + k, v, placed[k].to_local().numpy(), logical_to_pspec(ax, v.shape, BASELINE, mesh))
        out["checks"].append(["placements." + k, [str(p) for p in placed[k].placements],
                              placed[k].placements == (Shard(0), Replicate())])

    from torch.distributed.tensor import distribute_tensor
    w = rng.normal(size=(8, 12))
    for name, rules, axes in (("embed_mlp", BASELINE, ("embed", "mlp")),
                              ("two_axes", Rules({"batch": ("data", "model")}), ("batch", None)),
                              ("replicated", BASELINE, (None, None))):
        pspec = logical_to_pspec(axes, w.shape, rules, mesh)
        dt = distribute_tensor(torch.from_numpy(w), dm, to_placements(pspec, dm))
        check(name, w, dt.to_local().numpy(), pspec)

    pods = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    counter = CostCounter(chips_per_pod=2)
    with counter:
        t = torch.ones(1000)
        dist.all_reduce(t)
        parts = [torch.empty(250) for _ in range(2)]
        dist.all_gather(parts, torch.ones(250), group=pods[rank // 2])
    c = counter.costs
    out["collectives"] = {"bytes": c.coll_bytes_by_type, "count": c.coll_count_by_type,
                          "cross_pod": c.coll_bytes_cross_pod, "total": c.coll_bytes_total,
                          "reduced": float(t[0])}
    dist.barrier()
    dist.destroy_process_group()
    print("PLACEMENT " + json.dumps(out), flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_placements_on_a_gloo_device_mesh(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(PLACEMENT_CHILD)
    env = {**os.environ, "PYTHONPATH": SRC}
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in range(4)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=CHILD_TIMEOUT_S)
            assert p.returncode == 0, e[-3000:]
            outs.append(json.loads(next(ln for ln in o.splitlines() if ln.startswith("PLACEMENT "))[10:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert sorted(tuple(o["coord"]) for o in outs) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for o in outs:
        by_name = {c[0]: c for c in o["checks"]}
        assert all(c[2] for c in o["checks"]), o["checks"]
        assert by_name["place_batch.tokens"][1] == ["data"]
        assert by_name["embed_mlp"][1] == ["data", "model"]
        assert by_name["two_axes"][1] == [["data", "model"]]
        assert by_name["replicated"][1] == []
        col = o["collectives"]
        assert col["count"] == {"all-reduce": 1, "all-gather": 1} and col["reduced"] == 4.0
        assert col["bytes"] == {"all-reduce": 4000.0, "all-gather": 2000.0}
        assert col["total"] == 6000.0 and col["cross_pod"] == 4000.0  # the pods' gathers stay in a pod
