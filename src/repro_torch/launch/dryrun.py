"""The dry run: count every (architecture x input shape) cell's step on
fake tensors and persist its costs, memory and roofline, for one card or
for one device of a production mesh.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell's step for a 256- or 512-chip mesh and reads per-device costs
from the post-SPMD HLO.  Here the port's own step runs under
``FakeTensorMode`` (no device memory is touched, so a cell far larger
than the card is counted all the same) with ``roofline.op_costs``
counting every op it dispatches:

  * train: ``make_train_step`` over ``materialize_state``;
  * ``--gridlocal``: ``make_gridlocal_train_step`` over ``gridlocal_init``
    with phase 29's outer config, the global step that ends in a merge
    (the reference's HLO holds the merge in a conditional whose branches
    are both counted);
  * prefill / decode: ``make_prefill_step`` / ``make_decode_step`` with the
    parameters in ``cfg.dtype`` and a cache of ``cache_specs``' size.

With no ``--mesh`` the whole step runs on ONE card at the cell's global
batch, and ``mesh_state_bytes`` gives the bytes one device of ``16x16``
and ``2x16x16`` would hold of the step's arguments.  With ``--mesh
16x16`` (256 chips, data x model), ``2x16x16`` (512, pod x data x model)
or ``moe2d`` the step runs sharded on DTensors (``build_sharded_step``:
the state, cache and batch placed by the rules, as the reference's
``in_shardings``; GridLocal's pods on the pod axis) on a fake process
group of the mesh's size in this one process, as its rank 0 runs it, and
the counter counts that rank's local ops and the collectives its
redistributions issue: the reference's record keys
``hlo_flops_per_device``, ``hlo_bytes_per_device``, ``collectives`` (by
type; "cross-pod" bytes are those of collectives whose ranks span more
than one 8-card NVLink node, ``HW["chips_per_pod"]``),
``memory.peak_est_bytes`` (one device's live local storage) and
``roofline`` (per device).  A train cell doubles ``grad_accum`` until a
device's peak fits the card's memory (``hbm_budget``: 80 GiB without a
card), as the reference does against its own budget.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k --mesh 16x16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k --mesh 2x16x16 --gridlocal --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu   # every one-card cell, a process each

Outputs land in experiments/dryrun_torch/<arch>__<shape>[__b<batch>][__<mesh>][__gridlocal].json
(never experiments/dryrun/, which is the reference's sweep).  Counts taken
on the CPU are counts: the roofline's seconds are data-sheet bounds, not
times.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

import repro_torch.configs as configs
from repro_torch.configs.shapes import SHAPES, Shape, cell_is_supported, input_specs, skip_reason
from repro_torch.core.gridlocal import merge_bytes
from repro_torch.data.pipeline import place_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import HW, init_fake_group, make_device_mesh, make_production_mesh, make_variant_mesh
from repro_torch.models import transformer as T
from repro_torch.models.layers import ShapeAxes, spec_leaves, torch_dtype
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.outer import OuterConfig
from repro_torch.roofline.analyze import roofline_terms
from repro_torch.roofline.op_costs import CostCounter
from repro_torch.sharding import BASELINE, GRIDLOCAL, MeshShape, Rules, activate, logical_to_pspec, shard_shape
from repro_torch.train import steps as steps_mod

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# The card's memory where no card is asked for: an H100 80GB's 80 GiB.  On
# a card the budget is what it reports (torch.cuda.mem_get_info).
HBM_BUDGET = 80 * 2**30
GL_PODS = 2
GL_OUTER = OuterConfig(h_steps=2, outer_lr=0.7, outer_momentum=0.9, compress="int8")  # phase 29's


class _FakeMode(FakeTensorMode):
    """A fake mode that ``copy.deepcopy`` keeps: a fake tensor's dict holds
    its mode, and ``gridlocal_init`` deep-copies a model into the pods."""

    def __deepcopy__(self, memo):
        return self


def hbm_budget(device: torch.device) -> float:
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return float(HBM_BUDGET)


def get_rules(gridlocal: bool) -> Rules:
    """The cell's rules: ``GRIDLOCAL`` for a GridLocal cell (the batch
    shards over the grid axis, never over ``pod``), else ``BASELINE``."""
    return GRIDLOCAL if gridlocal else BASELINE


def _resolve(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available; pass --device cpu to count on the CPU")
    return dev


def _as_dtype(tree, dtype: str):
    return steps_mod._map_specs(
        lambda s: ShapeAxes(shape=s.shape, dtype=dtype if s.dtype.startswith(("float", "bf")) else s.dtype,
                            axes=s.axes), tree)


def _inputs(specs: dict, device) -> dict:
    """Empty tensors of the input specs; token ids as int64, as the port's
    steps take them."""
    out = {}
    for k, s in specs.items():
        dt = torch_dtype(s.dtype)
        out[k] = torch.zeros(s.shape, dtype=torch.int64 if not dt.is_floating_point else dt, device=device)
    return out


def build_step(cfg, sh: Shape, gridlocal: bool, grad_accum: int, device: torch.device,
               opt_cfg: AdamWConfig | None = None):
    """Inside an active fake mode: the cell's state and inputs, and
    ``run()``, one step over them.  Returns ``(run, live)``, ``live`` the
    tensors the step is handed (counted as state)."""
    for flag in ("flash_kernel", "slstm_kernel"):
        if getattr(cfg, flag):
            raise ValueError(f"{cfg.name}: {flag}=True runs a CUDA kernel wrapper, which is not an aten op "
                             f"and which the dry run cannot count; count it with {flag}=False")
    gen = torch.Generator(device=device).manual_seed(0)
    batch = _inputs(input_specs(cfg, sh), device)
    opt_cfg = opt_cfg or AdamWConfig()
    if sh.kind == "train" and gridlocal:
        state = steps_mod.gridlocal_init(cfg, gen, GL_PODS, device)
        for o in state["opt"]:
            # a constant step: the pods' check of it reads a value, and the
            # counted step is the one that ends in a merge
            o["step"] = torch.tensor(GL_OUTER.h_steps - 1, dtype=torch.int32, device=device)
        fn = steps_mod.make_gridlocal_train_step(cfg, GL_PODS, opt_cfg, GL_OUTER, grad_accum=grad_accum)
        return (lambda: fn(state, batch)), (state, batch)
    if sh.kind == "train":
        state = steps_mod.materialize_state(cfg, gen, device)
        fn = steps_mod.make_train_step(cfg, opt_cfg, grad_accum=grad_accum)
        return (lambda: fn(state, batch)), (state, batch)
    model = T.Model(cfg, device=device, generator=gen)
    with torch.no_grad():  # serving weights in cfg.dtype (Module.to cannot swap fake parameters)
        for p in model.parameters():
            p.data = p.data.to(torch_dtype(cfg.dtype))
    cache = T.init_cache(cfg, sh.global_batch, sh.seq_len, device)
    if sh.kind == "prefill":
        fn = steps_mod.make_prefill_step(cfg)
        return (lambda: fn(model, batch, cache)), (model, batch, cache)
    fn = steps_mod.make_decode_step(cfg)
    dec = {"token": batch["token"], "pos": sh.seq_len - 1}
    return (lambda: fn(model, dec, cache)), (model, batch["token"], cache)


def build_sharded_step(cfg, sh: Shape, gridlocal: bool, grad_accum: int, device: torch.device, device_mesh,
                       opt_cfg: AdamWConfig | None = None):
    """``build_step`` on a ``DeviceMesh``: the state, cache and inputs
    placed by the cell's rules (``steps.shard_state``, ``shard_model``,
    ``shard_cache``, ``place_batch``; GridLocal's state is this rank's
    pod's, ``shard_gridlocal_state``, and its step takes the whole batch),
    as the reference's ``in_shardings`` place them.  Returns ``(run,
    live)``; ``run`` enters ``sharding.activate`` itself."""

    for flag in ("flash_kernel", "slstm_kernel"):
        if getattr(cfg, flag):
            raise ValueError(f"{cfg.name}: {flag}=True runs a CUDA kernel wrapper, which is not an aten op "
                             f"and which the dry run cannot count; count it with {flag}=False")
    rules = get_rules(gridlocal)
    gen = torch.Generator(device=device).manual_seed(0)
    batch = _inputs(input_specs(cfg, sh), device)
    opt_cfg = opt_cfg or AdamWConfig()

    def activated(fn):
        def run():
            with activate(device_mesh, rules):
                return fn()
        return run

    if sh.kind == "train" and gridlocal:
        n_pods = device_mesh.size(device_mesh.mesh_dim_names.index("pod"))
        state = steps_mod.gridlocal_init(cfg, gen, n_pods, device)
        for o in state["opt"]:
            o["step"] = torch.tensor(GL_OUTER.h_steps - 1, dtype=torch.int32, device=device)
        state = steps_mod.shard_gridlocal_state(cfg, state, device_mesh)
        fn = steps_mod.make_gridlocal_train_step(cfg, n_pods, opt_cfg, GL_OUTER, grad_accum=grad_accum,
                                                 device_mesh=device_mesh)
        return activated(lambda: fn(state, batch)), (state, batch)
    if sh.kind == "train":
        state = steps_mod.shard_state(cfg, steps_mod.materialize_state(cfg, gen, device), device_mesh, rules)
        placed = place_batch(batch, device_mesh, rules)
        fn = steps_mod.make_train_step(cfg, opt_cfg, grad_accum=grad_accum)
        return activated(lambda: fn(state, placed)), (state, placed)
    model = T.Model(cfg, device=device, generator=gen)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.to(torch_dtype(cfg.dtype))
    steps_mod.shard_model(cfg, model, device_mesh, rules)
    cache = steps_mod.shard_cache(cfg, T.init_cache(cfg, sh.global_batch, sh.seq_len, device), device_mesh, rules)
    if sh.kind == "prefill":
        placed = place_batch(batch, device_mesh, rules)
        fn = steps_mod.make_prefill_step(cfg)
        return activated(lambda: fn(model, placed, cache)), (model, placed, cache)
    fn = steps_mod.make_decode_step(cfg)
    dec = place_batch({"token": batch["token"], "pos": sh.seq_len - 1}, device_mesh, rules)
    return activated(lambda: fn(model, dec, cache)), (model, dec["token"], cache)


def count_cell(cfg, sh: Shape, gridlocal: bool, grad_accum: int, device, opt_cfg=None,
               record_ops: bool = False, device_mesh=None):
    """Count one step of the cell on fake tensors: ``(OpCosts, state
    bytes, trace seconds)``."""
    dev = _resolve(device)
    t0 = time.time()
    with _FakeMode():
        if device_mesh is None:
            run, live = build_step(cfg, sh, gridlocal, grad_accum, dev, opt_cfg)
        else:
            run, live = build_sharded_step(cfg, sh, gridlocal, grad_accum, dev, device_mesh, opt_cfg)
        counter = CostCounter(record_ops=record_ops, chips_per_pod=HW["chips_per_pod"])
        counter.track(*live)
        counter.reset_peak()
        state_bytes = counter.live_bytes
        with counter:
            run()
        del run, live
    return counter.costs, state_bytes, time.time() - t0


def _state_specs(cfg, sh: Shape, gridlocal: bool) -> list:
    """ShapeAxes of every argument the step is handed, in the reference's
    layout: the train state (GridLocal's with 2 pods) or the serving
    parameters in cfg.dtype and the cache; then the inputs."""
    inputs = input_specs(cfg, sh)
    if sh.kind == "train":
        state = steps_mod.train_state_specs(cfg, n_pods=GL_PODS if gridlocal else 0)
        return [state, inputs]
    return [_as_dtype(T.param_specs(cfg), cfg.dtype), T.cache_specs(cfg, sh.global_batch, sh.seq_len), inputs]


def mesh_state_bytes(cfg, sh: Shape, gridlocal: bool, rules: Rules, mesh) -> int:
    """Bytes of the step's arguments that one device of ``mesh`` holds:
    every leaf's ``shard_shape`` under ``rules`` (GridLocal's state under
    ``GRIDLOCAL``), the same on every device."""
    total = 0
    for i, tree in enumerate(_state_specs(cfg, sh, gridlocal)):
        r = GRIDLOCAL if (gridlocal and i == 0) else rules
        for _, leaf in spec_leaves(tree):
            shp = shard_shape(leaf.shape, logical_to_pspec(leaf.axes, leaf.shape, r, mesh), mesh)
            total += math.prod(shp) * torch_dtype(leaf.dtype).itemsize
    return total


def cell_shape(shape_name, global_batch: int = 0) -> Shape:
    """The cell's ``Shape`` (a name of ``SHAPES``, or a ``Shape`` of one's
    own), its global batch cut to ``global_batch`` when that is > 0."""
    sh = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    return dataclasses.replace(sh, global_batch=global_batch) if global_batch else sh


def run_cell(
    arch: str,
    shape_name,
    gridlocal: bool = False,
    save: bool = True,
    grad_accum: int = 0,  # 0 = auto: double until the step fits the card (<=8)
    device=None,
    global_batch: int = 0,
    mesh: str = "",
) -> dict:
    """Count one cell and save its record.  ``mesh`` "" counts the whole
    step on one card; "16x16", "2x16x16", "moe2d" (or a test mesh such as
    "2x2x2") count one device's share of the step sharded on that mesh,
    on a fake process group of the mesh's size (``init_fake_group``, made
    for each count if the process has no group yet, and destroyed after it)."""
    cfg = configs.get(arch)
    sh = cell_shape(shape_name, global_batch)
    tag = mesh or "1"
    if not cell_is_supported(cfg, sh):
        rec = {
            "arch": arch, "shape": sh.name, "mesh": tag, "rules": get_rules(gridlocal).name, "gridlocal": gridlocal,
            "status": "SKIP", "reason": skip_reason(cfg, sh),
        }
        if save:
            _save(rec, arch, sh, gridlocal, mesh)
        return rec

    dev = _resolve(device)
    budget = hbm_budget(dev)
    auto = grad_accum == 0
    accum = max(grad_accum, 1)
    while True:
        rec = _run_cell_once(arch, sh, gridlocal, accum, dev, cfg=cfg, mesh=mesh)
        peak = rec["memory"]["peak_est_bytes"]
        if auto and rec["kind"] == "train" and peak > budget and accum < 8:
            print(f"[dryrun] peak {peak/1e9:.1f} GB > {budget/1e9:.1f} GB; retrying with grad_accum={accum*2}",
                  flush=True)
            accum *= 2
            continue
        break
    rec["hbm_budget_bytes"] = budget
    rec["fits"] = rec["memory"]["peak_est_bytes"] <= budget
    if save:
        _save(rec, arch, sh, gridlocal, mesh)
    return rec


def mesh_shape_of(name: str):
    """A mesh by the reference's name: "16x16", "2x16x16", "moe2d" (its
    256-chip pod), or any "AxB" / "PxAxB" as (data, model) / (pod, data,
    model)."""

    if name == "moe2d":
        return make_variant_mesh("moe2d")
    sizes = tuple(int(x) for x in name.split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(sizes))
    if axes is None:
        raise ValueError(f"unknown mesh {name!r}")
    return MeshShape(axes, sizes)


def device_mesh_for(name: str, device: torch.device):
    """The ``DeviceMesh`` of mesh ``name`` on a fake group of its size (the
    process's group, made if there is none)."""
    shape = mesh_shape_of(name)
    if not dist.is_initialized():
        init_fake_group(math.prod(shape.axis_sizes))
    return make_device_mesh(shape, device.type)


def _run_cell_once(arch, shape_name, gridlocal, grad_accum, device=None, cfg=None, opt_cfg=None,
                   record_ops=False, mesh: str = "") -> dict:
    """One count of the cell at ``grad_accum``: the record (its ``costs``
    left out; with ``record_ops`` the OpCosts is under ``_costs``).  With
    ``mesh`` the counts are one device's, under the reference's keys; a
    fake group made for the count is destroyed once it is taken, and a
    group the caller had is kept."""
    cfg = cfg or configs.get(arch)
    sh = cell_shape(shape_name)
    dev = _resolve(device)
    rules = get_rules(gridlocal)
    made_group = bool(mesh) and not dist.is_initialized()
    try:
        device_mesh = device_mesh_for(mesh, dev) if mesh else None
        costs, state_bytes, trace_s = count_cell(cfg, sh, gridlocal, grad_accum, dev, opt_cfg, record_ops,
                                                 device_mesh=device_mesh)
    finally:
        if made_group and dist.is_initialized():  # the fake group is this count's, not the caller's
            dist.destroy_process_group()

    n_params = T.param_count(cfg)
    n_active = T.active_param_count(cfg)
    if sh.kind == "train":
        tokens = sh.global_batch * sh.seq_len
        model_flops = 6 * n_active * tokens
    elif sh.kind == "prefill":
        tokens = sh.global_batch * sh.seq_len
        model_flops = 2 * n_active * tokens
    else:
        tokens = sh.global_batch
        model_flops = 2 * n_active * tokens

    meshes = {}
    for multi_pod in (False, True):
        prod = make_production_mesh(multi_pod=multi_pod)
        if gridlocal and "pod" not in prod.shape:
            continue  # GridLocal needs the pod axis
        meshes[prod.tag] = mesh_state_bytes(cfg, sh, gridlocal, rules, prod)

    terms = roofline_terms(costs.flops, costs.traffic_bytes, costs.coll_bytes_total, 1, HW, per_device=True)
    rec = {
        "arch": arch,
        "shape": sh.name,
        "kind": sh.kind,
        "global_batch": sh.global_batch,
        "seq_len": sh.seq_len,
        "mesh": "1",
        "chips": 1,
        "device": str(dev),
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else None,
        "rules": rules.name,
        "gridlocal": gridlocal,
        "status": "OK",
        "n_params": n_params,
        "n_active_params": n_active,
        "tokens_per_step": tokens,
        "model_flops": model_flops,
        "flops": costs.flops,
        "traffic_bytes": costs.traffic_bytes,
        "model_vs_counted_flops": model_flops / max(costs.flops, 1e-30),
        "n_ops": costs.n_ops,
        "collectives": {k: v for k, v in costs.as_dict().items() if k not in ("flops", "traffic_bytes", "peak_bytes")},
        "memory": {"state_bytes": state_bytes, "peak_est_bytes": costs.peak_bytes},
        "mesh_state_bytes": meshes,
        "roofline": terms,
        "grad_accum": grad_accum,
        "timing": {"trace_s": round(trace_s, 2)},
    }
    if device_mesh is not None:
        chips = device_mesh.size()
        rec.update({
            "mesh": mesh, "chips": chips,
            "hlo_flops_per_device": costs.flops,
            "hlo_bytes_per_device": costs.traffic_bytes,
            "model_vs_hlo_flops": model_flops / max(costs.flops * chips, 1e-30),
            "collectives": {k: v for k, v in costs.as_dict().items() if k not in ("flops", "traffic_bytes", "peak_bytes")},
            "roofline": roofline_terms(costs.flops, costs.traffic_bytes, costs.coll_bytes_total, chips, HW,
                                       per_device=True),
        })
        for k in ("flops", "traffic_bytes", "model_vs_counted_flops", "mesh_state_bytes"):
            rec.pop(k)
    if gridlocal:
        leaves = list(spec_leaves(T.param_specs(cfg)))
        named = {k: torch.empty(s.shape, dtype=torch_dtype(s.dtype), device="meta") for k, s in leaves}
        n_scales = len(leaves)  # one int8 scale a leaf of the JAX layout
        rec["gridlocal_merge_bytes"] = {
            "pods": GL_PODS, "outer": GL_OUTER._asdict(),
            "float32": merge_bytes(named, GL_PODS),
            "int8": merge_bytes(named, GL_PODS, "int8", n_scales),
        }
    if record_ops:
        rec["_costs"] = costs
    return rec


def _save(rec, arch, sh: Shape, gridlocal, mesh: str = ""):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{sh.name}"
    if sh.name in SHAPES and sh.global_batch != SHAPES[sh.name].global_batch:
        tag += f"__b{sh.global_batch}"
    if mesh:
        tag += f"__{mesh}"
    if gridlocal:
        tag += "__gridlocal"
    path = OUT_DIR / f"{tag}.json"
    path.write_text(json.dumps(rec, indent=2))
    print(f"[dryrun] wrote {path}")


def _summ(rec: dict) -> str:
    if rec.get("status") == "SKIP":
        return f"SKIP ({rec['reason'][:60]}...)"
    r = rec["roofline"]
    if "hlo_flops_per_device" in rec:
        return (
            f"OK flops/dev={rec['hlo_flops_per_device']:.3e} bytes/dev={rec['hlo_bytes_per_device']:.3e} "
            f"coll={rec['collectives']['total_bytes']:.3e} peak/dev={rec['memory']['peak_est_bytes']:.3e} "
            f"grad_accum={rec['grad_accum']} fits={rec.get('fits')} dom={r['dominant']} "
            f"frac={r['roofline_fraction']:.3f} trace={rec['timing']['trace_s']}s"
        )
    return (
        f"OK flops={rec['flops']:.3e} bytes={rec['traffic_bytes']:.3e} "
        f"peak={rec['memory']['peak_est_bytes']:.3e} grad_accum={rec['grad_accum']} fits={rec.get('fits')} "
        f"dom={r['dominant']} bound={r['bound_s']:.4g}s frac={r['roofline_fraction']:.3f} "
        f"trace={rec['timing']['trace_s']}s"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--gridlocal", action="store_true")
    ap.add_argument("--all", action="store_true", help="run every cell in subprocesses")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=0, help="0 = auto-fit the card's memory")
    ap.add_argument("--global-batch", type=int, default=0, help="cut the shape's global batch (0: as published)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the fake tensors live (default: the card)")
    ap.add_argument("--mesh", default="", help="16x16 | 2x16x16 | moe2d: one device's share on a fake group "
                                               "of the mesh's size (default: the whole step on one card)")
    args = ap.parse_args(argv)
    _resolve(args.device)

    if args.all:
        failures = []
        for a in configs.ARCHS:
            for s in SHAPES:
                out = OUT_DIR / f"{a}__{s}.json"
                if args.skip_existing and out.exists():
                    print(f"[dryrun] skip existing {out.name}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
                       "--grad-accum", str(args.grad_accum)]
                if args.device:
                    cmd += ["--device", args.device]
                print("[dryrun] >>>", " ".join(cmd), flush=True)
                r = subprocess.run(cmd, env={**os.environ})
                if r.returncode != 0:
                    failures.append((a, s))
        if failures:
            print("[dryrun] FAILURES:", failures)
            sys.exit(1)
        print("[dryrun] all cells OK")
        return

    if not (args.arch and args.shape):
        ap.error("--arch/--shape required (or --all)")
    rec = run_cell(args.arch, args.shape, args.gridlocal, grad_accum=args.grad_accum, device=args.device,
                   global_batch=args.global_batch, mesh=args.mesh)
    print(f"[dryrun] {args.arch} x {args.shape} ({args.mesh or '1 card'}, {rec.get('device')}): {_summ(rec)}")
    if rec.get("status") == "OK":
        print(json.dumps(rec["roofline"], indent=2))
        print(json.dumps({**rec["memory"], **({"mesh_state_bytes": rec["mesh_state_bytes"]}
                                               if "mesh_state_bytes" in rec else {})}, indent=2))


if __name__ == "__main__":
    main()
