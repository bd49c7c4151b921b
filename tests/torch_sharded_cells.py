"""The cells the sharded-count tests hold the port's per-device counts
to, and the two scripts that count them: the JAX package's sharded compile
on 8 host devices (``analyze_hlo`` of the post-SPMD HLO) and the port's
step on a fake 8-rank group (``launch.dryrun.count_cell``).  Each script
runs in a process of its own, takes the cells as JSON on its command line
and prints one JSON line a cell."""

import json
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESH = (2, 2, 2)  # (pod, data, model)
BATCH, SEQ = 8, 32
FLOPS_RTOL = 0.05  # the whole-step bar of the one-card dry run's tests

JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
import repro.configs as C
from repro.models.config import reduced
from repro.models import transformer as T
from repro.models.layers import spec
from repro.train import steps as S
from repro.sharding import BASELINE, GRIDLOCAL, activate, specs_to_shardings, specs_to_structs, ShapeAxes
from repro.roofline.hlo_costs import analyze_hlo

B, L = BATCH_, SEQ_
# Auto axes: jax.make_mesh's default (Explicit) refuses the embedding gather
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
for arch, kind, gl in json.loads(sys.argv[1]):
    cfg = reduced(C.get(arch))
    rules = GRIDLOCAL if gl else BASELINE
    tok = ("batch", "seq")
    if kind == "decode":
        batch = {"token": spec((B, 1), tok, "int32"), "pos": ShapeAxes(shape=(), dtype="int32", axes=())}
    else:
        s_tok = L - (cfg.frontend_len if (cfg.frontend != "none" and not cfg.is_encdec) else 0)
        batch = {"tokens": spec((B, s_tok), tok, "int32")}
        if kind == "train":
            batch["labels"] = spec((B, s_tok), tok, "int32")
        if cfg.frontend != "none":
            batch["frontend"] = spec((B, cfg.frontend_len, cfg.d_model), ("batch", "frontend", None), cfg.dtype)
    with activate(mesh, rules):
        b_sh = specs_to_shardings(batch, rules, mesh)
        b_st = specs_to_structs(batch, rules, mesh)
        if kind == "train":
            st = S.train_state_specs(cfg, n_pods=2 if gl else 0)
            fn = S.make_gridlocal_train_step(cfg, mesh) if gl else S.make_train_step(cfg)
            st_sh = specs_to_shardings(st, GRIDLOCAL if gl else rules, mesh)
            lowered = jax.jit(fn, in_shardings=(st_sh, b_sh), out_shardings=(st_sh, None)).lower(
                specs_to_structs(st, GRIDLOCAL if gl else rules, mesh), b_st)
        else:
            ps, cs = T.param_specs(cfg), T.cache_specs(cfg, B, L)
            fn = S.make_prefill_step(cfg) if kind == "prefill" else S.make_decode_step(cfg)
            p_sh, c_sh = specs_to_shardings(ps, rules, mesh), specs_to_shardings(cs, rules, mesh)
            lowered = jax.jit(fn, in_shardings=(p_sh, b_sh, c_sh), out_shardings=(None, c_sh)).lower(
                specs_to_structs(ps, rules, mesh), b_st, specs_to_structs(cs, rules, mesh))
        compiled = lowered.compile()
    c = analyze_hlo(compiled.as_text(), chips_per_pod=4)
    print(json.dumps({"arch": arch, "kind": kind, "gridlocal": gl, "flops": c.flops,
                      "coll": c.as_dict()["bytes_by_type"]}), flush=True)
"""

PORT_SCRIPT = r"""
import json, sys, logging
logging.disable(logging.WARNING)
import torch
import repro_torch.configs as C
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun as D
from repro_torch.optim.outer import OuterConfig

D.GL_OUTER = OuterConfig(h_steps=2)  # the reference's default merge (f32), counted on a merging step
dev = torch.device("cpu")
mesh = D.device_mesh_for("2x2x2", dev)
for arch, kind, gl in json.loads(sys.argv[1]):
    cfg = C.reduced(C.get(arch))
    costs, _, _ = D.count_cell(cfg, Shape("t", SEQ_, BATCH_, kind), gl, 1, dev, device_mesh=mesh)
    print(json.dumps({"arch": arch, "kind": kind, "gridlocal": gl, "flops": costs.flops,
                      "coll": costs.coll_bytes_by_type}), flush=True)
"""


def _start(script: str, cells: list, jax: bool) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    src = script.replace("BATCH_", str(BATCH)).replace("SEQ_", str(SEQ))
    return subprocess.Popen([sys.executable, "-c", src, json.dumps(cells)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def count_both(cells: list, timeout: float = 300.0) -> tuple[dict, dict]:
    """(reference counts, port counts) by (arch, kind, gridlocal), the two
    processes run side by side."""
    procs = [_start(JAX_SCRIPT, cells, True), _start(PORT_SCRIPT, cells, False)]
    out = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            raise RuntimeError(f"count script failed ({p.returncode}):\n{se[-4000:]}")
        rows = [json.loads(line) for line in so.splitlines() if line.startswith("{")]
        out.append({(r["arch"], r["kind"], r["gridlocal"]): r for r in rows})
    return out[0], out[1]


def check_cell(ref: dict, port: dict, key) -> None:
    """The port's per-device FLOPs within FLOPS_RTOL of the reference's;
    the collective bytes by type beside the reference's in the message,
    not gated (the two partitioners choose differently)."""
    r, p = ref[key]["flops"], port[key]["flops"]
    assert abs(p - r) <= FLOPS_RTOL * r, (
        f"{key}: port {p:.4e} FLOPs/device vs reference {r:.4e} (ratio {p / r:.4f}); "
        f"collective bytes port {port[key]['coll']} reference {ref[key]['coll']}")
