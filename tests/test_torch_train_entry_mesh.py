"""The training entry on its ``(ranks, 1)`` data mesh, on the CPU over
gloo, held to the JAX entry's loop on a ``(2, 1)`` mesh of two host
devices.

The JAX entry (``repro.launch.train``) keeps its state replicated on the
mesh and splits only the batch over ``data``; the port runs the same loop
on ranks of a ``torch.distributed`` group (``train.steps.replicate_state``)
and commits each checkpoint once, from rank 0, under ``proc_00000``.  On
stablelm-1.6b reduced, ``--seq-len 16``, a global batch of 4:

  * the JAX loop (its own functions, in a subprocess with two host devices
    and ``AxisType.Auto`` axes: jax's default Explicit axes raise at the
    embedding gather, the seed's ``test_system.py`` failure) trains 4
    steps from ``materialize_state(cfg, PRNGKey(0))``, saved as step 0 by
    the JAX package's checkpointer; the port's 2-rank entry resumes that
    step 0 with ``--steps 4``, and its step-4 directory holds the JAX
    loop's state by ``test_torch_checkpoint.hold`` (the parameters by the
    band rule, the moments normwise within 1e-4), at grad_accum 1 and 2;
  * every rank's state equals rank 0's bit for bit, rank 0 alone prints
    (``on 2 device(s)``), and a step holds one ``proc_00000``;
  * on 2 ranks the step-6 directory resumed from step 3 equals the
    unbroken run's byte for byte;
  * a step saved on 2 ranks restores on 1 bit for bit, and one saved on 1
    restores on 2;
  * on one rank the entry's step-6 files equal, byte for byte, those of 6
    plain ``make_train_step`` steps saved through the checkpointer;
  * a save that waits for its commit raises the write's error.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.train import steps as JS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import train
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import steps as TS
from test_torch_checkpoint import assert_same_bits, hold
from torch_sharded_gloo import SRC, run_ranks

ARCH, SEQ, BATCH, STEPS = "stablelm-1.6b", 16, 4, 4
ARGS = ["--reduced", "--device", "cpu", "--seq-len", str(SEQ), "--global-batch", str(BATCH)]
ACCUMS = (1, 2)
CFG = TC.reduced(TC.get(ARCH))
STEP_FILES = "step_{:010d}"

# Each run of ``INPUTS["runs"]`` calls the entry on this rank; the entry
# uses the group the child's head made.  Recorded a run: rank 0's printed
# lines, the state as placed (restored or drawn), the state after the last
# step, the union of the near-zero gradients (test_torch_checkpoint's band
# rule) and the learning rates.
BODY = r"""
import contextlib, io
from repro_torch import configs as TC, convert
from repro_torch.launch import train
from repro_torch.sharding import full
from repro_torch.train import steps as TS

cfg = TC.reduced(TC.get(INPUTS["arch"]))
REC = {}
real_update, real_replicate, real_make = TS.adamw_update, train.replicate_state, train.make_train_step

def update(c, g, st, p):
    for k, x in g.items():
        x = full(x)
        m = (x.abs() <= 2e-4 * x.abs().max()) & (x != 0)
        REC["band"][k] = REC["band"][k] | m if k in REC["band"] else m
    return real_update(c, g, st, p)

def replicate(c, state, mesh):
    state = real_replicate(c, state, mesh)
    REC["placed"] = convert.state_to_reference(c, state)
    return state

def make(*a, **k):
    step = real_make(*a, **k)
    def recorded(state, batch):
        state, met = step(state, batch)
        REC["final"], REC["lrs"] = state, REC["lrs"] + [float(full(met["lr"]))]
        return state, met
    return recorded

TS.adamw_update, train.replicate_state, train.make_train_step = update, replicate, make
RESULTS["runs"] = []
for argv in INPUTS["runs"]:
    REC.clear()
    REC.update(band={}, lrs=[], final=None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(argv)
    RESULTS["runs"].append({
        "out": out.getvalue(), "placed": REC["placed"], "lrs": REC["lrs"],
        "final": None if REC["final"] is None else convert.state_to_reference(cfg, REC["final"]),
        "band": convert.params_to_reference(cfg, REC["band"]) if REC["band"] else None,
    })
"""

# The JAX entry's loop (repro/launch/train.py) with the JAX package's own
# functions on a (2, 1) mesh of two host devices, from the step-0 state in
# argv[1]/start: 4 steps at each grad_accum, each state saved at step 4
# under argv[1]/ga<accum>, with the learning rates and the leaves' specs.
JAX_LOOP = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp
from jax.sharding import AxisType
import repro.configs as configs
from repro.checkpoint.checkpointer import Checkpointer
from repro.data.pipeline import TokenStream, device_put_batch
from repro.models.config import reduced
from repro.optim.adamw import AdamWConfig
from repro.sharding import BASELINE, activate
from repro.train.steps import make_train_step, materialize_state

out, arch, seq, batch, steps = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
cfg = reduced(configs.get(arch))
mesh = jax.make_mesh((jax.device_count(), 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
stream = TokenStream(vocab=cfg.vocab, global_batch=batch, seq_len=seq, seed=0)
opt = AdamWConfig(lr=3e-3, warmup=5, decay_steps=max(steps, 10))
report = {"devices": jax.device_count()}
for accum in map(int, sys.argv[6].split(",")):
    with activate(mesh, BASELINE):
        step_fn = jax.jit(make_train_step(cfg, opt, loss_chunk=min(512, seq), grad_accum=accum), donate_argnums=0)
        like = materialize_state(cfg, jax.random.PRNGKey(0))
        state = jax.tree.map(jnp.asarray, Checkpointer(os.path.join(out, "start")).restore(like))
        lrs = []
        for step in range(steps):
            state, met = step_fn(state, device_put_batch(stream.host_batch_at(step), mesh, BASELINE))
            lrs.append(float(met["lr"]))
        Checkpointer(os.path.join(out, f"ga{accum}"), async_mode=False).save(steps, state)
    report[str(accum)] = {"lrs": lrs, "specs": sorted({str(x.sharding.spec) for x in jax.tree.leaves(state)})}
print(json.dumps(report))
"""


def saved(directory, step: int) -> dict:
    """The train state of a step directory, as the checkpointer restores it."""
    return Checkpointer(directory).restore(TS.train_state_specs(CFG), step=step)


def proc_dirs(directory) -> list[str]:
    """Every entry of every committed step directory but the manifest."""
    return sorted({p.name for s in directory.glob("step_*") for p in s.iterdir() if p.name != "manifest.json"})


def same_files(a, b) -> int:
    """Two ``proc_00000`` directories hold the same files byte for byte; returns their count."""
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and len(names) > 10
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    return len(names)


# ---------------------------------------------------------------------------
# Against the JAX entry's loop, on 2 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def against_jax(tmp_path_factory):
    root = tmp_path_factory.mktemp("entry_jax")
    jstate = JS.materialize_state(JC.reduced(JC.get(ARCH)), jax.random.PRNGKey(0))
    JCheckpointer(root / "jax" / "start", async_mode=False).save(0, jstate)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_LOOP, str(root / "jax"), ARCH, str(SEQ), str(BATCH),
                                str(STEPS), ",".join(map(str, ACCUMS))],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        runs = []
        for accum in ACCUMS:
            shutil.copytree(root / "jax" / "start", root / f"port{accum}")
            runs.append([*ARGS, "--grad-accum", str(accum), "--steps", str(STEPS), "--resume",
                         "--ckpt-dir", str(root / f"port{accum}")])
        ranks = run_ranks(BODY, {"arch": ARCH, "runs": runs}, tmp_path_factory.mktemp("ranks"), n=2,
                          every_rank=True)
        so, se = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert jax_run.returncode == 0, se[-3000:]
    return {"root": root, "ranks": ranks, "jax": json.loads(so.strip().splitlines()[-1])}


@pytest.mark.parametrize("accum", ACCUMS)
def test_entry_holds_the_jax_entry(against_jax, accum):
    """The port's 2-rank entry resumed from the JAX package's step 0 holds
    the JAX loop's state at step 4, whose every leaf stayed replicated."""
    root, i = against_jax["root"], ACCUMS.index(accum)
    report = against_jax["jax"]
    assert report["devices"] == 2 and report[str(accum)]["specs"] == ["PartitionSpec()"]
    run = against_jax["ranks"][0]["runs"][i]
    assert "[train] resumed from step 0" in run["out"]
    np.testing.assert_allclose(run["lrs"], report[str(accum)]["lrs"], rtol=1e-6)
    want = JCheckpointer(root / "jax" / f"ga{accum}").restore(
        JS.materialize_state(JC.reduced(JC.get(ARCH)), jax.random.PRNGKey(0)))
    hold(saved(root / f"port{accum}", STEPS), jax.tree.map(np.asarray, want), run["band"], sum(run["lrs"]))


def test_replicas_stay_bit_identical(against_jax):
    """After 4 steps every rank's state equals rank 0's bit for bit, and
    rank 0's equals what it saved; rank 0 alone printed."""
    ranks = against_jax["ranks"]
    for i in range(len(ACCUMS)):
        first = ranks[0]["runs"][i]
        for other in ranks[1:]:
            assert_same_bits(other["runs"][i]["final"], first["final"])
            assert other["runs"][i]["out"] == ""
        assert_same_bits(saved(against_jax["root"] / f"port{ACCUMS[i]}", STEPS), first["final"])
        assert "on 2 device(s)" in first["out"]


def test_each_step_is_committed_once(against_jax):
    """A step directory written on 2 ranks holds the manifest and one
    ``proc_00000``, as the JAX package's one process writes it."""
    for accum in ACCUMS:
        d = against_jax["root"] / f"port{accum}"
        assert Checkpointer(d).all_steps() == [0, STEPS]
        assert proc_dirs(d) == ["proc_00000"]
        assert not list(d.glob("*.tmp"))


# ---------------------------------------------------------------------------
# Resuming, on 2 ranks and across rank counts; one rank against plain steps
# ---------------------------------------------------------------------------

RESUME = [*ARGS, "--ckpt-every", "3"]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """In this process: the one-rank entry, 6 steps (``one``), and 6 plain
    steps through the checkpointer (``plain``).  Then on 2 ranks: 6 steps
    unbroken (``a``), 3 then 6 resumed (``b``), and ``one`` resumed
    (``from1``).  Last, in this process again, ``a`` resumed on one rank
    (``from2``)."""
    root = tmp_path_factory.mktemp("entry_resume")
    train.main([*RESUME, "--steps", "6", "--ckpt-dir", str(root / "one")])

    stream = TokenStream(vocab=CFG.vocab, global_batch=BATCH, seq_len=SEQ, seed=0)
    step_fn = TS.make_train_step(CFG, AdamWConfig(lr=3e-3, warmup=5, decay_steps=10), loss_chunk=SEQ)
    state = TS.materialize_state(CFG, device="cpu")
    for s in range(6):
        state, _ = step_fn(state, {k: torch.from_numpy(v).long() for k, v in stream.batch_at(s).items()})
    Checkpointer(root / "plain").save(6, convert.state_to_reference(CFG, state), wait=True)

    shutil.copytree(root / "one", root / "from1")
    runs = [[*RESUME, "--steps", "6", "--ckpt-dir", str(root / "a")],
            [*RESUME, "--steps", "3", "--ckpt-dir", str(root / "b")],
            [*RESUME, "--steps", "6", "--ckpt-dir", str(root / "b"), "--resume"],
            [*RESUME, "--steps", "6", "--ckpt-dir", str(root / "from1"), "--resume"]]
    ranks = run_ranks(BODY, {"arch": ARCH, "runs": runs}, tmp_path_factory.mktemp("ranks"), n=2,
                      every_rank=True)

    shutil.copytree(root / "a", root / "from2")
    placed = []
    real = train.replicate_state

    def replicate(c, st, mesh):
        st = real(c, st, mesh)
        placed.append(convert.state_to_reference(c, st))
        return st

    train.replicate_state = replicate
    try:
        train.main([*RESUME, "--steps", "6", "--ckpt-dir", str(root / "from2"), "--resume"])
    finally:
        train.replicate_state = real
    return {"root": root, "ranks": ranks, "from2": placed[0]}


def test_two_ranks_resumed_equals_unbroken(resumed):
    """On 2 ranks, step 6 resumed from step 3 equals unbroken byte for
    byte; each step directory holds one ``proc_00000``."""
    root, out = resumed["root"], resumed["ranks"][0]["runs"]
    assert "[train] resumed from step 3" in out[2]["out"] and "on 2 device(s)" in out[0]["out"]
    assert "[train] checkpoints: [3, 6]" in out[0]["out"] and "[train] checkpoints: [3]" in out[1]["out"]
    same_files(*(root / d / STEP_FILES.format(6) / "proc_00000" for d in ("a", "b")))
    for d in ("a", "b"):
        assert proc_dirs(root / d) == ["proc_00000"]


@pytest.mark.parametrize("saved_on", [1, 2])
def test_a_save_restores_on_another_rank_count(resumed, saved_on):
    """A step saved on 1 rank restores on 2 (every rank), and one saved on
    2 restores on 1, bit for bit."""
    root = resumed["root"]
    if saved_on == 1:
        got = [r["runs"][3]["placed"] for r in resumed["ranks"]]
        assert "[train] resumed from step 6" in resumed["ranks"][0]["runs"][3]["out"]
        want = saved(root / "one", 6)
    else:
        got, want = [resumed["from2"]], saved(root / "a", 6)
    for g in got:
        assert_same_bits(g, want)


def test_one_rank_mesh_equals_plain_steps(resumed):
    """On a one-rank gloo mesh the entry writes, at step 6, the bytes of 6
    plain ``make_train_step`` steps saved through the checkpointer."""
    root = resumed["root"]
    same_files(*(root / d / STEP_FILES.format(6) / "proc_00000" for d in ("one", "plain")))


def test_a_waiting_save_raises_the_write_error(tmp_path):
    """A save that waits for its commit raises the writer's error rather
    than leave it to a next call that the entry, at its last step, never
    makes."""
    ck = Checkpointer(tmp_path / "ck", async_mode=True)
    (tmp_path / "ck").rmdir()
    (tmp_path / "ck").write_text("not a directory")
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.save(1, {"w": torch.zeros(3)}, wait=True)
    ck.check()  # raised once
