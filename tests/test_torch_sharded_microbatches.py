"""The sharded train step's microbatches are the reference's: at
``grad_accum`` > 1 microbatch i holds the global rows ``[i·B/n,
(i+1)·B/n)`` in their order, as ``repro.train.steps.make_train_step``
splits the batch, whatever block of rows each rank holds.

  * On a 4-rank gloo group, mesh (data 4, model 1), 8 rows at grad_accum
    2 (each rank holds 2 rows, so a split of each rank's own rows would put
    rows 0, 2, 4, 6 in microbatch 0), the labels of the first microbatch's
    rows mostly masked, so that the two microbatches' CE means are over
    different label counts: the two MoE archs reduced, whose aux loss and
    capacity cut also depend on which tokens share a microbatch, and
    stablelm-1.6b, whose only dependence is the label counts.  Each is
    held to the JAX package's ``grad_accum`` step, under ``jax.jit`` as its
    entry runs it, fed the batch in its own order (``torch_sharded_train``'s
    tolerances).
  * ``launch.train --grad-accum 2`` on 2 gloo ranks with mixtral-8x22b
    reduced holds the JAX entry's loop on a ``(2, 1)`` mesh
    (``test_torch_train_entry_mesh``'s machinery).
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.configs as JC
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.train import steps as JS
from repro_torch import configs as TC
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.train import steps as TS
from test_torch_checkpoint import hold
from test_torch_train_entry_mesh import ARGS, BATCH, BODY, JAX_LOOP, SEQ
from torch_sharded_gloo import SRC, run_ranks
from torch_sharded_train import S, check, key_of, run_cases

ROWS, MESH, ACCUM = 8, (4, 1), 2
CASES = [("mixtral-8x22b", 0, ACCUM), ("deepseek-moe-16b", 0, ACCUM), ("stablelm-1.6b", 0, ACCUM)]
ENTRY_ARCH, ENTRY_STEPS = "mixtral-8x22b", 2


def uneven_mask() -> np.ndarray:
    """Labels ignored on all but 4 positions of each row of the first
    microbatch (rows 0-3): it keeps 16 labels, the second 96."""
    mask = np.zeros((ROWS, S), bool)
    mask[: ROWS // ACCUM, 4:] = True
    return mask


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("ranks"), mesh=MESH, rows=ROWS, mask=uneven_mask(), jit=True)


@pytest.mark.parametrize("case", CASES, ids=lambda c: key_of(*c))
def test_microbatches_are_the_references(case, results):
    check(*results[key_of(*case)])


def test_the_entry_at_grad_accum_2_holds_the_jax_entry_on_an_moe_arch(tmp_path):
    """Both entries from the JAX package's step-0 state, ``--steps 2 --grad-accum
    2``: the port's 2-rank step-2 directory holds the JAX loop's state by
    ``test_torch_checkpoint.hold``."""
    jcfg = JC.reduced(JC.get(ENTRY_ARCH))
    JCheckpointer(tmp_path / "jax" / "start", async_mode=False).save(0, JS.materialize_state(jcfg, jax.random.PRNGKey(0)))
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_LOOP, str(tmp_path / "jax"), ENTRY_ARCH, str(SEQ),
                                str(BATCH), str(ENTRY_STEPS), str(ACCUM)],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        shutil.copytree(tmp_path / "jax" / "start", tmp_path / "port")
        argv = [*ARGS, "--arch", ENTRY_ARCH, "--grad-accum", str(ACCUM), "--steps", str(ENTRY_STEPS), "--resume",
                "--ckpt-dir", str(tmp_path / "port")]
        (tmp_path / "ranks").mkdir()
        run = run_ranks(BODY, {"arch": ENTRY_ARCH, "runs": [argv]}, tmp_path / "ranks", n=2)["runs"][0]
        so, se = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert jax_run.returncode == 0, se[-3000:]
    report = json.loads(so.strip().splitlines()[-1])
    assert "[train] resumed from step 0" in run["out"] and "on 2 device(s)" in run["out"]
    np.testing.assert_allclose(run["lrs"], report[str(ACCUM)]["lrs"], rtol=1e-6)
    cfg = TC.reduced(TC.get(ENTRY_ARCH))
    got = Checkpointer(tmp_path / "port").restore(TS.train_state_specs(cfg), step=ENTRY_STEPS)
    want = JCheckpointer(tmp_path / "jax" / f"ga{ACCUM}").restore(JS.materialize_state(jcfg, jax.random.PRNGKey(0)))
    hold(got, jax.tree.map(np.asarray, want), run["band"], sum(run["lrs"]))
