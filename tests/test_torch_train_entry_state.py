"""What the training entry finds in its process, and what the dry run
and its cost counter leave there.

``launch.train.main`` places its state as DTensors on the default
``torch.distributed`` group the process has (a caller's), else on a
one-rank group it makes and destroys, and prints that group's size.

  * ``roofline.op_costs.CostCounter`` pauses itself inside DTensor's shape
    inference by wrapping ``ShardingPropagator``'s method while it is
    entered, and re-enters itself for every composite op it decomposes.
    Each re-entry used to save the outer wrapper as the method to restore,
    so every count left one more wrapper behind: after the dry-run tests
    of one pytest worker (about 1,300 levels after ``test_torch_sharding.py``
    and ``test_torch_dryrun.py``) every DTensor op of that process ran
    through that many frames, and the entry's tests in the same worker
    raised RecursionError.  Only the outermost entry now wraps and
    restores.
  * A one-card dry run on a mesh (``launch.dryrun``) counts on a fake
    group of the mesh's size and destroys the group it made once the
    count is taken; the entry refuses a fake group outright, since its
    collectives move nothing.

Each test starts from a process without a group, an active sharding, a
live checkpoint writer, a mode left on torch's stacks or a counter's
wrapper (``torch_process_state``), and leaves none.
"""

import contextlib
import threading

import pytest
import torch.distributed as dist

from repro_torch import configs as TC
from repro_torch.checkpoint.checkpointer import WRITER_THREAD
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import init_fake_group, make_device_mesh, make_test_mesh
from repro_torch.roofline.op_costs import CostCounter
from repro_torch.sharding import BASELINE, activate
from torch_process_state import leaked_state, shape_inference_hook

ARCH = "stablelm-1.6b"
ARGS = ["--reduced", "--device", "cpu", "--seq-len", "16", "--steps", "2", "--ckpt-every", "1"]
CELL = Shape("t", 16, 4, "train")


@pytest.fixture(autouse=True)
def clean_process():
    assert not leaked_state(), leaked_state()
    name, hook = shape_inference_hook()
    yield
    if dist.is_initialized():  # a failed test leaves no group or wrapper for the next one
        dist.destroy_process_group()
    if name is not None:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        setattr(ShardingPropagator, name, hook)


def test_a_reentered_counter_leaves_dtensor_as_it_found_it(tmp_path, capsys):
    """1,100 counts' worth of re-entries (one a composite op), then the
    entry: DTensor's shape inference is the method it was, and the entry
    trains (before the repair it raised RecursionError, as in a six-worker
    run of the suite)."""
    before = shape_inference_hook()
    counter = CostCounter()
    for _ in range(1_100):
        with counter:
            with counter:
                pass
    train.main([*ARGS, "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "params on 1 device(s)" in out and "[train] checkpoints: [1, 2]" in out
    assert shape_inference_hook() == before and not leaked_state()


@pytest.mark.parametrize("record_ops", [False, True])
def test_a_counted_train_step_leaves_nothing_behind(record_ops):
    """A dry-run count of a train step (its backward decomposes composite
    ops under the counter) leaves no wrapper and no mode behind."""
    costs, _, _ = dryrun.count_cell(TC.reduced(TC.get(ARCH)), CELL, False, 1, "cpu", record_ops=record_ops)
    assert costs.n_ops > 0 and bool(costs.ops) == record_ops
    assert not leaked_state()


def count_on_a_mesh() -> dict:
    """The reduced arch's train cell counted on a fake 2x2 group."""
    return dryrun._run_cell_once(ARCH, CELL, False, 1, "cpu", cfg=TC.reduced(TC.get(ARCH)), mesh="2x2")


def test_a_count_on_a_mesh_leaves_no_group_for_the_entry(tmp_path, capsys):
    """The entry run after an in-process dry run on a mesh trains on its
    own one rank, and neither leaves a group behind."""
    rec = count_on_a_mesh()
    assert rec["mesh"] == "2x2" and rec["chips"] == 4 and rec["hlo_flops_per_device"] > 0
    assert not leaked_state()
    train.main([*ARGS, "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "params on 1 device(s)" in out and "[train] checkpoints: [1, 2]" in out
    assert not leaked_state()


def test_a_count_keeps_the_callers_group():
    """A count made inside a caller's fake group of the mesh's size counts
    on it and leaves it in place."""
    init_fake_group(4)
    count_on_a_mesh()
    assert dist.is_initialized() and dist.get_backend() == "fake" and dist.get_world_size() == 4


def test_the_entry_refuses_a_fake_group(tmp_path):
    init_fake_group(1)
    with pytest.raises(RuntimeError, match="fake backend"):
        train.main([*ARGS, "--ckpt-dir", str(tmp_path)])
    assert dist.is_initialized() and dist.get_backend() == "fake"  # the caller's group stays the caller's


@pytest.mark.parametrize("kind", ["group", "sharding", "writer"])
def test_the_guard_names_what_it_finds(kind):
    """``leaked_state`` names each kind of state a caller can leave."""
    with contextlib.ExitStack() as stack:
        if kind == "group":
            init_fake_group(2)
            want = "default process group (backend 'fake', 2 rank(s))"
        elif kind == "sharding":
            init_fake_group(4)
            stack.enter_context(activate(make_device_mesh(make_test_mesh(2, 2), "cpu"), BASELINE))
            want = "1 active sharding(s)"
        else:
            done = threading.Event()
            writer = threading.Thread(target=done.wait, name=WRITER_THREAD, daemon=True)
            writer.start()
            stack.callback(writer.join)
            stack.callback(done.set)
            want = "1 live checkpoint writer thread(s)"
        found = leaked_state()
        assert any(want in f for f in found), found
    if dist.is_initialized():
        dist.destroy_process_group()
    assert not leaked_state()
