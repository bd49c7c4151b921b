"""The comparison that decides ``correct``: each plain reference agrees
with ``repro_torch`` at tiny widths on the CPU; the fp8 control reads far
above the program; every fault a cell can have turns ``correct`` false.
On the card (``cuda``), the control at the cell's own size fails the
committed limits."""

from __future__ import annotations

import json
import types

import pytest
import torch
from conftest import REPO

from portbench import faults, manifest, run

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _entry(root, cell, seed, device="cpu"):
    c = manifest.resolve(root, manifest.load(root), cell)
    return c, manifest.entry_module(c.entry).Entry(c, seed, device)


def _program(entry, cell):
    entry.setup()
    for _ in range(int(cell.mix.get("calibrate_calls", 0))):
        entry.call()
    entry.close()
    return entry.program()


def _control(entry, cell, precision="fp8"):
    if "calibrate_calls" in cell.mix:
        entry.judge_without_calls(int(cell.mix["calibrate_calls"]))
    return entry.numbers(entry.reference(precision), entry.reference("float32"))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program_in_float32(tiny_root, cell):
    """At tiny widths in float32 the program and the reference compute one
    function: every number is at round-off."""
    c, e = _entry(tiny_root, cell, seed=2**36 + 1)
    nums = e.numbers(_program(e, c), e.reference("float32"))
    assert all(v < 1e-5 for v in nums.values()), nums


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_the_program(tiny_root, cell):
    c, e = _entry(tiny_root, cell, seed=2**36 + 2)
    prog = e.numbers(_program(e, c), e.reference("float32"))
    c, e = _entry(tiny_root, cell, seed=2**36 + 2)
    ctrl = _control(e, c)
    assert any(ctrl[k] > 100 * max(prog[k], 1e-7) for k in ctrl), (prog, ctrl)


def _faults_of(cell):
    kind = manifest.resolve(REPO, BENCH, cell).entry
    return [(cell, f) for f in faults.NAMES if hasattr(faults._Planted, f"{kind}_{f}")]


@pytest.mark.parametrize("cell,fault", [p for cell in CELLS for p in _faults_of(cell)])
def test_fault_turns_correct_false(tiny_root, monkeypatch, cell, fault):
    """The run as the driver makes it, the look for a card skipped and the
    timed path broken underneath: ``correct`` comes out false."""
    c = manifest.resolve(tiny_root, manifest.load(tiny_root), cell)
    real = manifest.entry_module(c.entry)

    def planted(cell_, seed, device):
        e = real.Entry(cell_, seed, device)
        faults.plant(e, fault)
        return e

    monkeypatch.setattr(manifest, "entry_module", lambda name: types.SimpleNamespace(Entry=planted))
    result, checks = run.run_cell(c, seed=2**36 + 3, seconds=0.2, trace=False, device="cpu", t0=0.0)
    assert result["correct"] is False, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_at_the_cells_size(card, cell):
    c, e = _entry(REPO, cell, seed=2**36 + 4, device="cuda")
    nums = _control(e, c)
    assert any(v > c.limits[k] for k, v in nums.items()), nums
    torch.cuda.empty_cache()
