"""A run's result line, its refusals and its import check, at tiny widths on
the CPU (the look for a card skipped, as only the card can pass it)."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest
import torch
from conftest import REPO

from portbench import manifest, run, traffic

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _run(root, cell, trace, seed=2**35 + 11):
    c = manifest.resolve(root, manifest.load(root), cell)
    return c, run.run_cell(c, seed=seed, seconds=0.2, trace=trace, device="cpu", t0=0.0)[0]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny_root, cell, trace):
    c, result = _run(tiny_root, cell, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    wanted = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(result["metrics"]) <= wanted
    if not trace:
        assert set(result["metrics"]) == wanted  # every end-to-end metric is read off the host clock
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(result["checks"]) == set(c.limits)
    for chk in result["checks"].values():
        assert set(chk) == {"value", "limit"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(result["breakdown"][k]) <= 10 for k in result["breakdown"])
    json.dumps(result)


def test_same_seed_same_answers(tiny_root):
    a = _run(tiny_root, CELLS[0], False, seed=77)[1]["checks"]
    b = _run(tiny_root, CELLS[0], False, seed=77)[1]["checks"]
    assert a == b


def test_judged_calls_are_drawn_over_the_whole_window():
    """The reservoir keeps ``k`` distinct calls of however many come, the
    same ones for the same seed and count, as often late as early."""

    def draw(seed, n, k=2):
        r = traffic.Reservoir(seed, k)
        for i in range(n):
            r.offer(i)
        return r.indices

    assert draw(2**40 + 1, 174) == draw(2**40 + 1, 174) and draw(5, 1) == [0]
    picks = [draw(seed, 174) for seed in range(200)]
    assert all(len(set(p)) == 2 and all(0 <= i < 174 for i in p) for p in picks)
    assert 0.4 < sum(i >= 87 for p in picks for i in p) / 400 < 0.6


def test_refuses_without_a_card():
    """No CUDA card: exit code not 0 and nothing on standard output."""
    out = subprocess.run([sys.executable, str(REPO / "portbench" / "run.py"), "--workload", CELLS[0], "--seed",
                          "3", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("planted", [False, True])
def test_refuses_when_the_jax_package_loads_after_the_window(tiny_root, monkeypatch, capsys, planted):
    """``main`` as the driver runs it, the look for a card skipped: a module
    of the JAX package loaded by the reference, after the window and the
    metric readers, leaves standard output empty and the exit code not 0;
    without it, one result line and 0."""
    cell = CELLS[-1]
    c = manifest.resolve(tiny_root, manifest.load(tiny_root), cell)
    entry = manifest.entry_module(c.entry).Entry
    real_reference, real_run_cell = entry.reference, run.run_cell

    def reference(self, precision):
        if planted:
            monkeypatch.setitem(sys.modules, "repro.planted", types.ModuleType("repro.planted"))
        return real_reference(self, precision)

    monkeypatch.setattr(entry, "reference", reference)
    monkeypatch.setattr(run, "run_cell", lambda cell_, seed, seconds, trace, device, t0:
                        real_run_cell(cell_, seed, seconds, trace, "cpu", t0))
    monkeypatch.setattr(run, "ROOT", tiny_root)
    monkeypatch.setattr(run, "cache_env", lambda root: None)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 9), "--seconds", "0.2", "--trace", "0"])
    out = capsys.readouterr()
    if planted:
        assert rc != 0 and out.out == "" and "repro" in out.err
    else:
        assert rc == 0 and json.loads(out.out.strip().splitlines()[-1])["correct"] is True


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "reprox.core", sys)
    assert not {"repro_torch_like", "reprox"} & set(run.forbidden_loaded())
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert {"jaxlib", "repro"} <= set(run.forbidden_loaded())


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    """A whole run in a fresh interpreter: once it has closed, no loaded
    module's top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro``."""
    code = f"""
import sys
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
from portbench import manifest, run, traffic
root = __import__("pathlib").Path({str(tiny_root)!r})
for cell in {CELLS!r}:
    c = manifest.resolve(root, manifest.load(root), cell)
    run.run_cell(c, seed=5, seconds=0.1, trace=True, device="cpu", t0=0.0)
print(run.forbidden_loaded())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
