"""``BENCHMARK.json`` against its contract, and every cell resolved by name
to its files; a configuration, a mix and a metric added as new files are
found without an edit to any file that is there."""

from __future__ import annotations

import json
import re

import pytest
from conftest import REPO, make_tiny_root

from portbench import manifest

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert not any(w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entry_keys(group):
    for e in BENCH[group]:
        extra = set(e) - KEYS[group] - ({"workloads"} if group in ("end_to_end", "per_layer") else set())
        assert KEYS[group] <= set(e) and not extra, (e["name"], extra)
        for k in ("why", "layer") + (("source",) if group == "configs" else ()):
            if k in e:
                assert LINE.match(e[k]), (e["name"], k)


def test_no_problems():
    assert manifest.problems(BENCH) == []


def test_bounds_and_chips():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"]) and four <= max(1, len(BENCH["workloads"]) // 4)


def test_paths_hold_only_the_benchmark():
    for p in BENCH["paths"]:
        assert (REPO / p).is_dir()
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])


WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|experts_per|_dim$|_rank$|d_model|d_ff)")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_reduced_names_no_width_and_each_key_is_in_the_file(config):
    """Every width and the published depth kept; a key changed from the
    source is listed in ``reduced`` and stated in the file as run."""
    c = {c["name"]: c for c in BENCH["configs"]}[config]
    held = json.loads((REPO / c["file"]).read_text())
    assert len(c["reduced"]) <= 16
    for k in c["reduced"]:
        assert manifest.NAME.match(k) and not WIDTH.search(k), k
        assert k in held or k in held["model"], k


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_every_file(cell):
    c = manifest.resolve(REPO, BENCH, cell)
    mod = manifest.entry_module(c.entry)
    assert hasattr(mod, "Entry")
    ref = manifest.reference_module(c.config["reference"])
    assert hasattr(ref, "param_shapes")
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.metric_reader(c.folder, m["name"]))
    assert c.limits and all(v > 0 for v in c.limits.values())


@pytest.mark.parametrize("config", sorted(p.stem for p in (REPO / "portbench" / "configs").glob("*.json")))
def test_configuration_is_the_programs(config):
    """The file holds the program's published configuration as it runs,
    key for key."""
    from repro_torch import configs

    held = json.loads((REPO / "portbench" / "configs" / f"{config}.json").read_text())
    assert held["name"] == config
    prog = configs.get(config)
    for k, v in held["model"].items():
        want = getattr(prog, k)
        assert (list(want) if isinstance(want, tuple) else want) == v, k


def test_new_config_mix_and_metric_are_found_as_new_files(tmp_path):
    """A cell, its configuration, its mix, its limits and a metric added as
    new files and new manifest entries run without an edit to any file the
    benchmark has."""
    root = make_tiny_root(tmp_path)
    folder = root / "portbench"
    before = {p: p.read_bytes() for p in folder.rglob("*") if p.is_file()}
    cfg = json.loads((folder / "configs" / "stablelm-1.6b.json").read_text())
    cfg["name"] = "stablelm-wide"
    cfg["model"]["d_ff"] = 192
    (folder / "configs" / "stablelm-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((folder / "traffic" / "score-4k.json").read_text())
    mix["batch"] = 3
    (folder / "traffic" / "score-3row.json").write_text(json.dumps(mix))
    (folder / "limits" / "stablelm-wide.score-3row.json").write_text(json.dumps({"hidden": 1e-4, "ce": 1e-4}))
    (folder / "metrics" / "calls.prompt.py").write_text("def read(run):\n    return float(run.calls)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stablelm-wide", "source": "https://example.org/wide",
                             "file": "portbench/configs/stablelm-wide.json", "reduced": ["d_ff"], "why": "a test"})
    bench["workloads"].append({"name": "stablelm-wide.score-3row", "config": "stablelm-wide",
                               "traffic": "score-3row", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "prompt_tokens_per_s":
            m["workloads"].append("stablelm-wide.score-3row")
    bench["per_layer"].append({"name": "calls.prompt", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "prompt step", "moves": "prompt_tokens_per_s",
                               "workloads": ["stablelm-wide.score-3row"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert manifest.problems(bench) == []

    from portbench import run

    cell = manifest.resolve(root, bench, "stablelm-wide.score-3row")
    result, _ = run.run_cell(cell, seed=2**40 + 3, seconds=0.2, trace=True, device="cpu", t0=0.0)
    assert result["correct"] and result["metrics"]["calls.prompt"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, p

