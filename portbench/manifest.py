"""``BENCHMARK.json`` read and resolved: a cell names its configuration and
its traffic mix; the mix names the entry that drives it; the
configuration names its plain reference; every metric is a file of its
own under ``metrics/``.  Everything is found by name, so a later cell, mix,
configuration or metric is a new file and a new entry, never an edit.

The layout under the benchmark's folder (``ROOT`` is the folder that holds
``BENCHMARK.json``):

  configs/<config>.json     the configuration as run, with its source
  traffic/<mix>.json        one mix's parameters; ``"entry"`` names its driver
  entries/<entry>.py        the driver of one entry point of the program
  reference/<arch>.py       a plain PyTorch reference of one architecture
  metrics/<metric>.py       one metric's reader: ``read(run) -> float | None``;
                            a metric split by its cells' end-to-end metric
                            (``mfu.train``, ``mfu.prompt``) falls back on
                            the reader of its first part (``mfu.py``)
  limits/<cell>.json        the limit of each number the cell compares
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]
    limits: dict
    folder: Path

    @property
    def entry(self) -> str:
        return self.mix["entry"]


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_of(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metrics that ``cell`` reports: an end-to-end
    metric unless its ``workloads`` leave the cell out; a per-layer one in
    the cells its ``workloads`` list, or else in every cell that reports
    the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


def resolve(root: Path, bench: dict, cell: str) -> Cell:
    """The cell named ``cell``, its configuration, mix and limits read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    folder = (root / conf["file"]).parent.parent
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(folder / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    with open(folder / "limits" / f"{cell}.json") as f:
        limits = json.load(f)
    e2e, per = metrics_of(bench, cell)
    return Cell(cell, config, mix, int(w["chips"]), e2e, per, limits, folder)


def entry_module(name: str):
    return importlib.import_module(f"portbench.entries.{name}")


def reference_module(arch: str):
    return importlib.import_module(f"portbench.reference.{arch}")


def metric_reader(folder: Path, name: str):
    """``read`` of ``metrics/<name>.py``, or where there is none of
    ``metrics/<the name's first part>.py`` (a metric's name may hold dots,
    so the file is loaded by its path)."""
    path = folder / "metrics" / f"{name}.py"
    if not path.exists():
        path = folder / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_').replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(bench: dict) -> list[str]:
    """What in ``bench`` breaks the manifest's rules of names, units and
    references between its entries (empty when nothing does)."""
    out = []
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            n = e["name"]
            if not NAME.match(n):
                out.append(f"{group}: bad name {n!r}")
            key = "metric" if group in ("end_to_end", "per_layer") else group
            if (key, n) in seen:
                out.append(f"{group}: {n!r} twice")
            seen.add((key, n))
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better is {m['better']!r}")
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source {m['source']!r}")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"{m['name']}: unknown cell {c!r}")
    for m in bench["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: an end-to-end metric from {m['source']}")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves unknown {m['moves']!r}")
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']!r}")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"{w['name']}: config and traffic twice")
        pairs.add((w["config"], w["traffic"]))
        per_cell = metrics_of(bench, w["name"])
        reported = {m["name"] for m in per_cell[0]}
        if "setup_s" not in reported or len(reported) < 2 or not per_cell[1]:
            out.append(f"{w['name']}: reports {sorted(reported)} end to end and {len(per_cell[1])} per layer")
        for m in per_cell[1]:
            if m["moves"] not in reported:
                out.append(f"{w['name']}: {m['name']} moves {m['moves']}, which the cell does not report")
    return out
