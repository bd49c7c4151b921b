"""The benchmark's own tests: on the CPU at tiny widths (``tiny_root``), and
on the card where a test is marked ``cuda`` (it decides inside the test
whether there is one).  Run from the root of the checkout:

    python -m pytest -q portbench/tests
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the tiny widths every cell is rehearsed at on the CPU: the layer pattern,
# the norms, the head and the paths of the published configuration kept
TINY = {"d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16, "vocab": 512}
TINY_LAYERS = {"stablelm-1.6b": 2}
TINY_MIX = {"batch": 2, "seq_len": 24}


def tiny_config(name: str) -> dict:
    with open(REPO / "portbench" / "configs" / f"{name}.json") as f:
        c = json.load(f)
    m = c["model"]
    m.update(TINY, n_layers=TINY_LAYERS[name], dtype="float32", remat="none")
    if m.get("d_ff"):
        m["d_ff"] = 128
    return c


def make_tiny_root(dest: Path) -> Path:
    """A copy of the benchmark at tiny widths under ``dest``: the same
    files, with every configuration cut and every mix shortened."""
    shutil.copytree(REPO / "portbench", dest / "portbench", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (dest / "portbench" / "configs").glob("*.json"):
        path.write_text(json.dumps(tiny_config(path.stem), indent=1))
    for path in (dest / "portbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(TINY_MIX)
        path.write_text(json.dumps(mix, indent=1))
    return dest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)


@pytest.fixture
def card():
    """Skip unless a CUDA card is present; decided inside the test."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
