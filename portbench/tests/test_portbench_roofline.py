"""The yardstick's counts against hand counts and the program's parameter
counts."""

from __future__ import annotations

import json

from conftest import REPO

from portbench import roofline as r
from portbench import weights


def _model(name):
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())["model"]


def test_dense_weights_are_the_parameters_less_embedding_and_norms():
    m = _model("stablelm-1.6b")
    w = r.dense_matmul_weights(m)
    norms = (2 * m["n_layers"] + 1) * 2 * m["d_model"]
    embed = 100352 * 2048
    assert w["layers"] + w["head"] + norms + embed == 1_644_367_872


def test_train_step_flops_by_hand():
    m = _model("stablelm-1.6b")
    tokens = 4 * 4096
    attn = 3 * 4 * 64 * (4096 * 4097 // 2) * 32 * 24 * 4
    assert r.train_step_flops(m, 4, 4096) == 6 * 1_438_646_272 * tokens + attn
    assert abs(attn / tokens / 1.21e9 - 1) < 0.01  # the issue's 1.21·10⁹ a token


def test_kernel_work_by_hand():
    # flash: B 1, S 2, H = Kv = 1, Dh 8, bf16: 3 causal pairs, q, k, v and out of 32 B each
    assert r.flash_work(1, 2, 1, 1, 8, 2) == (96, 128, r.BF16_FLOPS_PER_S)
    assert r.least_seconds(989e12, 0, r.BF16_FLOPS_PER_S) == 1.0
    assert r.least_seconds(0, 3.35e12, r.BF16_FLOPS_PER_S) == 1.0


def test_published_shapes_bound_as_measured_before():
    # chip_smoke's bound at the path's shape (PERF.md's kernel table): 0.278 ms
    assert abs(r.least_seconds(*r.flash_work(4, 4096, 32, 32, 64, 2)) * 1e3 - 0.2780) < 1e-3


def test_weights_are_the_seeds_alone():
    shapes = {"embed": ((8, 4), "normal"), "layers.0.ln.scale": ((4,), "ones"), "layers.0.w": ((4, 4), "normal")}
    a, b = weights.make(shapes, 2**40 + 1, "cpu"), weights.make(shapes, 2**40 + 1, "cpu")
    c = weights.make(shapes, 2**40 + 2, "cpu")
    assert all((a[k] == b[k]).all() for k in a) and not (a["layers.0.w"] == c["layers.0.w"]).all()
    assert (a["layers.0.ln.scale"] == 1).all()
    again = weights.make_unit(shapes, "layers.0", 2**40 + 1, "cpu")
    assert (again["layers.0.w"] == a["layers.0.w"]).all()
    assert weights.nest(a)["layers"][0]["ln"]["scale"] is a["layers.0.ln.scale"]
