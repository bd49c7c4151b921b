"""Per-device FLOPs of the five dense attention archs' train step (BASELINE), sharded on a
(pod 2, data 2, model 2) mesh at batch 8 x 32 tokens: the port's step on
a fake 8-rank group (``launch.dryrun.count_cell``) within 5% of
``analyze_hlo`` of the JAX package's sharded compile on 8 host devices
(Auto mesh axes), the two counted side by side in processes of their
own (``torch_sharded_cells``)."""

import pytest

from torch_sharded_cells import check_cell, count_both

CELLS = [(a, "train", False) for a in ("phi-3-vision-4.2b", "phi3-mini-3.8b", "granite-20b", "stablelm-1.6b", "gemma2-2b")]


@pytest.fixture(scope="module")
def counts():
    return count_both([list(c) for c in CELLS])


@pytest.mark.parametrize("arch,kind,gridlocal", CELLS)
def test_flops_per_device_match_jax_sharded_compile(arch, kind, gridlocal, counts):
    check_cell(*counts, (arch, kind, gridlocal))
