"""Per-device FLOPs of prefill and decode of gemma2, xlstm and seamless (BASELINE), sharded on a
(pod 2, data 2, model 2) mesh at batch 8 x 32 tokens: the port's step on
a fake 8-rank group (``launch.dryrun.count_cell``) within 5% of
``analyze_hlo`` of the JAX package's sharded compile on 8 host devices
(Auto mesh axes), the two counted side by side in processes of their
own (``torch_sharded_cells``)."""

import pytest

from torch_sharded_cells import check_cell, count_both

CELLS = [(a, k, False) for a in ("gemma2-2b", "xlstm-1.3b", "seamless-m4t-large-v2") for k in ("prefill", "decode")]


@pytest.fixture(scope="module")
def counts():
    return count_both([list(c) for c in CELLS])


@pytest.mark.parametrize("arch,kind,gridlocal", CELLS)
def test_flops_per_device_match_jax_sharded_compile(arch, kind, gridlocal, counts):
    check_cell(*counts, (arch, kind, gridlocal))
