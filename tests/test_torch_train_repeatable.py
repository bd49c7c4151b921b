"""gemma2-2b, zamba2-1.2b and xlstm-1.3b train steps repeat bit for bit,
and their one-card dry runs count alike on fake CUDA and CPU tensors.

``chip_smoke.py`` phase 33 trains the three archs at their published
widths on the card (xlstm-1.3b at one period of its pattern, 8 layers),
twice from one seed under deterministic algorithms, and holds the two
runs bit for bit.  Here the same steps run at the reduced
width on the CPU: in bfloat16 with remat "full", as the card runs them,
and in float32 without remat, 2 steps of ``TokenStream(vocab, 4, 64,
seed=0)``'s batches twice from ``materialize_state``'s seed 0; the
losses, the grad norms, every parameter and both AdamW moments must be
the same bits.  Phase 33 holds the measured peaks of gemma2-2b and
zamba2-1.2b to the dry run's estimate in
``experiments/dryrun_torch/<arch>__train_4k__b4.json``, counted on fake
CPU tensors; xlstm-1.3b's record of that cell is the count that shows its
published depth does not fit one card at 4 rows, so
``tools/xlstm_train_full_width.py`` trains it at 2 rows, held to
``experiments/dryrun_torch/xlstm-1.3b__train_4k__b2.json``.  The ``cuda``
case counts the 4-row cell on fake CUDA tensors with the phase's
optimiser and requires the same peak, FLOPs and bytes (xlstm-1.3b's count
walks its sLSTM's 4,096 steps a layer: about 23 minutes of host time).
"""

import json
import math
import os

import pytest
import torch

from repro_torch import configs
from repro_torch.data.pipeline import TokenStream
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import steps

ARCHS = ("gemma2-2b", "zamba2-1.2b", "xlstm-1.3b")
OPT = AdamWConfig(lr=3e-3, warmup=5, decay_steps=10)  # chip_smoke.py's TR_OPT
BATCH, SEQ, STEPS = 4, 64, 2
RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "experiments", "dryrun_torch",
                      "{arch}__train_4k__b{rows}.json")
FULL_DEPTH_ROWS = 2  # tools/xlstm_train_full_width.py's rows a step


def bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def train_twice_is_one_run(cfg) -> None:
    runs = []
    for _ in range(2):
        state = steps.materialize_state(cfg, torch.Generator().manual_seed(0), "cpu")
        step = steps.make_train_step(cfg, OPT, loss_chunk=SEQ)
        stream = TokenStream(vocab=cfg.vocab, global_batch=BATCH, seq_len=SEQ, seed=0)
        mets = []
        for s in range(STEPS):
            state, met = step(state, {k: torch.from_numpy(v).long() for k, v in stream.batch_at(s).items()})
            mets.append((float(met["loss"]), float(met["grad_norm"])))
        leaves = {**{f"p/{k}": v for k, v in steps.named_params(cfg, state["params"]).items()},
                  **{f"m/{k}": v for k, v in state["opt"]["m"].items()},
                  **{f"v/{k}": v for k, v in state["opt"]["v"].items()}}
        runs.append((mets, leaves))
    (m1, l1), (m2, l2) = runs
    assert m1 == m2 and all(math.isfinite(v) for pair in m1 for v in pair)
    assert l1.keys() == l2.keys()
    for k in l1:
        assert torch.equal(bits(l1[k]), bits(l2[k])), k


@pytest.mark.parametrize("dtype,remat", [("bfloat16", "full"), ("float32", "none")])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_runs_from_one_seed_are_bit_identical(arch, dtype, remat):
    cfg = configs.reduced(configs.get(arch)).scaled(dtype=dtype, remat=remat)
    was, threads = torch.are_deterministic_algorithms_enabled(), torch.get_num_threads()
    torch.use_deterministic_algorithms(True)  # as phase 33's process runs
    torch.set_num_threads(1)  # thousands of tiny ops: a thread pool only waits on itself beside other workers
    try:
        train_twice_is_one_run(cfg)
    finally:
        torch.use_deterministic_algorithms(was)
        torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_committed_records_are_phase_33s_cell(arch):
    """The records phase 33 reads are the one-card train_4k cell at 4 rows,
    grad_accum 1, of the published config."""
    hold_record(arch, BATCH)


def test_the_committed_2_row_record_is_the_full_depth_tools_cell():
    """The record tools/xlstm_train_full_width.py holds its measured peak
    to: xlstm-1.3b's one-card train_4k cell at 2 rows, grad_accum 1, of the
    published config."""
    hold_record("xlstm-1.3b", FULL_DEPTH_ROWS)


def hold_record(arch: str, rows: int) -> None:
    with open(RECORD.format(arch=arch, rows=rows)) as f:
        rec = json.load(f)
    from repro_torch.models import transformer as T

    assert (rec["arch"], rec["kind"], rec["global_batch"], rec["seq_len"], rec["grad_accum"], rec["mesh"]) == \
        (arch, "train", rows, 4096, 1, "1")
    assert rec["n_params"] == T.param_count(configs.get(arch)) and rec["device"] == "cpu"
    assert rec["memory"]["peak_est_bytes"] > rec["memory"]["state_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_dry_run_of_phase_33s_cell_counts_as_the_record(arch):
    """On fake CUDA tensors, with phase 33's optimiser, the cell's count
    equals the committed record's, counted on fake CPU tensors: the peak
    phase 33 holds its measurement to, the FLOPs and the bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fake tensors are CUDA tensors")
    from repro_torch.launch import dryrun

    with open(RECORD.format(arch=arch, rows=BATCH)) as f:
        rec = json.load(f)
    got = dryrun._run_cell_once(arch, dryrun.cell_shape("train_4k", BATCH), False, 1, "cuda", opt_cfg=OPT)
    assert got["memory"] == rec["memory"]
    assert (got["flops"], got["traffic_bytes"], got["n_ops"]) == (rec["flops"], rec["traffic_bytes"], rec["n_ops"])
