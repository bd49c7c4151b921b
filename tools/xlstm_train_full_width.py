"""xlstm-1.3b trained on the card at its published widths and depth.

    PYTHONPATH=src python tools/xlstm_train_full_width.py [--steps 2] [--layers 48]

xlstm-1.3b (arXiv:2405.04517; 1,665,014,096 parameters, 48 layers in 6
periods of 7 mLSTM and 1 sLSTM) through the port's entry points,
``train.steps.materialize_state`` and ``make_train_step``: bf16 compute
over f32 state, remat "full", ``slstm_kernel`` off (the train step refuses
it: the kernel has no backward, so the sLSTM runs its eager loop of 4,096
cell steps a layer, twice forward under the remat and once backward),
``AdamWConfig(lr=3e-3, warmup=5, decay_steps=10)`` and
``TokenStream(vocab, 2, 4,096, seed=0)``'s batch 0, under the
determinism of ``chip_smoke.py``'s train child (``CUBLAS_WORKSPACE_CONFIG``,
``torch.use_deterministic_algorithms``).  The checks are phase 33's
(``chip_smoke.arch_train``): ``--steps`` steps twice from seed 0,
bit-identical (losses, grad norms, every parameter), losses and grad
norms finite; the peak (``torch.cuda.max_memory_allocated``) within
``chip_smoke.DR_PEAK_RTOL`` of the committed one-card dry run of the same
cell, ``experiments/dryrun_torch/xlstm-1.3b__train_4k__b2.json``; ms
a step, tokens/s, and the device's idle share over the second run's last
step, traced with device events only.  In that traced step a spin kernel
marks each entry to and exit from the sLSTM loop, in both forwards and in
the backward, so the row also gives the loop's share of the step's device
events and busy time; the device events stand beside the record's
``n_ops``.

The published depth does not fit the card at 4 rows by the dry run's
count (``..._b4.json``: 85.03 GB).  One step at 4 rows is then tried
from a fresh state, and the tool records whether
it ran out of memory and what it tried to allocate, or, if it ran, its
peak against the card's capacity and the 4-row record.  ``--layers``
cuts the depth to whole periods (no record then: the peak is printed,
not held), for a short first check.

Prints the report lines, then one JSON line with all of it and the
card's name and power limit.  Needs the card; exits 1 without one, or
when a check fails.  About 15 minutes and 52 GB of the card at the
published depth.
"""

from __future__ import annotations

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before torch's first cuBLAS call

import argparse
import contextlib
import gc
import json
import re
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "xlstm-1.3b"
N_PARAMS = 1_665_014_096
RECORD = os.path.join(ROOT, "experiments", "dryrun_torch", ARCH + "__train_4k__b{rows}.json")
ROWS = 2  # rows of 4,096 tokens a step: 4 do not fit the card at 48 layers
PROBE_ROWS = 4


class _Marked(torch.autograd.Function):
    """The identity, whose backward launches a mark (a spin kernel) before
    it hands the gradients on."""

    @staticmethod
    def forward(ctx, *ts):
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        torch.cuda._sleep(1)
        return grads


@contextlib.contextmanager
def slstm_loop_marked():
    """Within it, each run of the sLSTM recurrence (``apply_slstm``'s
    ``recurrence``, reached through ``local_by_roles``) is bracketed by two
    marks on the device, forward and backward alike; the values are
    untouched."""
    from repro_torch.models import xlstm

    real = xlstm.local_by_roles

    def marked(fn, args, *roles):
        if fn.__name__ != "recurrence":
            return real(fn, args, *roles)
        args = _Marked.apply(*args)  # its backward runs last of the loop's: the backward's closing mark
        torch.cuda._sleep(1)
        out = real(fn, args, *roles)
        torch.cuda._sleep(1)
        return _Marked.apply(*out)  # its backward runs first: the backward's opening mark

    xlstm.local_by_roles = marked
    try:
        yield
    finally:
        xlstm.local_by_roles = real


def four_rows(cs, dev, opt, cfg) -> dict:
    """One step at PROBE_ROWS rows from a fresh state: whether it ran out of
    memory, what it tried to allocate, or its peak and ms."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.train import steps

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free, total = torch.cuda.mem_get_info()
    batch = {k: torch.from_numpy(v).long().to(dev)
             for k, v in TokenStream(vocab=cfg.vocab, global_batch=PROBE_ROWS, seq_len=cs.TR_SEQ,
                                     seed=0).batch_at(0).items()}
    out = {"rows": PROBE_ROWS, "layers": cfg.n_layers, "free_bytes_before": free, "capacity_bytes": total}
    holder = {"state": steps.materialize_state(cfg, torch.Generator(device=dev).manual_seed(0), dev)}
    step = steps.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        holder["state"], met = step(holder["state"], batch)
        torch.cuda.synchronize()
        out.update(fits=True, step_ms=(time.perf_counter() - t0) * 1e3, loss=float(met["loss"]))
    except torch.cuda.OutOfMemoryError as e:
        msg = str(e)
        tried = re.search(r"Tried to allocate ([0-9.]+ [KMGT]?i?B)", msg)
        out.update(fits=False, after_s=time.perf_counter() - t0, tried_to_allocate=tried.group(1) if tried else None,
                   message=msg[:800])
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["reserved_peak_bytes"] = torch.cuda.max_memory_reserved()
    del holder, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2, help="steps a run (two runs)")
    ap.add_argument("--layers", type=int, default=0, help="cut to this many layers (0: the published 48)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this tool trains on the CUDA card", flush=True)
        sys.exit(1)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.optim.adamw import AdamWConfig

    cs.check("jax" not in sys.modules and not any(m == "repro" or m.startswith("repro.") for m in sys.modules),
             "the tool imported jax or the JAX package")
    card = cs.card_line()
    cs.log(f"[xlstm full width] {card}")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False  # as the train child runs
    dev = torch.device(cs.DEVICE)
    opt = AdamWConfig(**cs.TR_OPT)
    layers = args.layers or None
    record = None if layers else RECORD.format(rows=ROWS)
    t0 = time.perf_counter()
    row = cs.arch_train(dev, opt, ARCH, N_PARAMS, args.steps, layers=layers, rows=ROWS, record=record, f32=False,
                        traced_with=slstm_loop_marked)
    mk = row["marked"]
    cfg = configs.get(ARCH).scaled(n_layers=row["layers"])
    n_slstm = cfg.blocks().count("slstm")
    cs.check(mk["windows"] == 3 * n_slstm,
             f"{mk['windows']} marked windows in the traced step, want 3 a sLSTM layer ({n_slstm} layers)")
    ops = f"; the dry run counted {row['dryrun_n_ops']:,} aten ops" if "dryrun_n_ops" in row else ""
    cs.log(f"[xlstm full width] {ARCH} ({row['layers']} layers, {ROWS} x {cs.TR_SEQ} tokens): "
           f"{row['median_step_ms']:.1f} ms a step, {row['tokens_per_s']:,.1f} tokens/s, device idle "
           f"{row['device_idle_share']:.4f}; the traced step {row['traced_step_ms']:.1f} ms, "
           f"{row['device_events']:,} device events{ops}; the sLSTM loop ({mk['windows']} windows: {n_slstm} layers, "
           f"two forwards and the backward each) {mk['device_events']:,} of them ({mk['share_of_events']:.4f}), "
           f"{mk['device_busy_ms']:.1f} ms of {row['device_busy_ms']:.1f} ms busy ({mk['share_of_device_busy']:.4f}), "
           f"its windows {mk['window_ms']:.1f} ms of the step; {card}")
    report = {"card": card, "arch": ARCH, "train": {k: v for k, v in row.items() if k != "device_top"},
              "device_top": row["device_top"]}
    probe = four_rows(cs, dev, opt, cfg)
    if not layers:
        with open(RECORD.format(rows=PROBE_ROWS)) as f:
            probe["peak_est_bytes"] = json.load(f)["memory"]["peak_est_bytes"]
    if probe["fits"]:
        what = (f"it ran: {probe['step_ms']:.1f} ms, peak {probe['peak_bytes']:,} B, "
                f"{probe['capacity_bytes'] - probe['peak_bytes']:,} B under the card's capacity")
    else:
        what = (f"out of memory after {probe['after_s']:.1f} s, tried to allocate {probe['tried_to_allocate']} "
                f"at a peak of {probe['peak_bytes']:,} B allocated")
    est = f", the 4-row record's estimate {probe['peak_est_bytes']:,} B" if "peak_est_bytes" in probe else ""
    cs.log(f"[xlstm full width] one step at {PROBE_ROWS} rows ({probe['layers']} layers): {what}; capacity "
           f"{probe['capacity_bytes']:,} B{est}; {card}")
    report["four_rows"] = probe
    report["tool_s"] = time.perf_counter() - t0
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
