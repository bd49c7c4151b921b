"""Where one launch of the sLSTM scan kernel spends its steps, on a CUDA card.

    PYTHONPATH=src python tools/slstm_phase_split.py [--batch 8] [--seq 4096] [--heads 4] [--p 512] [--dtype bf16]

At xlstm-1.3b's prefill launch shape by default (B 8, S 4,096, H 4,
P 512, bfloat16 wx, float32 R), on seeded random inputs: builds the
kernels, runs the kernel (``csrc/slstm_scan.cu``) and its timed build
(``csrc/slstm_scan_timed.cu``) on the same inputs, checks that the two give
the same bits and that both agree with the plain version, times each with
CUDA events (median of 10), and prints one JSON line: the card, the
untimed and timed ms a launch and µs a step, and the timed build's split
by phase (``ops.slstm_phase_split``: µs a step of each phase, the mean over
CTAs, and the spread of the wait over CTAs).  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.kernels import _build, ops, ref  # noqa: E402

# chip_smoke.py's sLSTM bounds against the plain version
F32_RTOL, BF16_RTOL, ATOL = 1e-4, 2.0**-7, 1e-5


def inputs(gen, b, s, h, p, dtype, dev):
    """chip_smoke.py's sLSTM inputs: R scaled 1/sqrt(P), a non-zero state."""
    wx = (torch.randn((b, s, h, 4 * p), generator=gen) * 0.5).to(dtype)
    r = torch.randn((h, p, 4 * p), generator=gen) / p**0.5
    bias = torch.randn((h, 4 * p), generator=gen) * 0.1
    c0 = torch.randn((b, h, p), generator=gen).to(dtype)
    n0 = (torch.rand((b, h, p), generator=gen) + 0.5).to(dtype)
    h0 = (torch.randn((b, h, p), generator=gen) * 0.5).to(dtype)
    return [t.to(dev) for t in (wx, r, bias, c0, n0, h0)]


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def split(wx, r, bias, state0) -> dict:
    """The timed build's phase split of one launch on these inputs, its
    time and the untimed kernel's; raises if the two builds' bits differ."""
    hids, state = ops.slstm_scan(wx, r, bias, state0)
    t_hids, t_state, cycles = ops.slstm_scan_phase_cycles(wx, r, bias, state0)
    torch.cuda.synchronize()
    if not (torch.equal(hids, t_hids) and all(torch.equal(a, b) for a, b in zip(state, t_state))):
        raise AssertionError("the timed build gives other bits than the kernel")
    if not bool((cycles > 0).all()):
        raise AssertionError(f"a phase timer stayed at 0: {cycles.min(0).values.tolist()}")
    s = wx.shape[1]
    ms = median_ms(lambda: ops.slstm_scan(wx, r, bias, state0))
    timed_ms = median_ms(lambda: ops.slstm_scan_phase_cycles(wx, r, bias, state0))
    _, _, cycles = ops.slstm_scan_phase_cycles(wx, r, bias, state0)
    torch.cuda.synchronize()
    out = {"ms": ms, "us_per_step": ms * 1e3 / s, "timed_ms": timed_ms}
    out.update(ops.slstm_phase_split(cycles, s, timed_ms))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--p", type=int, default=512)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card: the kernel has no CPU mode")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    for name, log in _build.build_all().items():
        for line in log.splitlines():
            if name.startswith("slstm") and ("registers" in line or "spill" in line):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    wx, r, bias, c0, n0, h0 = inputs(torch.Generator().manual_seed(0), args.batch, args.seq, args.heads,
                                     args.p, dtype, torch.device("cuda"))
    hids, state = ops.slstm_scan(wx, r, bias, (c0, n0, h0))
    rh, rstate = ref.slstm_scan_ref(wx, r, bias, (c0, n0, h0))
    rtol = BF16_RTOL if dtype == torch.bfloat16 else F32_RTOL
    err = 0.0
    for got, want in [(hids, rh), *zip(state, rstate)]:
        d = (got.double() - want.double()).abs()
        err = max(err, float(d.max()))
        if not bool((d <= ATOL + rtol * want.double().abs()).all()):
            raise AssertionError(f"the kernel differs from the plain version (max {float(d.max()):.3g})")
    del rh, rstate
    out = {"shape": {"B": args.batch, "S": args.seq, "H": args.heads, "P": args.p, "dtype": str(dtype)},
           "max_abs_err": err, **split(wx, r, bias, (c0, n0, h0)), "card": card}
    print(json.dumps({"slstm_phase_split": out}), flush=True)


if __name__ == "__main__":
    main()
