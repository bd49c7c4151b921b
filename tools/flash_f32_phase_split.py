"""Where one launch of the float32 flash-attention kernel spends its time, on a CUDA card.

    PYTHONPATH=src python tools/flash_f32_phase_split.py [--seq 8192] [--heads 8] [--kv-heads 4] [--dh 256]

At gemma2-2b's float32 scoring launches by default (B 1, S 8,192, H 8,
Kv 4, Dh 256, causal, softcap 50): the full layer (no window) and the
window layer (window 4,096), on seeded random inputs.  Builds the kernels
and prints the ptxas report of the float32 kernel (registers, spills, for
the path's build and the timed one); then, at each shape, runs the kernel
(``csrc/flash_attention.cu``) and its timed build
(``csrc/flash_attention_timed.cu``) on the same inputs, checks that the
two give the same bits and that the kernel agrees with the plain version
normwise within chip_smoke's SMOKE_FLASH_TOL, times each with
``chip_smoke.median_ms`` (median of 10), and prints one JSON line: the
card, the ptxas report, and at each shape the two times, the bound and the
timed build's split by phase (``ops.flash_phase_split``: each phase's share
of the cycles thread 0 of every CTA counted, and that share of the timed
launch's ms).  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

CAP = 50.0  # gemma2-2b's attention softcap
WINDOW = 4096  # its sliding-window layers


def split(q, k, v, window: int) -> dict:
    """The kernel's and the timed build's ms on these inputs, the bound, the
    error against the plain version and the timed build's phase split;
    raises if the two builds' bits differ or a check fails."""
    out = ops.flash_attention(q, k, v, causal=True, window=window, cap=CAP)
    t_out, cycles = ops.flash_attention_phase_cycles(q, k, v, causal=True, window=window, cap=CAP)
    torch.cuda.synchronize()
    if not torch.equal(out, t_out):
        raise AssertionError("the timed build gives other bits than the kernel")
    if not bool((cycles.sum(1) > 0).all()):
        raise AssertionError("a CTA's phase timers stayed at 0")
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window, cap=CAP).double()
    err = (out.double() - want).abs()
    normwise = float(torch.linalg.vector_norm(err) / torch.linalg.vector_norm(want))
    if not normwise <= chip_smoke.SMOKE_FLASH_TOL:
        raise AssertionError(f"the kernel differs from the plain version: normwise {normwise:.3g}")
    max_err = float(err.max())
    del want, err, t_out
    ms = chip_smoke.median_ms(lambda: ops.flash_attention(q, k, v, causal=True, window=window, cap=CAP), reps=10)
    timed_ms = chip_smoke.median_ms(
        lambda: ops.flash_attention_phase_cycles(q, k, v, causal=True, window=window, cap=CAP), reps=10)
    _, cycles = ops.flash_attention_phase_cycles(q, k, v, causal=True, window=window, cap=CAP)
    torch.cuda.synchronize()
    t_bytes, t_ops, _, _, flop = chip_smoke.flash_bound(q, k, v, window, CAP, chip_smoke.FP32_FLOPS_PER_S)
    return {"ms": ms, "bound_ms": max(t_bytes, t_ops), "share_of_bound": max(t_bytes, t_ops) / ms,
            "tflops": flop / ms / 1e9, "max_abs_err": max_err, "normwise_err": normwise,
            **ops.flash_phase_split(cycles, timed_ms)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--dh", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card: the kernel has no CPU mode")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    logs = _build.build_all()
    ptxas = {name: chip_smoke.ptxas_report(logs[name]) for name in ("flash_attention", "flash_attention_timed")
             if name in logs}
    gen = torch.Generator().manual_seed(0)
    b, s, h, kvh, dh = args.batch, args.seq, args.heads, args.kv_heads, args.dh
    q, k, v = (torch.randn((b, s, n, dh), generator=gen).cuda() for n in (h, kvh, kvh))
    out = {"shape": {"B": b, "S": s, "H": h, "Kv": kvh, "Dh": dh, "causal": True, "cap": CAP}, "card": card,
           "ptxas": ptxas}
    for name, window in (("full", 0), ("window", WINDOW)):
        out[name] = {"window": window, **split(q, k, v, window)}
    print(json.dumps({"flash_f32_phase_split": out}), flush=True)


if __name__ == "__main__":
    main()
