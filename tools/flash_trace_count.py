"""Count the bf16 flash kernels that torch.profiler's trace holds for each of
several profiled gemma2-2b scoring runs (chip_smoke.py phase 16's run:
4 x 8,192 tokens, 26 launches a run), and print each trace's flash events.

    PYTHONPATH=src python tools/flash_trace_count.py [--traces 12] [--lead-ms 0,100]
        [--warm 0,300] [--noise 100000]

Builds gemma2-2b at its published widths on the card (seeded, as
chip_smoke.py phase 14 does), then profiles a scoring run ``--traces``
times, the traces taking the margins of ``--lead-ms`` in turn: the host
waits that long inside the profiler before the run starts and after it
ends, and the warm-ups of ``--warm`` in turn: that many spin kernels
(``torch.cuda._sleep``, which no path launches) run and are synchronised
inside the trace before the run, so the trace's spin events count how
many leading events it kept (chip_smoke.py leads each traced run with
``TRACE_WARMUP`` of them).
``--noise`` profiles that many tiny kernels in a trace of their own
before each scoring trace, as the earlier phases of chip_smoke.py profile
large runs in the same process.  One JSON line
a trace: the flash events in the trace (start from the first, duration,
CUPTI correlation id), the launches the wrapper counted, the trace's
device events, the spin events kept, and where the run's host window and
its first device event start after the trace's start; then a summary
line, by margin and warm-up.
Needs the card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = "flash_attention_wgmma_kernel"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traces", type=int, default=12)
    ap.add_argument("--lead-ms", default="0",
                    help="comma-separated host waits before and after the run, taken in turn")
    ap.add_argument("--warm", default="0", help="comma-separated spin kernels before the run, taken in turn")
    ap.add_argument("--noise", type=int, default=0, help="tiny kernels profiled before each scoring trace")
    args = ap.parse_args()
    leads = [float(v) for v in args.lead_ms.split(",")]
    warms = [int(v) for v in args.warm.split(",")]
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this tool profiles the flash kernel on the card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.train.losses import chunked_softmax_ce

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfg = get("gemma2-2b").scaled(flash_kernel=True)
    model = T.Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (cs.GM_BATCH, cs.GM_SEQ), generator=torch.Generator().manual_seed(1)).to(dev)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1

    def score():
        with torch.inference_mode():
            hidden, _ = T.forward_train(cfg, model, tokens, return_hidden=True)
            chunked_softmax_ce(cfg, model, hidden, labels, chunk=cs.GM_LOSS_CHUNK)
        torch.cuda.synchronize()

    score()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    counts = {}
    scratch = torch.zeros(1, device=dev)
    for i in range(args.traces):
        lead, warm = leads[i % len(leads)], warms[(i // len(leads)) % len(warms)]
        if args.noise:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                for _ in range(args.noise):
                    scratch.add_(1.0)
                torch.cuda.synchronize()
        ops.reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(lead / 1e3)
            for _ in range(warm):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function("scoring run"):
                score()
            wall = time.perf_counter() - t0
            time.sleep(lead / 1e3)
        res = prof.profiler.kineto_results
        t_start = res.trace_start_ns()
        events = [e for e in res.events() if e.device_type() == cuda and not e.is_user_annotation()]
        spins = sum("spin" in e.name() for e in events)
        events = [e for e in events if "spin" not in e.name()]
        window = [e.start_ns() for e in res.events() if e.device_type() == cpu and e.name() == "scoring run"]
        flash = sorted((e.start_ns(), e.duration_ns(), e.correlation_id()) for e in events if KERNEL in e.name())
        counts.setdefault(f"lead {lead} ms, warm {warm}", []).append(len(flash))
        print(json.dumps({
            "trace": i, "lead_ms": lead, "warm": warm, "spin_events": spins, "flash_events": len(flash),
            "launched": ops.LAUNCHES["flash_attention_wgmma"],
            "device_events": len(events), "flash_ms": sum(d for _, d, _ in flash) / 1e6, "wall_s": wall,
            "run_window_ms_after_trace_start": (window[0] - t_start) / 1e6 if window else None,
            "first_device_event_ms_after_trace_start": (min(e.start_ns() for e in events) - t_start) / 1e6,
            "events": [[(a - flash[0][0]) / 1e6, d / 1e6, c] for a, d, c in flash],
        }), flush=True)
    print(json.dumps({"traces": args.traces, "noise": args.noise, "flash_events": counts,
                      "short": {k: sum(c != cs.FLASH_LAUNCHES for c in v) for k, v in counts.items()},
                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
