#!/usr/bin/env python3
"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port): one run of
one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the weights from the seed on the card, builds the program's
state and warms up every shape the cell uses (building the CUDA kernels in
the first run of a checkout; every cache of the program is kept at a fixed
path inside the checkout).  The window then drives the cell's entry in a
closed loop for ``--seconds`` seconds, each call ending in a synchronize.
With ``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiler trace of the window.  After the window the program's state is
dropped and the plain reference judges the program's outputs; the numbers
compared are printed beside their limits as the last lines of standard
error and under ``checks`` in the result.

The run refuses (exit code not 0, no result) without enough CUDA cards,
and when a module of JAX or of the JAX package is loaded once the window
has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root: Path) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a checkout's first run builds."""
    base = root / "build" / "portbench"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(base / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(base / "inductor")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(base / "kernels_nvrtc")
    os.environ["USE_FLAX"] = "0"


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    the names compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, t0: float) -> tuple[dict, dict]:
    """One run of ``cell``; returns (the result line, the compared numbers
    with their limits).  ``device`` is ``cuda``, or ``cpu`` in the tests."""
    import torch

    from portbench import manifest
    from portbench import trace as tr

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    entry = manifest.entry_module(cell.entry).Entry(cell, seed, device)
    s0 = time.perf_counter()
    entry.setup()
    sync()
    log(f"set-up: {s0 - t0!r} s to the entry (interpreter, imports), "
        f"{time.perf_counter() - s0!r} s the entry's (the CUDA context, weights, state, warm-up)")
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    times = []
    with tr.profiled(trace, cuda) as prof:
        with tr.window_mark():
            w0 = time.perf_counter()
            while not times or (time.perf_counter() - w0) + 0.5 * times[-1] < seconds:
                a = time.perf_counter()
                entry.call()
                sync()
                times.append(time.perf_counter() - a)
            window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if cuda else None
    launches = {k: v - before.get(k, 0) for k, v in ops.LAUNCHES.items()}
    card = power_limit() if cuda else None
    tread = tr.read(prof) if trace else None
    run = SimpleNamespace(cell=cell, model=cell.config["model"], mix=cell.mix, calls=len(times),
                          tokens=len(times) * entry.tokens_per_call, flops=len(times) * entry.flops_per_call,
                          window_s=window_s, call_s=times, setup_s=setup_s, peak_bytes=peak, trace=tread,
                          launches=launches, card=card)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.metric_reader(cell.folder, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            log(f"{m['name']} = {value!r} {m['unit']}" + (f"  [{card}]" if m["unit"] == "%" else ""))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak if peak is not None else 0}
    if card:
        dev["power"] = card
    result = {"correct": False, "attempted": len(times), "failed": 0, "metrics": metrics, "device": dev}
    if tread is not None:
        dev["busy_s"], dev["window_s"] = tread.busy_s, tread.window_s
        result["breakdown"] = {"device_ops": tread.top(), "idle_gaps": [list(g) for g in tread.gaps]}
    log(f"{cell.name}: {len(times)} calls in {window_s!r} s, set-up {setup_s!r} s, ms a call "
        f"{[round(t * 1e3, 3) for t in times]}, launches {({k: v for k, v in launches.items() if v})}")

    entry.close()
    del prof, tread, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    got = entry.program()
    numbers = entry.numbers(got, entry.reference("float32"))
    log(f"reference and comparison: {time.perf_counter() - r0!r} s")
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import manifest

    cell = manifest.resolve(ROOT, manifest.load(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    bad = forbidden_loaded()
    if bad:
        log(f"loaded at the start: {bad} (JAX or the JAX package)")
        return 3
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    # after the window, the readers, the reference and the comparison have
    # all run: the last moment anything could have loaded them
    bad = forbidden_loaded()
    if bad:
        log(f"loaded once the window closed: {bad} (JAX or the JAX package)")
        return 3
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
