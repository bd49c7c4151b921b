"""A full-width save and resume through the training entry on the card.

    PYTHONPATH=src python tools/train_entry_full_width.py [--dir build/train_entry_full_width]

stablelm-1.6b at its published widths and depth (1,644,367,872
parameters) through ``repro_torch.launch.train`` on a one-rank NCCL mesh
(the one card), ``--ckpt-every`` above ``--steps`` so that only the last
step is saved: an unbroken ``--steps 2``, whose files are hashed and then
deleted; then ``--steps 1`` and ``--steps 2 --resume``.  The resumed
step-2 files must equal the unbroken ones bit for bit (SHA-256 of every
file; the manifests' keys, dtypes and shapes alike).  A save holds the
parameters and AdamW's two f32 moments, 3 x 1,644,367,872 x 4 B =
19,732,414,464 B of payload, plus the step and the ``.npy`` headers.

Before anything runs, the directory's file system must have ``NEED_BYTES``
free (two saves at once: the resumed run's step 1 and step 2); with less,
the tool prints the figure and exits 1 without running.  The run is
deterministic as ``chip_smoke.py``'s train child is
(``CUBLAS_WORKSPACE_CONFIG``, ``torch.use_deterministic_algorithms``).

For each save it prints the seconds of the state's copy to the host in
the JAX package's layout (``convert.state_to_reference``), of the
checkpointer's own host copy, and of the write (every ``.npy``, the
manifest and the rename), and the bytes on disk; for the resume, the
seconds of the restore.  Then one JSON line with all of it and the card's
name and power limit.  Needs the card; exits 1 without one, or when a
check fails.  The directory is removed at the end.
"""

from __future__ import annotations

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before torch's first cuBLAS call

import argparse
import concurrent.futures
import gc
import hashlib
import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "stablelm-1.6b"
N_PARAMS = 1_644_367_872
PAYLOAD_BYTES = 3 * N_PARAMS * 4  # the parameters and both moments in f32
NEED_BYTES = 2 * PAYLOAD_BYTES + 2 * 10**9  # two saves at once, and room to spare
ARGS = ["--arch", ARCH, "--ckpt-every", "100", "--device", "cuda"]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown card"


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 26):
            h.update(chunk)
    return h.hexdigest()


def step_files(directory: str, step: int) -> dict:
    """``{name: (bytes, sha256)}`` of a step's ``proc_00000`` files, and
    the manifest's keys under ``"manifest"``."""
    base = os.path.join(directory, f"step_{step:010d}")
    proc = os.path.join(base, "proc_00000")
    names = sorted(os.listdir(proc))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:  # hashlib releases the GIL on large reads
        digests = list(pool.map(lambda n: sha256(os.path.join(proc, n)), names))
    out = {n: (os.path.getsize(os.path.join(proc, n)), d) for n, d in zip(names, digests)}
    with open(os.path.join(base, "manifest.json")) as f:
        out["manifest"] = json.load(f)["keys"]
    return out


class Timed:
    """Seconds spent in the entry's saves and restores: wraps
    ``convert.state_to_reference`` (the host copy in the JAX layout),
    ``Checkpointer.save`` and ``_write`` (the write) and ``restore``."""

    def __init__(self, train, Checkpointer):
        self.mark: dict = {}
        wrap = self._wrap
        train.convert.state_to_reference = wrap(train.convert.state_to_reference, "to_host_s")
        Checkpointer.save = wrap(Checkpointer.save, "save_s")
        Checkpointer._write = wrap(Checkpointer._write, "write_s")
        Checkpointer.restore = wrap(Checkpointer.restore, "restore_s")

    def _wrap(self, fn, key):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.mark[key] = self.mark.get(key, 0.0) + time.perf_counter() - t0
            return out
        return timed

    def take(self) -> dict:
        m, self.mark = self.mark, {}
        if "save_s" in m:  # the checkpointer's own host copy: the save less its write
            m["copy_s"] = m["save_s"] - m.get("write_s", 0.0)
        return m


def run(train, timed, argv: list, label: str) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train.main(argv)
    torch.cuda.synchronize()
    out = {"run_s": time.perf_counter() - t0, **timed.take(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[full width] {label}: {json.dumps(out)}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=os.path.join(ROOT, "build", "train_entry_full_width"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this tool trains on the CUDA card")
    card = card_line()
    print(f"[full width] {card}", flush=True)
    os.makedirs(args.dir, exist_ok=True)
    free = shutil.disk_usage(args.dir).free
    print(f"[full width] {free:,} bytes free under {args.dir}, {NEED_BYTES:,} needed", flush=True)
    if free < NEED_BYTES:
        fail(f"{free:,} bytes free under {args.dir}: two saves of {PAYLOAD_BYTES:,} bytes need {NEED_BYTES:,}")

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    if T.param_count(configs.get(ARCH)) != N_PARAMS:
        fail(f"{ARCH}: {T.param_count(configs.get(ARCH))} parameters, want {N_PARAMS}")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    timed = Timed(train, Checkpointer)
    unbroken, resumed = os.path.join(args.dir, "unbroken"), os.path.join(args.dir, "resumed")
    report = {"card": card, "free_bytes": free, "payload_bytes": PAYLOAD_BYTES}
    try:
        report["unbroken"] = run(train, timed, [*ARGS, "--steps", "2", "--ckpt-dir", unbroken], "--steps 2")
        t0 = time.perf_counter()
        want = step_files(unbroken, 2)
        report["hash_s"] = time.perf_counter() - t0
        shutil.rmtree(unbroken)
        report["first"] = run(train, timed, [*ARGS, "--steps", "1", "--ckpt-dir", resumed], "--steps 1")
        report["resumed"] = run(train, timed, [*ARGS, "--steps", "2", "--resume", "--ckpt-dir", resumed],
                                "--steps 2 --resume")
        got = step_files(resumed, 2)
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    files = [n for n in want if n != "manifest"]
    report["files"] = len(files)
    report["file_bytes"] = sum(want[n][0] for n in files)
    report["manifest_payload_bytes"] = sum(math.prod(k["shape"]) * np.dtype(k["dtype"]).itemsize
                                           for k in want["manifest"])
    if got["manifest"] != want["manifest"]:
        fail("the resumed step 2's manifest differs from the unbroken one's")
    differ = [n for n in files if got.get(n) != want[n]]
    if sorted(got) != sorted(want) or differ:
        fail(f"the resumed step 2 differs from the unbroken one: {differ or sorted(set(got) ^ set(want))}")
    print(f"[full width] {ARCH}: step 2 resumed from step 1 equals unbroken bit for bit, {len(files)} .npy files, "
          f"{report['file_bytes']:,} bytes on disk, {report['manifest_payload_bytes']:,} of them the leaves' "
          f"payload; {card}",
          flush=True)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
