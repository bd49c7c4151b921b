"""Shared machinery of the sharded-step tests that run on real gloo
groups of CPU processes: start ``n`` ranks of a child script, each with
the rendezvous on ``localhost`` and the inputs the parent wrote, and read
back what rank 0 wrote.  The parent holds the result to the JAX package."""

import os
import pickle
import socket
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

CHILD_HEAD = r"""
import os, sys, pickle, logging
logging.disable(logging.WARNING)
import torch
import torch.distributed as dist
from datetime import timedelta
torch.set_num_threads(1)
rank, world, port, data = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                        timeout=timedelta(seconds=120))
with open(os.path.join(data, "inputs.pkl"), "rb") as f:
    INPUTS = pickle.load(f)
RESULTS = {}
"""

CHILD_TAIL = r"""
with open(os.path.join(data, f"results_{rank}.pkl"), "wb") as f:
    pickle.dump(RESULTS, f)
dist.barrier()
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(body: str, inputs, tmp_path, n: int = 4, timeout: float = 140.0, every_rank: bool = False):
    """Run ``body`` (Python, between the child's head and tail) on ``n``
    gloo ranks with ``inputs`` pickled for them; returns rank 0's
    ``RESULTS`` (with ``every_rank``, the list of every rank's)."""
    data = str(tmp_path)
    with open(os.path.join(data, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    script = CHILD_HEAD + body + CHILD_TAIL
    port = free_port()
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(n), str(port), data],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(n)]
    errs = []
    try:
        for p in procs:
            _, se = p.communicate(timeout=timeout)
            if p.returncode:
                errs.append(se[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not errs, "\n----\n".join(errs)
    out = []
    for r in range(n):
        with open(os.path.join(data, f"results_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out if every_rank else out[0]
