"""Fault-tolerant checkpointing, in the JAX package's layout on disk.

The port of ``repro.checkpoint.checkpointer``:

  * one ``.npy`` a leaf named by its tree path, whole, under
    ``proc_00000/`` (the directory of the JAX package's one process);
  * a manifest records the step and every leaf's key, dtype and shape in
    ``jax.tree`` order (dict keys sorted, list entries in order), so a
    step directory written by either package reads in the other;
  * atomic commit: writes go to ``step_<n>.tmp/`` and are renamed after
    the manifest is written, so a crash mid-write never corrupts the
    latest step; a step saved again keeps the committed copy;
  * async mode copies the leaves to host memory synchronously, then hands
    them to a writer thread, so the train loop overlaps the I/O; a write's
    error is raised by the next ``save`` or ``check``, or by a ``save``
    that waits;
  * retention keeps the newest ``keep`` steps (a restart uses the newest
    complete one, DAGMan's rescue-DAG semantics).

On a ``torch.distributed`` group of several ranks (the training entry's
data-parallel mesh, whose state is the same on every rank) each step is
committed once: rank 0 alone (``writer``) copies the state to the host,
writes it, the manifest, the rename and the retention; the other ranks
write nothing and read no ``state``.  The ranks share the directory's
file system.  No collective runs on the writer thread, where it would
race the step's collectives on the same group: ``save(..., wait=True)``
and ``restore`` end with a barrier, so every rank sees a committed step
before it calls ``latest_step``, ``all_steps`` or ``restore``, and every
rank restores ``proc_00000``.  So a step directory written by any number
of ranks is the JAX package's one-process layout, and restores on any
number.  With no group, or a group of one, no barrier runs.

A state is a tree of dicts and lists whose leaves are tensors, numpy
arrays or numbers; a train state goes through
``convert.state_to_reference`` first, and ``restore`` gives numpy leaves
in the structure of ``like`` (``convert.state_from_reference`` brings a
train state back onto a device).
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(key, leaf)`` in ``jax.tree`` order; keys join the path's dict
    keys and list indices with ``/``."""
    if isinstance(tree, Mapping):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten_with_paths(v, f"{prefix}/{k}" if prefix else k)
    return out


def _unflatten_like(like, leaves):
    """``like``'s structure with its leaves, in ``_flatten_with_paths``
    order, taken from the iterator ``leaves``."""
    if isinstance(like, Mapping):
        return {k: _unflatten_like(like[k], leaves) for k in sorted(like)}
    if isinstance(like, list):
        return [_unflatten_like(v, leaves) for v in like]
    return next(leaves)


def _host_copy(leaf) -> np.ndarray:
    """A numpy copy of the leaf that nothing else writes to."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


# the JAX package's process 0's directory: the one a step holds
PROC_DIR = "proc_00000"


def _group() -> tuple[int, int]:
    """(rank, ranks) of the default ``torch.distributed`` group; (0, 1)
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if _group()[1] > 1:
        dist.barrier()


WRITER_THREAD = "checkpoint-writer"  # the name of the async writer's thread


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3, async_mode: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_mode = async_mode
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save ---------------------------------------------------------------

    @property
    def writer(self) -> bool:
        """Whether this rank writes: rank 0 of the group, or the one process."""
        return _group()[0] == 0

    def save(self, step: int, state, wait: bool = False) -> None:
        """Snapshot ``state`` at ``step``; only the ``writer`` reads
        ``state`` (the other ranks may pass None).  With ``wait`` every rank
        returns once the step is committed, and the write's error is raised."""
        self.check()  # surface async failures from previous saves
        if self.writer:
            flat = [(k, _host_copy(v)) for k, v in _flatten_with_paths(state)]
            if self.async_mode:
                self.wait()
                self._thread = threading.Thread(target=self._write, args=(step, flat), daemon=True,
                                                name=WRITER_THREAD)
                self._thread.start()
                if wait:
                    self.wait()
            else:
                self._write(step, flat)
        if wait:
            _barrier()
            self.check()

    def _write(self, step: int, flat) -> None:
        try:
            tmp = self.dir / f"step_{step:010d}.tmp"
            final = self.dir / f"step_{step:010d}"
            shard_dir = tmp / PROC_DIR
            shard_dir.mkdir(parents=True, exist_ok=True)
            manifest = {"step": step, "time": time.time(), "keys": []}
            for key, arr in flat:
                np.save(shard_dir / (key.replace("/", "__") + ".npy"), arr)
                manifest["keys"].append({"key": key, "dtype": str(arr.dtype), "shape": list(arr.shape)})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():  # same step re-saved: keep the committed one
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                tmp.rename(final)  # atomic commit
            self._gc()
        except Exception as e:  # the writer thread's boundary: surfaced on the next save()/check()
            self._error = e

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def check(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err}") from err

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*") if not p.name.endswith(".tmp")
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None):
        """Restore into the structure of ``like`` (a tree whose leaves have
        a ``shape``: tensors, arrays or ``ShapeAxes`` specs), the latest
        step when ``step`` is None; every rank of a group reads the whole
        state and calls this.  Returns that tree with numpy leaves; the
        caller puts them on its device."""
        self.wait()
        self.check()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        shard_dir = self.dir / f"step_{step:010d}" / PROC_DIR
        leaves = []
        for key, leaf in _flatten_with_paths(like):
            arr = np.load(shard_dir / (key.replace("/", "__") + ".npy"))
            expect = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
            if tuple(arr.shape) != expect:
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs expected {expect}")
            leaves.append(arr)
        _barrier()  # no rank commits (and retires) a step while another still reads
        return _unflatten_like(like, iter(leaves))
