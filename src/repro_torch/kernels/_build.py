"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into ``build/repro_torch_kernels/lib<name>-<hash>.so`` at
the root of the checkout (``build/`` is git-ignored), or into the
directory ``$REPRO_TORCH_BUILD_DIR`` names.  An installed package has no
checkout around it and must be given that variable.  The file name
carries a hash of the source, of every ``csrc/*.cuh`` it includes and of
the flags, so an edited source or header is rebuilt and a built one is
reused.  Nothing here runs at import time: a host
without ``nvcc`` imports the package and uses the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR`` if set, else ``build/repro_torch_kernels``
    at the root of the checkout whose ``src/`` holds this package."""
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env)
    here = Path(__file__).resolve()
    root = here.parents[3]
    if here.parents[2].name != "src" or not (root / "pyproject.toml").is_file():
        raise RuntimeError(
            f"repro_torch is not imported from a checkout's src/ ({here.parents[1]}); "
            f"set {BUILD_DIR_ENV} to the directory the CUDA kernels should be built into"
        )
    return root / "build" / "repro_torch_kernels"


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, directly or
    through another header, each once, in the order first reached."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())]
    return out


def source_hash(name: str) -> str:
    """The 12 hex digits that name ``csrc/<name>.cu``'s library: a hash of
    the source, of every header it includes and of the flags.  Anything
    keyed by it (the autotuner's tuned entries) is keyed by the kernel's
    exact build."""
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _target(name: str) -> Path:
    return build_dir() / f"lib{name}-{source_hash(name)}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start one nvcc for ``csrc/<name>.cu`` unless its library exists."""
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` that is not built yet, one nvcc process
    per source, all started together.  Returns the ptxas report of each
    source built by this call (registers, shared memory, spills)."""
    started = {}
    for src in sorted(CSRC.glob("*.cu")):
        job = _start(src.stem)
        if job is not None:
            started[src.stem] = job
    logs = {}
    for name, (proc, tmp, out) in started.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{logs[name]}")
        tmp.replace(out)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build_all()
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib
