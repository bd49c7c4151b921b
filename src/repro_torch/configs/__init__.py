"""Architecture registry of the port.

``get(name)`` returns the full published config of an architecture the
port can run; ``reduced(get(name))`` gives the CPU-test version.  The
names are the JAX package's (``repro.configs.ARCHS``).  An architecture
whose blocks the port cannot run yet raises ``NotImplementedError`` and
names the slice that brings them, rather than returning a config that
would fail deep inside the model.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced  # noqa: F401

ARCHS = [
    "phi-3-vision-4.2b",
    "phi3-mini-3.8b",
    "granite-20b",
    "stablelm-1.6b",
    "gemma2-2b",
    "zamba2-1.2b",
    "mixtral-8x22b",
    "deepseek-moe-16b",
    "xlstm-1.3b",
    "seamless-m4t-large-v2",
]

_MOD = {
    "phi3-mini-3.8b": "phi3_mini",
    "granite-20b": "granite",
    "stablelm-1.6b": "stablelm",
    "gemma2-2b": "gemma2",
    "zamba2-1.2b": "zamba2",
    "mixtral-8x22b": "mixtral",
    "deepseek-moe-16b": "deepseek_moe",
    "xlstm-1.3b": "xlstm_1b",
}

# what each architecture still waits for (ROADMAP.md, slice 7)
_QUEUED = {
    "phi-3-vision-4.2b": "the patch frontend (queued after the encoder-decoder)",
    "seamless-m4t-large-v2": "the encoder-decoder with cross-attention (queued next, after Mamba-2)",
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    if name not in _MOD:
        raise NotImplementedError(f"the port cannot run {name!r} yet: it needs {_QUEUED[name]}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[name]}")
    return mod.CONFIG
