"""Architecture registry of the port.

``get(name)`` returns the full published config of an architecture the
port can run; ``reduced(get(name))`` gives the CPU-test version.  The
names are the JAX package's (``repro.configs.ARCHS``), and the port runs
every one of them: with the encoder-decoder (seamless) and the patch
frontend (phi-3-vision) no architecture is queued, so ``get`` refuses
only an unknown name.
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
    "phi-3-vision-4.2b": "phi3_vision",
    "seamless-m4t-large-v2": "seamless",
}


def get(name: str) -> ModelConfig:
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[name]}")
    return mod.CONFIG
