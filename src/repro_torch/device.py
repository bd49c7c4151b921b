"""Where the port's entry points run: on the card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card; on a host without one that is an
    error, and the caller has to ask for the CPU by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
