"""The parameter and cache leaf spec: a (shape, dtype, logical axes)
description of a tensor, and the dtype names it uses.  A module of its
own so that both the layers and the sharding rules import it."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class ShapeAxes:
    """A (shape, dtype, logical_axes) leaf that describes a parameter or a
    cache tensor without materialising it.  The port's copy of the JAX
    package's ``repro.sharding.ShapeAxes``; the axes name the leaf's role
    (``norm_scale``, ``layers``, ...) and place nothing."""

    shape: tuple[int, ...]
    dtype: str
    axes: tuple[str | None, ...] = field(default=())

    def __post_init__(self):
        if not self.axes:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def spec(shape, axes, dtype="float32") -> ShapeAxes:
    return ShapeAxes(shape=tuple(shape), dtype=dtype, axes=tuple(axes))


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16``, and so on."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
