"""What the language-model entries share: the program's configuration
built from a configuration file, the benchmark's weights loaded into the
program's ``Model``, and a batch moved to the device.  The program is
imported inside these functions, never when the module is."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench import weights


def model_config(config: dict, flags: dict | None = None):
    """``repro_torch``'s ``ModelConfig`` of a configuration file's
    ``model`` keys and a mix's path ``flags`` (``flash_kernel``); a key
    the program does not know is refused."""
    from repro_torch.models.config import ModelConfig

    known = {f.name for f in dataclasses.fields(ModelConfig)}
    keys = {**config["model"], **(flags or {})}
    unknown = sorted(set(keys) - known)
    if unknown:
        raise KeyError(f"{config['name']}: the program's ModelConfig has no {unknown}")
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in keys.items()})


def load_model(cfg, flat: dict[str, torch.Tensor], device):
    """The program's ``Model`` holding ``flat`` (dotted names, the weights
    as made, not copied); refuses a name set that is not the model's."""
    from repro_torch.models import transformer as T

    model = T.Model(cfg, params=weights.nest(flat), device=device)
    have = {n for n, _ in model.named_parameters()}
    if have != set(flat):
        raise KeyError(f"the reference's weights {sorted(set(flat) ^ have)[:6]} are not the program's")
    return model


def on_device(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=False) for k, v in batch.items()}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in float64 (inf where the shapes differ)."""
    if a.shape != b.shape:
        return float("inf")
    a, b = a.double(), b.double()
    return float((a - b).norm() / torch.clamp(b.norm(), min=1e-300))


def rows_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The worst row's ``rel`` (rows the leading axis)."""
    if a.shape != b.shape:
        return float("inf")
    return worst(rel(a[i], b[i]) for i in range(b.shape[0]))


def worst(values) -> float:
    """The largest of ``values``; inf if one is not finite (a NaN never
    hides behind a smaller number)."""
    values = list(values)
    if not values or not all(math.isfinite(v) for v in values):
        return float("inf")
    return max(values)
