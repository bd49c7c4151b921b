"""Seeded weights, made on the device by the benchmark and handed alike to
the program and to the reference.

A unit (one layer, or everything outside the layers) is one ``randn`` call
from a generator seeded by (seed, unit), sliced into its leaves: a matrix
is normal × min(0.02, 1/sqrt(fan_in)) (fan_in its second-to-last size), a
norm's scale ones and its bias zeros.  So the same seed gives the same
bits on one device however often the weights are made, and a unit can be
made again alone.
"""

from __future__ import annotations

import hashlib
import math

import torch


def derive(seed: int, *keys) -> int:
    """A 63-bit generator seed from ``seed`` (any size) and ``keys``."""
    h = hashlib.sha256(repr((int(seed), *keys)).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def unit_of(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "layers" else "top"


def make_unit(shapes: dict, unit: str, seed: int, device) -> dict[str, torch.Tensor]:
    """The leaves of ``unit`` (f32 on ``device``); ``shapes`` maps a leaf's
    dotted name to (shape, init), init ``normal``, ``ones`` or ``zeros``."""
    names = [n for n in shapes if unit_of(n) == unit]
    normal = [n for n in names if shapes[n][1] == "normal"]
    total = sum(math.prod(shapes[n][0]) for n in normal)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights", unit))
    flat = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, at = {}, 0
    for n in names:
        shape, init = shapes[n]
        if init == "ones":
            out[n] = torch.ones(shape, dtype=torch.float32, device=device)
        elif init == "zeros":
            out[n] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            size = math.prod(shape)
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            out[n] = flat[at:at + size].view(shape).mul_(min(0.02, 1.0 / math.sqrt(max(fan_in, 1))))
            at += size
    return out


def units(shapes: dict) -> list[str]:
    seen: dict[str, None] = {}
    for n in shapes:
        seen.setdefault(unit_of(n))
    return list(seen)


def make(shapes: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every leaf of ``shapes``, unit by unit."""
    out = {}
    for u in units(shapes):
        out.update(make_unit(shapes, u, seed, device))
    return out


def nest(flat: dict[str, torch.Tensor]) -> dict:
    """Dotted names to the nested dict the program's ``Model`` takes: a
    ``layers.<i>`` prefix becomes the i-th entry of a list."""
    out: dict = {}
    for name, t in flat.items():
        node, parts = out, name.split(".")
        for i, key in enumerate(parts[:-1]):
            if key == "layers":
                continue
            if i > 0 and parts[i - 1] == "layers":
                lst = node.setdefault("layers", [])
                idx = int(key)
                while len(lst) <= idx:
                    lst.append({})
                node = lst[idx]
            else:
                node = node.setdefault(key, {})
        node[parts[-1]] = t
    return out
