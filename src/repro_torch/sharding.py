"""Logical-axis sharding rules: MaxText-style tables mapping the logical
axes that name every parameter, cache and input dim to mesh axes.

The port of ``repro.sharding``.  A rules table (swappable: the named
variants are in ``roofline.rule_variants``) maps each logical axis to mesh
axes; divisibility is checked dim by dim, and a mesh axis that does not
divide the dim is dropped rather than raising, so one table serves all ten
architectures.

The reference places arrays with ``jax.sharding.Mesh`` and
``NamedSharding``.  Here a mesh is described without devices by
``MeshShape`` (ordered axis names and sizes), which holds the production
meshes of 256 and 512 chips on a host with one card, as the JAX tests'
``abstract_mesh`` does.  A pspec is a plain tuple with the reference's
entries (``None``, an axis name, or a tuple of names) and its trailing
``None``s trimmed.  ``to_placements`` turns one into the
``torch.distributed.tensor`` placements of a ``DeviceMesh`` whose
``mesh_dim_names`` are the axes, the counterpart of ``NamedSharding``.

The reference's ``activate``/``constrain`` (activation constraints inside
a traced step) are not ported: no model of the port runs sharded.
"""

from __future__ import annotations

import math
from collections.abc import Mapping, Sequence
from dataclasses import dataclass

import torch

from repro_torch.models.layers import ShapeAxes, torch_dtype

# Mesh axis sets for supported rule values
AxisVal = tuple[str, ...] | str | None
# One pspec entry: replicated, one mesh axis, or several in sharding order
PSpecEntry = str | tuple[str, ...] | None


def _as_tuple(v: AxisVal) -> tuple[str, ...]:
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


@dataclass(frozen=True)
class Rules:
    """logical axis name -> mesh axes (in sharding order)."""

    table: Mapping[str, AxisVal]
    name: str = "rules"

    def lookup(self, logical: str) -> tuple[str, ...]:
        return _as_tuple(self.table.get(logical))


@dataclass(frozen=True)
class MeshShape:
    """A mesh without devices: axis names in mesh order and their sizes.
    ``shape`` maps name -> size as ``jax.sharding.Mesh.shape`` does."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} do not match sizes {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def tag(self) -> str:
        """``"16x16"``, ``"2x16x16"``: the reference's mesh names."""
        return "x".join(map(str, self.axis_sizes))


# ---------------------------------------------------------------------------
# Baseline rule tables
# ---------------------------------------------------------------------------

# Single-pod baseline: DP over `data` + FSDP over `data` for weights,
# TP over `model` for heads / mlp / vocab / experts.
BASELINE = Rules(
    name="baseline",
    table={
        "batch": ("pod", "data"),
        "embed": ("data",),  # FSDP: shard d_model dim of weights
        "embed_act": (),  # activations keep d_model replicated
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "expert_mlp": ("model",),  # fallback TP dim inside experts
        "kv_seq": ("data",),  # long-context KV cache sequence dim
        "seq": (),
        "head_dim": (),
        "state": (),
        "layers": (),
        "conv": (),
        "frontend": (),
        # MoE dispatch internals
        "expert_cap": ("data",),
        "expert_group": ("data",),
        "flat_tokens": ("pod", "data"),
        # SSM / xLSTM inner dims
        "ssm_inner": ("model",),
        "ssm_heads": ("model",),
        "ssm_state": (),
        "mlstm_inner": ("model",),
        "mlstm_qk": ("model",),
        "mlstm_p": (),
        "slstm_p": (),
    },
)

# GridLocal: identical to baseline but the batch does NOT shard over `pod`
# (each pod is an independent "site"); parameters gain a leading `grid`
# logical axis sharded over `pod`.
GRIDLOCAL = Rules(
    name="gridlocal",
    table={**BASELINE.table, "batch": ("data",), "grid": ("pod",)},
)


def mesh_axis_size(mesh: MeshShape, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes if a in mesh.shape)


def logical_to_pspec(
    logical_axes: Sequence[str | None],
    shape: Sequence[int],
    rules: Rules,
    mesh: MeshShape,
) -> tuple[PSpecEntry, ...]:
    """The pspec of a tensor with the given logical axes.

    Per dim: drop mesh axes that are absent from the mesh, already used by
    an earlier dim, or whose product does not divide the dim size."""
    if len(logical_axes) != len(shape):
        raise ValueError(f"axes {tuple(logical_axes)} do not match shape {tuple(shape)}")
    sizes = mesh.shape
    used: set[str] = set()
    parts: list[PSpecEntry] = []
    for ax, dim in zip(logical_axes, shape):
        cand = [a for a in (rules.lookup(ax) if ax else ()) if a in sizes and a not in used]
        # greedily keep the longest divisible prefix
        keep: list[str] = []
        prod = 1
        for a in cand:
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        used.update(keep)
        if not keep:
            parts.append(None)
        elif len(keep) == 1:
            parts.append(keep[0])
        else:
            parts.append(tuple(keep))
    # trim trailing Nones (cosmetic)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _map_leaves(fn, tree, is_leaf):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, is_leaf) for v in tree)
    raise TypeError(f"not a leaf or a container: {type(tree).__name__}")


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_pspecs(axes_tree, shape_tree, rules: Rules, mesh: MeshShape):
    """Map logical_to_pspec over parallel nested dicts/lists of
    axes-tuples and shapes."""
    if _is_axes(axes_tree):
        return logical_to_pspec(axes_tree, shape_tree, rules, mesh)
    if isinstance(axes_tree, Mapping):
        return {k: tree_pspecs(axes_tree[k], shape_tree[k], rules, mesh) for k in axes_tree}
    return type(axes_tree)(tree_pspecs(a, s, rules, mesh) for a, s in zip(axes_tree, shape_tree))


def shard_shape(shape: Sequence[int], pspec: Sequence[PSpecEntry], mesh: MeshShape) -> tuple[int, ...]:
    """The shape of one device's shard: each dim divided by the product of
    the mesh axes its pspec entry names (``NamedSharding.shard_shape``)."""
    out = list(shape)
    for i, entry in enumerate(pspec):
        n = mesh_axis_size(mesh, _as_tuple(entry))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split {n} ways ({pspec})")
        out[i] //= n
    return tuple(out)


def to_placements(pspec: Sequence[PSpecEntry], device_mesh) -> tuple:
    """The ``torch.distributed.tensor`` placements of a pspec on a
    ``DeviceMesh`` whose ``mesh_dim_names`` are the pspec's axes: mesh dim
    j gets ``Shard(d)`` when tensor dim d's entry names it, else
    ``Replicate()``.  A dim sharded over two axes gives ``Shard(d)`` on
    both mesh dims, in rule order (the first axis the major one)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names or ())
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        axes = _as_tuple(entry)
        if any(a not in names for a in axes):
            raise ValueError(f"an axis of {tuple(pspec)} is not a dim of the mesh {names}")
        idx = [names.index(a) for a in axes]
        # DTensor splits a dim sharded on several mesh dims in mesh-dim
        # order: only an entry in that order gives the reference's shards
        if idx != sorted(idx):
            raise ValueError(f"pspec entry {entry} is not in the mesh's axis order {names}")
        for j in idx:
            out[j] = Shard(d)
    return tuple(out)


def is_shape_axes(x) -> bool:
    return isinstance(x, ShapeAxes)


def specs_to_pspecs(tree, rules: Rules, mesh: MeshShape):
    """The pspec of every ShapeAxes leaf of a nested dict/list."""
    return _map_leaves(lambda s: logical_to_pspec(s.axes, s.shape, rules, mesh), tree, is_shape_axes)


def specs_to_placements(tree, rules: Rules, device_mesh):
    """The placements of every ShapeAxes leaf on a ``DeviceMesh``
    (``specs_to_shardings``' counterpart)."""
    mesh = MeshShape(tuple(device_mesh.mesh_dim_names), tuple(device_mesh.mesh.shape))
    return _map_leaves(lambda s: to_placements(logical_to_pspec(s.axes, s.shape, rules, mesh), device_mesh),
                       tree, is_shape_axes)


def struct(leaf: ShapeAxes, device="meta") -> torch.Tensor:
    """An empty tensor of the leaf's shape and dtype (``ShapeAxes.struct``'s
    counterpart): on ``"meta"`` it holds no memory; under a
    ``FakeTensorMode`` it is a fake tensor on ``device``."""
    return torch.empty(leaf.shape, dtype=torch_dtype(leaf.dtype), device=device)


def specs_to_structs(tree, device="meta"):
    return _map_leaves(lambda s: struct(s, device), tree, is_shape_axes)
