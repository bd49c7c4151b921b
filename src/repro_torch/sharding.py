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

A step runs sharded on DTensors: its state, batch and cache are placed
on a ``DeviceMesh`` by ``specs_to_placements`` (``distribute``), and inside
``activate(device_mesh, rules)`` the model's ``constrain`` calls, at the
reference's sites and with its logical axes, ``redistribute`` an
activation to the placements the rules give it (the counterpart of
``with_sharding_constraint``).  Outside ``activate``, and for a plain
tensor, ``constrain`` returns its input: every unsharded path runs as it
did.  A constraint is taken on the mesh the tensor lives on, so inside
the GridLocal per-pod step (a sub-mesh without ``pod``) the pod axis drops
out of the spec, as the reference strips its manual axes.

Where the reference leaves a placement to XLA's partitioner, the port
fixes it, so that every rank computes its own share and no more:
``use_weight`` gathers a parameter over the batch's mesh axes before use
(FSDP; its gradient is reduce-scattered back); the model constrains the
output of every projection that contracts over sharded heads or mlp to
the residual stream's placement (an all-reduce); ``local_heads`` runs an
attention core, and ``local_by_roles`` any op DTensor has no strategy for
(a scan, a recurrence, a top-k, a gather or scatter, a kernel), on each
rank's local shards; ``bmm_shared_weight_grad`` splits a weight gradient
over ranks that would otherwise each compute all of it.
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Mapping, Sequence
from dataclasses import dataclass

import torch

from repro_torch.models.specs import ShapeAxes, torch_dtype

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

    @classmethod
    def of(cls, device_mesh) -> "MeshShape":
        """The axes and sizes of a ``DeviceMesh``."""
        return cls(tuple(device_mesh.mesh_dim_names), mesh_sizes(device_mesh))


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
    mesh = MeshShape.of(device_mesh)
    return _map_leaves(lambda s: to_placements(logical_to_pspec(s.axes, s.shape, rules, mesh), device_mesh),
                       tree, is_shape_axes)


def struct(leaf: ShapeAxes, device="meta") -> torch.Tensor:
    """An empty tensor of the leaf's shape and dtype (``ShapeAxes.struct``'s
    counterpart): on ``"meta"`` it holds no memory; under a
    ``FakeTensorMode`` it is a fake tensor on ``device``."""
    return torch.empty(leaf.shape, dtype=torch_dtype(leaf.dtype), device=device)


def specs_to_structs(tree, device="meta"):
    return _map_leaves(lambda s: struct(s, device), tree, is_shape_axes)


def placements_of(axes: Sequence[str | None], shape: Sequence[int], rules: Rules, device_mesh) -> tuple:
    """The placements of a tensor with ``axes`` on ``device_mesh``."""
    return to_placements(logical_to_pspec(axes, shape, rules, MeshShape.of(device_mesh)), device_mesh)


def distribute(t: torch.Tensor, axes: Sequence[str | None], rules: Rules, device_mesh):
    """A tensor that every rank holds whole -> a DTensor placed by the
    rules; each rank keeps its own shard, and nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.detach().to(device_mesh.device_type), device_mesh,
                             placements_of(axes, t.shape, rules, device_mesh), src_data_rank=None)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def redistributed(t: torch.Tensor, device_mesh, placements) -> torch.Tensor:
    """``t`` on ``placements``: a DTensor redistributed, a plain tensor
    (the same on every rank) taken as replicated first."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, device_mesh, [Replicate()] * device_mesh.ndim)
    return t.redistribute(device_mesh, placements)


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (``full_tensor``); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# Activation constraints: identity unless a mesh and rules are active
# ---------------------------------------------------------------------------

_ACTIVE: list[tuple[object, Rules]] = []


@contextlib.contextmanager
def activate(device_mesh, rules: Rules):
    """Make (mesh, rules) the ones ``constrain`` places by while a sharded
    step runs.  Plain tensors the step makes (positions, masks) meet its
    DTensors as replicated ones (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    _ACTIVE.append((device_mesh, rules))
    try:
        with implicit_replication():
            yield
    finally:
        _ACTIVE.pop()


def use_weight(w: torch.Tensor) -> torch.Tensor:
    """A parameter as the step reads it.  Inside ``activate`` a DTensor
    parameter is gathered over the mesh axes the batch is sharded on (its
    FSDP shards on ``data``; its gradient is reduce-scattered back), and
    keeps its other shards (heads, mlp, vocab, experts on ``model``), so
    every matmul runs on the rank's own batch rows, as the reference's
    partitioner runs it.  The identity otherwise."""
    if not _ACTIVE:
        return w
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(w, DTensor):
        return w
    batch = set(_ACTIVE[-1][1].lookup("batch"))
    names = w.device_mesh.mesh_dim_names
    target = tuple(Replicate() if names[j] in batch else p for j, p in enumerate(w.placements))
    return w if target == tuple(w.placements) else w.redistribute(w.device_mesh, target)


def constrain(x: torch.Tensor, logical_axes: Sequence[str | None]) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axes: a DTensor is
    redistributed to the placements the active rules give ``logical_axes``
    on its own mesh (a Partial sum is reduced on the way); the identity
    outside ``activate`` and for a plain tensor."""
    if not _ACTIVE:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    target = placements_of(logical_axes, x.shape, _ACTIVE[-1][1], x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return _Constrain.apply(x, target)


class _Constrain(torch.autograd.Function):
    """``redistribute`` whose backward hands the gradient of a Partial
    input back replicated where DTensor's own would hand it back Partial:
    the gradient of a sum is the same on every rank, and a Partial one
    would make the matmul that produced the input replicate its backward
    over the heads' or mlp's ranks rather than reduce."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.src, ctx.mesh = tuple(x.placements), x.device_mesh
        return x.redistribute(x.device_mesh, target)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        back = tuple(Replicate() if p.is_partial() else p for p in ctx.src)
        return g.redistribute(ctx.mesh, back), None


def mesh_sizes(device_mesh) -> tuple[int, ...]:
    """A ``DeviceMesh``'s dim sizes, read without touching its rank tensor
    (which a fake mode would refuse); a description with only a rank
    layout (``mesh``) gives that layout's shape."""
    if hasattr(device_mesh, "ndim") and hasattr(device_mesh, "size"):
        return tuple(device_mesh.size(i) for i in range(device_mesh.ndim))
    return tuple(device_mesh.mesh.shape)


def local_offset(t, dim: int) -> int:
    """Where this rank's shard of DTensor ``t`` starts along ``dim`` (the
    rules split a dim evenly, over its mesh dims in mesh order)."""
    mesh = t.device_mesh
    idx, n = 0, 1
    for j, p in enumerate(t.placements):
        if p.is_shard(dim):
            idx, n = idx * mesh.size(j) + mesh.get_local_rank(j), n * mesh.size(j)
    return idx * (t.shape[dim] // n)


def local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention on each rank's own batch rows and heads, with no
    collective: ``fn(q, k, v)`` with q (B, Sq, H, Dh) and k/v (B, Skv,
    Kv, Dh) -> (B, Sq, H, Dh), run on the local shards of DTensor
    operands (plain ones go straight to ``fn``).  q keeps its shards of
    the batch (dim 0) and the heads (dim 2), k and v the same batch
    shards and, where the KV heads split as q's heads do, the same head
    shards; any other sharding (of a sequence or a head dim) is gathered
    first.  Where q's heads are split over mesh dims that do not split the
    KV heads (fewer KV heads than ranks), each rank keeps k and v whole on
    those dims and takes the KV heads its query heads group onto.  The
    output is placed as q is; this is how the reference's attention runs
    after its constraints, local to each device."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(q, DTensor):
        return fn(q, k, v)
    mesh = q.device_mesh
    sizes = mesh_sizes(mesh)
    qp = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate() for p in q.placements]
    head_split = math.prod(sizes[j] for j, p in enumerate(qp) if p == Shard(2))
    n_kv = k.shape[2]
    kv_split = n_kv % head_split == 0
    kp = [p if p == Shard(0) or (p == Shard(2) and kv_split) else Replicate() for p in qp]
    q = q.redistribute(mesh, qp)
    k, v = redistributed(k, mesh, kp), redistributed(v, mesh, kp)
    # where k and v stay whole over ranks that split q's heads, each rank's
    # gradient of them is its heads' share of a sum
    kv_grad = [Partial() if (p == Shard(2) and not kv_split) else p for p in qp]
    kv_grad = [g if isinstance(g, Partial) else kp[j] for j, g in enumerate(kv_grad)]
    ql, kl, vl = q.to_local(), k.to_local(grad_placements=kv_grad), v.to_local(grad_placements=kv_grad)
    if not kv_split and head_split > 1:
        # the KV heads this rank's query heads group onto
        group = q.shape[2] // n_kv
        h0, hl = local_offset(q, 2), ql.shape[2]
        if hl % group and group % hl:
            raise ValueError(f"{hl} local query heads do not group onto KV heads of {group}")
        k0, k1 = h0 // group, (h0 + hl - 1) // group + 1
        kl, vl = kl[:, :, k0:k1], vl[:, :, k0:k1]
    out = fn(ql, kl, vl).contiguous()
    return DTensor.from_local(out, mesh, qp, shape=q.shape, stride=torch.empty(q.shape, device="meta").stride())


def local_by_roles(fn, args: Sequence, roles: Sequence[dict | None], out_roles: Sequence[dict], lead: int = 0):
    """``fn(*args)`` on each rank's local shards, with no collective in
    ``fn``: the counterpart of ``local_map`` for an op DTensor has no
    sharding strategy for (a scan, a recurrence, a kernel).  ``roles[i]``
    maps role names (``"batch"``, ``"heads"``) to the dim of ``args[i]``
    that carries them (None: the argument goes as it is).  A mesh dim on
    which ``args[lead]`` is sharded along a role's dim carries that role:
    every argument with the role is sharded there along its own dim, the
    others replicated; every other mesh dim is replicated (gathered, where
    an argument was sharded along it).  ``out_roles`` places the outputs
    alike (``fn`` returns a tensor or a tuple, one dict each); an output's
    role mapped to None makes it a Partial sum on that role's mesh dims
    (each rank's output is its share of a sum, reduced by a later
    ``constrain``).  With no DTensor among the arguments ``fn`` gets them
    as they are."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = args[lead].device_mesh
    by_dim = {d: r for r, d in roles[lead].items()}
    carried = [by_dim.get(p.dim) if isinstance(p, Shard) else None for p in args[lead].placements]

    def placed(role_dims: dict) -> list:
        return [(Partial() if role_dims[r] is None else Shard(role_dims[r])) if r in role_dims else Replicate()
                for r in carried]

    local = []
    for a, rd in zip(args, roles):
        if rd is None:
            local.append(a)
            continue
        target = placed(rd)
        # whole on a mesh dim whose role it lacks, each rank uses it for its
        # own share of that role: its gradient there is a Partial sum
        grad = [Partial() if (r is not None and r not in rd) else p for r, p in zip(carried, target)]
        local.append(redistributed(a, mesh, target).to_local(grad_placements=grad))
    out = fn(*local)
    single = isinstance(out, torch.Tensor)
    outs = (out,) if single else tuple(out)
    sizes = mesh_sizes(mesh)
    wrapped = []
    for o, rd in zip(outs, out_roles):
        o, pl = o.contiguous(), placed(rd)
        shape = list(o.shape)
        for j, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= sizes[j]
        stride = torch.empty(shape, device="meta").stride()
        wrapped.append(DTensor.from_local(o, mesh, pl, shape=torch.Size(shape), stride=stride))
    return wrapped[0] if single else tuple(wrapped)


def bmm_shared_weight_grad(x: torch.Tensor, w: torch.Tensor, split: int) -> torch.Tensor:
    """``torch.bmm(x, w)`` whose weight gradient is split over the ranks
    that hold the same x, w and output (mesh dims on which all three are
    replicated: ``pod`` for the MoE expert buffers under ``BASELINE``),
    along w's dim ``split`` (1 or 2), then gathered, where DTensor's own
    backward would have each of those ranks compute the whole of it.  The
    reference's partitioner splits the expert weight gradients so; the
    forward and the input gradient are DTensor's.  Plain tensors, or no
    such mesh dim: ``torch.bmm``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(w, DTensor) or not isinstance(x, DTensor):
        return torch.bmm(x, w)
    idle = [j for j in range(w.device_mesh.ndim)
            if x.placements[j].is_replicate() and w.placements[j].is_replicate()]
    if not idle or not torch.is_grad_enabled():
        return torch.bmm(x, w)
    return _BmmSplitGrad.apply(x, w, split, tuple(idle))


class _BmmSplitGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, split, idle):
        y = torch.bmm(x, w)
        ctx.save_for_backward(x, w)
        ctx.split, ctx.idle, ctx.y_pl = split, idle, tuple(y.placements)
        return y

    @staticmethod
    def backward(ctx, dy):
        from torch.distributed.tensor import DTensor, Partial, Shard

        x, w = ctx.saved_tensors
        mesh = w.device_mesh
        dy = dy.redistribute(mesh, ctx.y_pl)
        dx = torch.bmm(dy, w.transpose(1, 2))
        # this rank's slice of the split dim, over the idle mesh dims
        n, r = 1, 0
        for j in ctx.idle:
            r, n = r * mesh.size(j) + mesh.get_local_rank(j), n * mesh.size(j)
        xl, dyl = x.to_local(), dy.to_local()
        if ctx.split == 2:
            size = dyl.shape[-1] // n
            part = torch.bmm(xl.transpose(1, 2), dyl[..., r * size:(r + 1) * size])
        else:
            size = xl.shape[-1] // n
            part = torch.bmm(xl[..., r * size:(r + 1) * size].transpose(1, 2), dyl)
        # the slice's placements: experts as x's, the contraction's shards a
        # Partial sum, the idle dims a shard of the split dim
        pl = []
        for j, p in enumerate(x.placements):
            if j in ctx.idle:
                pl.append(Shard(ctx.split))
            elif p == Shard(0):
                pl.append(Shard(0))
            elif p == Shard(1) or p.is_partial():
                pl.append(Partial())
            else:
                pl.append(p)
        dw = DTensor.from_local(part.contiguous(), mesh, pl, shape=w.shape, stride=w.stride())
        return dx, dw.redistribute(mesh, w.placements), None, None
