"""Op-level cost counting of an eager step: the port's counterpart of
``repro.roofline.hlo_costs``.

The reference parses the optimized HLO text of a compiled step.  The port
has no HLO: it runs eagerly, and what it costs is the aten ops it
dispatches.  ``CostCounter`` is a ``TorchDispatchMode`` that sees every
one of them, the backward's and a checkpoint's recomputation included,
and accumulates an ``OpCosts``:

  * flops            — matmul-family FLOPs, from the formulas that
                       ``torch.utils.flop_counter`` registers (mm, addmm,
                       bmm, baddbmm, convolutions, the attention ops; a
                       composite op it does not know is decomposed first,
                       as ``FlopCounterMode`` does), plus the reference's
                       reduction rule: operand bytes / 4 for each
                       reduction (``hlo_costs.py:366-369``; softmax and
                       layer norm count two reductions, their backwards
                       one)
  * traffic_bytes    — operand plus result bytes of every op that is not
                       a view (a view, or an op whose result shares its
                       input's storage, costs 0, as ``bitcast`` does); an
                       in-place write into a slice (``copy_``,
                       ``index_put_``, ...) is charged twice the written
                       region, as ``traffic_of``'s dynamic-update-slice rule
                       is; a broadcast operand counts the bytes it
                       addresses.  Eager ops are not fused, so this is the
                       step's real HBM traffic up to what the caches keep,
                       not XLA's estimate of a fused program
  * collective bytes — per type, max(operand, result) bytes for every
                       ``c10d`` / ``_c10d_functional`` op, tagged
                       pod-crossing when its group's ranks span pods of
                       ``chips_per_pod``; 0 on one card
  * peak_bytes       — the high-water mark of live storage bytes, each
                       storage counted from the first op that makes or
                       reads it (or from ``track``) to the moment its
                       last reference dies (a weak reference to the
                       storage): ``memory_analysis()``'s counterpart,
                       exact in bytes and blind to the allocator's
                       rounding and workspaces

A sharded step runs on DTensors.  The counter steps aside for an op on a
DTensor (it returns ``NotImplemented``, so DTensor's own dispatch runs
it) and counts what that dispatch issues below it: the local op each rank
runs on its shard, and the collectives of every redistribution.  Its
counts are then one device's, the reference's ``hlo_flops_per_device``
and ``hlo_bytes_per_device``, and its peak is of the local storages (a
DTensor handed to ``track`` counts its local tensor).  DTensor's own shape
inference, which runs ops at the global shapes, is not counted; where this
torch has no hook to pause it (``SHAPE_INFERENCE_HOOKS``) the counter
raises at the first DTensor op rather than count it.  On one card no
DTensor appears and nothing changes.

An eager loop runs every trip, so unlike the reference no trip-count
multiplier is needed, and a loop's body is counted as often as it runs.
The counter works under ``FakeTensorMode`` on device ``cpu`` or ``cuda``
(enter the fake mode first, then the counter), so a step at full size is
counted without device memory.  The port's CUDA kernel wrappers
(``kernels.ops``) are not aten ops and would go uncounted: the dry run
refuses a config that turns them on (``launch.dryrun``).
"""

from __future__ import annotations

import functools
import os
import sys
import weakref
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# reductions and how many each op performs over its first operand
REDUCTIONS = {
    "sum": 1, "mean": 1, "prod": 1, "amax": 1, "amin": 1, "max": 1, "min": 1,
    "argmax": 1, "argmin": 1, "logsumexp": 2, "var": 2, "std": 2, "var_mean": 2,
    "std_mean": 2, "norm": 1, "linalg_vector_norm": 1, "any": 1, "all": 1,
    "_softmax": 2, "_log_softmax": 2, "_softmax_backward_data": 1,
    "_log_softmax_backward_data": 1, "native_layer_norm": 2,
}
# max/min with a second tensor are elementwise, not reductions
_BINARY_OR_REDUCE = {"max", "min"}

# ops that write a region of their first operand: charged twice the region
SLICE_WRITES = {
    "copy_": "src", "index_put_": "values", "_index_put_impl_": "values", "index_copy_": "source",
    "index_add_": "source", "scatter_": "src", "scatter_add_": "src", "masked_scatter_": "source",
}

COLLECTIVE_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce", "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")

# metadata queries: no data is touched
_METADATA = {
    "sym_is_contiguous", "is_contiguous", "is_strides_like_format", "is_non_overlapping_and_dense",
    "size", "sym_size", "stride", "sym_stride", "storage_offset", "sym_storage_offset", "numel",
    "sym_numel", "dim", "layout", "device",
}

_PKG = os.sep + "repro_torch" + os.sep
_SELF = os.path.join("roofline", "op_costs.py")


try:
    from torch.distributed.tensor import DTensor as _DTENSOR
except ImportError:  # a build without torch.distributed
    _DTENSOR = None


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if _DTENSOR is not None and isinstance(t, _DTENSOR) else t


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor addresses: a broadcast (stride-0) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):  # sparse, nested: no plain storage
        return None


@dataclass
class OpRecord:
    """One dispatched op: its cost, and where it came from — ``where`` the
    innermost frame under ``repro_torch/`` that issued it, or for a
    backward op the one that issued its forward (the counterpart of HLO
    ``op_name`` metadata); ``node`` the autograd node running it in a
    backward, ``"recompute"`` for a checkpoint's forward rerun there, ""
    in a forward."""

    op: str
    type_str: str
    flops: float
    traffic_bytes: float
    coll_bytes: float
    coll_type: str
    where: str
    node: str


@dataclass
class OpCosts:
    """What ``CostCounter`` accumulated; ``as_dict`` has the reference's
    ``HloCosts.as_dict`` keys plus ``peak_bytes``."""

    flops: float = 0.0
    traffic_bytes: float = 0.0
    coll_bytes_by_type: dict = field(default_factory=dict)
    coll_count_by_type: dict = field(default_factory=dict)
    coll_bytes_cross_pod: float = 0.0
    coll_bytes_total: float = 0.0
    peak_bytes: int = 0
    n_ops: int = 0
    ops: list = field(default_factory=list)  # OpRecords, with CostCounter(record_ops=True)

    def as_dict(self):
        return {
            "flops": self.flops,
            "traffic_bytes": self.traffic_bytes,
            "bytes_by_type": self.coll_bytes_by_type,
            "count_by_type": self.coll_count_by_type,
            "cross_pod_bytes": self.coll_bytes_cross_pod,
            "total_bytes": self.coll_bytes_total,
            "peak_bytes": self.peak_bytes,
        }


def _type_str(outs) -> str:
    ts = [t for t in outs if isinstance(t, torch.Tensor)]
    if not ts:
        return ""
    t = ts[0]
    return f"{str(t.dtype).replace('torch.', '')}[{','.join(map(str, t.shape))}]"


def _where() -> str:
    """The innermost frame under repro_torch/ (this module left out)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        i = fn.rfind(_PKG)
        if i >= 0 and not fn.endswith(_SELF):
            return f"{fn[i + len(_PKG):]}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return ""


def _group_ranks(args) -> list[int] | None:
    """The global ranks of the process group a collective runs on: a
    ``c10d`` op carries it as a script object, a ``_c10d_functional`` op
    by name."""
    import torch.distributed as dist

    for a in args:
        try:
            if isinstance(a, str):
                from torch.distributed.distributed_c10d import _resolve_process_group

                return dist.get_process_group_ranks(_resolve_process_group(a))
            if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
                return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
        except (ValueError, RuntimeError, KeyError):
            continue  # another string (a reduce op's name)
    return None


class _OpInfo(NamedTuple):
    name: str
    ns: str
    metadata: bool  # touches no data
    composite: bool  # has a CompositeImplicitAutograd kernel and no flop formula
    formula: Any  # torch.utils.flop_counter's formula, or None
    n_red: int  # reductions over the first operand
    coll_type: str  # the collective's type, or ""
    is_view: bool
    mutates: bool  # writes one of its arguments
    src_arg: int  # SLICE_WRITES: the written source's position (-1: none)


@functools.cache
def _op_info(func) -> _OpInfo:
    packet = func._overloadpacket
    name, ns = packet.__name__, func.namespace
    formula = flop_registry.get(packet)
    metadata = name in _METADATA and ns in ("aten", "prim")
    dk = torch._C.DispatchKey.CompositeImplicitAutograd
    composite = not metadata and formula is None and (
        dk in func.py_kernels or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), dk))
    schema = func._schema
    names = [a.name for a in schema.arguments]
    src = SLICE_WRITES.get(name)
    return _OpInfo(
        name=name, ns=ns, metadata=metadata, composite=composite,
        formula=formula, n_red=REDUCTIONS.get(name, 0) if ns == "aten" else 0,
        coll_type=COLLECTIVE_OPS.get(name, "") if ns in _COLLECTIVE_NAMESPACES else "",
        is_view=func.is_view,
        mutates=any(a.alias_info is not None and a.alias_info.is_write for a in schema.arguments),
        src_arg=names.index(src) if src in names else -1)


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _inplace_traffic(info: _OpInfo, args, kwargs, ins, outs) -> float:
    if info.name in SLICE_WRITES:
        key = SLICE_WRITES[info.name]
        src = kwargs.get(key, args[info.src_arg] if 0 <= info.src_arg < len(args) else None)
        others = sum(tensor_bytes(t) for t in ins[1:] if t is not src)
        if isinstance(src, torch.Tensor):
            return 2.0 * tensor_bytes(src) + others
        # a scalar scattered through an index: one element written an entry
        return float(others + (ins[1].numel() * ins[0].element_size() if len(ins) > 1 else 0))
    if info.name in ("fill_", "zero_"):
        return float(tensor_bytes(ins[0])) if ins else 0.0
    # other in-place ops read their target and every operand, and write the target
    return float(sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs)))


class CostCounter(TorchDispatchMode):
    """Count the ops run under it into ``self.costs`` (an ``OpCosts``).

        with FakeTensorMode():
            state = ...
            counter = CostCounter()
            counter.track(state)          # what is live before the step
            with counter:
                step(state, batch)
        counter.costs.flops, counter.costs.peak_bytes

    ``record_ops`` keeps an ``OpRecord`` of each op (``roofline.breakdown``
    reads them); ``chips_per_pod`` sets which collectives cross pods."""

    def __init__(self, record_ops: bool = False, chips_per_pod: int = 8):
        super().__init__()
        self.costs = OpCosts()
        self.record_ops = record_ops
        self.chips_per_pod = chips_per_pod
        self.live_bytes = 0
        self._live: dict[int, int] = {}
        self._refs: dict[int, weakref.ref] = {}
        self._paused = 0
        self._prop = None  # the paused shape-inference hook, while entered
        self._depth = 0  # open ``with self`` blocks: a composite op re-enters the mode

    # -- live storage -------------------------------------------------------

    def _register(self, t: torch.Tensor) -> int | None:
        st = _storage(t)
        if st is None:
            return None
        key = st._cdata
        if key in self._live:
            return key
        n = st.nbytes()
        self._live[key] = n
        self._refs[key] = weakref.ref(st, lambda _, key=key: self._release(key))
        self.live_bytes += n
        if self.live_bytes > self.costs.peak_bytes:
            self.costs.peak_bytes = self.live_bytes
        return key

    def _release(self, key: int) -> None:
        n = self._live.pop(key, None)
        self._refs.pop(key, None)
        if n is not None:
            self.live_bytes -= n

    def track(self, *trees) -> None:
        """Count the storages of every tensor in ``trees`` (nested dicts,
        lists, modules) as live from now on."""
        for tree in trees:
            if isinstance(tree, torch.nn.Module):
                tree = list(tree.parameters()) + list(tree.buffers())
            for x in tree_flatten(tree)[0]:
                if isinstance(x, torch.nn.Module):
                    self.track(x)
                elif isinstance(x, torch.Tensor):
                    self._register(_local(x))

    def reset_peak(self) -> None:
        self.costs.peak_bytes = self.live_bytes

    # -- dispatch -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _DTENSOR is not None and any(issubclass(t, _DTENSOR) for t in types):
            if self._prop is None:
                raise RuntimeError(
                    "CostCounter: no hook to pause in DTensor's shape inference (none of "
                    f"ShardingPropagator.{', '.join(SHAPE_INFERENCE_HOOKS)}); a per-device count "
                    "would hold the global-shape ops it runs whenever DTensor's cache misses")
            # DTensor's dispatch runs it; the local ops and collectives it
            # issues come back here
            return NotImplemented
        if self._paused:  # DTensor's shape inference: no device runs it
            return func(*args, **(kwargs or {}))
        kwargs = kwargs or {}
        info = _op_info(func)
        if info.metadata:
            return func(*args, **kwargs)
        if info.composite:
            # a composite op: count its parts, as FlopCounterMode does (with
            # no torch-function mode, which would send them back up here)
            with self, torch._C.DisableTorchFunction():
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        self._account(info, args, kwargs, out)
        return out

    def _account(self, info: _OpInfo, args, kwargs, out) -> None:
        ins = list(_tensors(args)) + list(_tensors(kwargs.values()))
        outs = list(_tensors((out,)))
        in_keys = [self._register(t) for t in ins]
        out_keys = {self._register(t) for t in outs}

        flops = float(info.formula(*args, **kwargs, out_val=out)) if info.formula else 0.0
        if info.n_red and ins and not (info.name in _BINARY_OR_REDUCE and len(ins) > 1):
            flops += info.n_red * tensor_bytes(ins[0]) / 4.0

        coll_b = 0.0
        if info.coll_type:
            # its operands: what it reads, not the output buffers passed in
            read = [t for t, k in zip(ins, in_keys) if k not in out_keys]
            coll_b = float(max(sum(map(tensor_bytes, read)), sum(map(tensor_bytes, outs))))
            c = self.costs
            c.coll_bytes_by_type[info.coll_type] = c.coll_bytes_by_type.get(info.coll_type, 0.0) + coll_b
            c.coll_count_by_type[info.coll_type] = c.coll_count_by_type.get(info.coll_type, 0) + 1
            c.coll_bytes_total += coll_b
            ranks = _group_ranks(args)
            if ranks and len({r // self.chips_per_pod for r in ranks}) > 1:
                c.coll_bytes_cross_pod += coll_b

        if info.coll_type:
            traffic = float(sum(map(tensor_bytes, read)) + sum(map(tensor_bytes, outs)))
        elif info.mutates:
            traffic = _inplace_traffic(info, args, kwargs, ins, outs)
        elif info.is_view or any(k in out_keys for k in in_keys):
            traffic = 0.0  # a view or alias: no data moves
        else:
            traffic = float(sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs)))
        self.costs.flops += flops
        self.costs.traffic_bytes += traffic
        self.costs.n_ops += 1
        if self.record_ops:
            node = torch._C._current_autograd_node()
            if node is None:
                where, label = _where(), ""
            elif torch.is_grad_enabled():  # a checkpoint's forward, rerun in the backward
                where, label = _where(), "recompute"
            else:  # a backward op: the forward line that made its node
                where, label = node.metadata.get("where", ""), node.name()
            self.costs.ops.append(OpRecord(
                op=f"{info.ns}.{info.name}", type_str=_type_str(outs), flops=flops, traffic_bytes=traffic,
                coll_bytes=coll_b, coll_type=info.coll_type, where=where, node=label))

    def __enter__(self):
        # the hook and the line recorder belong to the outermost entry: a
        # re-entry (``__torch_dispatch__``'s decompositions) would save the
        # outer wrapper as the hook to restore, and leave it on
        # ShardingPropagator, one more level each count
        if self._depth == 0:
            if self.record_ops:
                self._lines = _ForwardLines()
                self._lines.__enter__()
            self._prop = _pause_in_shape_inference(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth == 0:
            _resume_shape_inference(self._prop)
            self._prop = None
            if self.record_ops:
                self._lines.__exit__(*exc)
        return out


# ShardingPropagator's uncached shape inference, under the names torch has
# given it; the first one found is paused
SHAPE_INFERENCE_HOOKS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


def _pause_in_shape_inference(counter: "CostCounter"):
    """While the counter is active, pause it inside DTensor's shape
    inference: the first time DTensor's sharding propagation meets an op's
    signature it runs the op at the global shapes on fake tensors to learn
    its output's, and no device runs that; the count must not depend on
    DTensor's cache.  Returns what ``_resume_shape_inference`` restores,
    None where no hook is found (the counter then refuses DTensor ops)."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:
        return None
    for name in SHAPE_INFERENCE_HOOKS:
        orig = ShardingPropagator.__dict__.get(name)
        if orig is not None:
            break
    else:
        return None

    def paused(self, *args, **kwargs):
        counter._paused += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            counter._paused -= 1

    setattr(ShardingPropagator, name, paused)
    return name, orig


def _resume_shape_inference(saved) -> None:
    if saved is not None:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        setattr(ShardingPropagator, *saved)


class _ForwardLines(TorchFunctionMode):
    """Note on each autograd node the line under ``repro_torch/`` that
    made it, so the backward's ops are named by their forward's line (the
    backward may run on the autograd engine's own thread, with no frame of
    the port on its stack)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        where = None
        for t in _tensors((out,)):
            # the nodes this call made: its outputs' and, back to the first
            # node already noted, those of the ops it was made of
            stack = [t.grad_fn]
            while stack:
                fn = stack.pop()
                if fn is None or "where" in fn.metadata:
                    continue
                fn.metadata["where"] = where = where if where is not None else _where()
                stack.extend(nxt for nxt, _ in fn.next_functions)
        return out
