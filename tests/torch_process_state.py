"""What an in-process caller of the port can leave behind in a test
process, for the tests that need a clean one: a default
``torch.distributed`` group, an active sharding (``sharding.activate``'s
stack), a live async checkpoint writer (``Checkpointer``'s thread), a
torch function or dispatch mode left on its stack, and a cost counter's
pause left on DTensor's shape inference (``roofline.op_costs``), which
nests one more call frame into every DTensor op each time it is left."""

import threading

import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.checkpoint.checkpointer import WRITER_THREAD
from repro_torch.roofline import op_costs


def shape_inference_hook():
    """(name, function) of ``ShardingPropagator``'s shape inference that a
    ``CostCounter`` pauses in."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    for name in op_costs.SHAPE_INFERENCE_HOOKS:
        fn = ShardingPropagator.__dict__.get(name)
        if fn is not None:
            return name, fn
    return None, None


def leaked_state() -> list[str]:
    """Each piece of process state found, named; empty when there is none."""
    found = []
    if dist.is_available() and dist.is_initialized():
        found.append(f"a default process group (backend {dist.get_backend()!r}, "
                     f"{dist.get_world_size()} rank(s))")
    if sharding._ACTIVE:
        found.append(f"{len(sharding._ACTIVE)} active sharding(s) (rules "
                     f"{[rules.name for _, rules in sharding._ACTIVE]})")
    writers = [t.name for t in threading.enumerate() if t.name == WRITER_THREAD and t.is_alive()]
    if writers:
        found.append(f"{len(writers)} live checkpoint writer thread(s)")
    modes = (torch._C._len_torch_function_stack(), torch._C._len_torch_dispatch_stack())
    if any(modes):
        found.append(f"{modes[0]} torch function mode(s) and {modes[1]} dispatch mode(s) on their stacks")
    name, fn = shape_inference_hook()
    if fn is not None and getattr(fn, "__module__", "") == op_costs.__name__:
        found.append(f"a cost counter's pause left on ShardingPropagator.{name}")
    return found
