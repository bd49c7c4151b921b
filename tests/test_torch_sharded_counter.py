"""The op counter on DTensors and the constraint machinery.

  * on a fake 16x16 group (256 ranks in one process) one sharded matmul
    counts 1/256 of its global FLOPs: the counter counts the local op each
    rank runs, not DTensor's global one, nor the op DTensor's sharding
    propagation runs at the global shapes to learn the output's;
  * the collectives the counter counts for a sharded train step on a fake
    4-rank group equal, by type, count and bytes, those that a real 4-rank
    gloo group issues for the same step, seen by a spy on each rank (a
    dispatch mode of its own that records every ``_c10d_functional`` op);
  * where torch has none of the hooks the counter pauses DTensor's shape
    inference in, the counter refuses a DTensor op and still counts a
    plain one;
  * ``constrain`` outside ``activate``, and on a plain tensor inside it,
    returns its input object; ``use_weight`` likewise.
The groups live in processes of their own (one default group a process)."""

import json
import os
import subprocess
import sys

import torch

from repro_torch.sharding import BASELINE, activate, constrain, use_weight
from torch_sharded_gloo import SRC, run_ranks

FAKE_MATMUL = r"""
import logging
logging.disable(logging.WARNING)
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.mesh import init_fake_group, make_device_mesh, make_production_mesh
from repro_torch.roofline.op_costs import CostCounter
init_fake_group(256)
mesh = make_device_mesh(make_production_mesh(), "cpu")
out = []
with FakeTensorMode():
    a = distribute_tensor(torch.empty(4096, 2048), mesh, [Shard(0), Replicate()])
    b = distribute_tensor(torch.empty(2048, 1024), mesh, [Replicate(), Shard(1)])
    for _ in range(2):  # the second call meets DTensor's cache
        c = CostCounter()
        with c:
            y = a @ b
        out.append(c.costs.flops)
print(out, tuple(y.to_local().shape))
"""

NO_HOOK = r"""
import logging
logging.disable(logging.WARNING)
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.mesh import init_fake_group, make_device_mesh, make_test_mesh
from repro_torch.roofline import op_costs
init_fake_group(4)
mesh = make_device_mesh(make_test_mesh(2, 2), "cpu")
op_costs.SHAPE_INFERENCE_HOOKS = ("_no_such_hook",)  # a torch that renamed them
with FakeTensorMode():
    a = distribute_tensor(torch.empty(64, 32), mesh, [Shard(0), Replicate()])
    b = distribute_tensor(torch.empty(32, 16), mesh, [Replicate(), Shard(1)])
    c = op_costs.CostCounter()
    with c:
        a.to_local() @ b.to_local()
    try:
        with op_costs.CostCounter():
            a @ b
        refused = ""
    except RuntimeError as e:
        refused = str(e)
print(c.costs.flops, "no hook" in refused)
"""

STEP = r"""
import dataclasses
import repro_torch.configs as TC
from repro_torch.data.pipeline import place_batch
from repro_torch.launch.mesh import make_device_mesh, make_test_mesh
from repro_torch.optim import adamw as TA
from repro_torch.roofline.op_costs import CostCounter, COLLECTIVE_OPS
from repro_torch.sharding import BASELINE, activate
from repro_torch.train import steps as TS
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

class Spy(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = {}
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor dispatch it: its collectives come back here
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional" and func._overloadpacket.__name__ in COLLECTIVE_OPS:
            kind = COLLECTIVE_OPS[func._overloadpacket.__name__]
            n = max(sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor)),
                    out.numel() * out.element_size())
            c, b = self.seen.get(kind, (0, 0))
            self.seen[kind] = (c + 1, b + n)
        return out

def step(counter_cls):
    cfg = TC.reduced(TC.get("stablelm-1.6b"))
    mesh = make_device_mesh(make_test_mesh(2, 2), "cpu")
    state = TS.shard_state(cfg, TS.materialize_state(cfg, torch.Generator().manual_seed(0), device="cpu"),
                           mesh, BASELINE)
    tok = torch.randint(0, cfg.vocab, (4, 17), generator=torch.Generator().manual_seed(1))
    batch = place_batch({"tokens": tok[:, :-1], "labels": tok[:, 1:]}, mesh, BASELINE)
    fn = TS.make_train_step(cfg, TA.AdamWConfig(), loss_chunk=8)
    c = counter_cls()
    with activate(mesh, BASELINE), c:
        fn(state, batch)
    return c
"""

FAKE_STEP = r"""
import json, logging
logging.disable(logging.WARNING)
import torch
from repro_torch.launch.mesh import init_fake_group
init_fake_group(4)
""" + STEP + r"""
c = step(CostCounter).costs
print(json.dumps({k: [c.coll_count_by_type[k], c.coll_bytes_by_type[k]] for k in c.coll_bytes_by_type}))
"""


def _run(script: str) -> str:
    env = {**os.environ, "PYTHONPATH": SRC}
    p = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.strip().splitlines()[-1]


def test_sharded_matmul_counts_one_256th_on_a_fake_16x16_group():
    line = _run(FAKE_MATMUL)
    flops, shape = line.split("] ")
    want = 2 * 4096 * 2048 * 1024 / 256
    assert [float(f) for f in flops.strip("[").split(",")] == [want, want], line
    assert shape == "(256, 64)"


def test_counter_refuses_dtensor_ops_without_a_shape_inference_hook():
    flops, refused = _run(NO_HOOK).split()
    assert float(flops) == 2 * 32 * 32 * 8, flops  # the local (32, 32) @ (32, 8) still counts
    assert refused == "True"


def test_fake_group_collectives_equal_the_gloo_ranks(tmp_path):
    fake = {k: tuple(v) for k, v in json.loads(_run(FAKE_STEP)).items()}
    body = STEP + r"""
spy = step(Spy)
RESULTS["seen"] = spy.seen
"""
    ranks = run_ranks(body, {}, tmp_path, every_rank=True)
    assert fake and sum(b for _, b in fake.values()) > 0
    for r, got in enumerate(ranks):
        assert {k: (c, float(b)) for k, (c, b) in got["seen"].items()} == fake, (r, got["seen"], fake)


def test_constrain_is_the_identity_outside_activate():
    x = torch.randn(4, 8, 16)
    w = torch.nn.Parameter(torch.randn(16, 16))
    assert constrain(x, ("batch", "seq", None)) is x
    assert use_weight(w) is w
    with activate(None, BASELINE):  # a plain tensor inside activate is left alone too
        assert constrain(x, ("batch", "seq", None)) is x
        assert use_weight(w) is w
