"""The port's op-level cost counter (``repro_torch.roofline.op_costs``),
its roofline terms and its breakdown, held on the CPU to exact counts, to
hand-computed bytes, and to the JAX package's ``analyze_hlo``.

``tests/test_hlo_costs.py``'s cases run here as eager PyTorch: one
matmul, a 10-step loop, a nested 4 x 3 loop and a batched einsum.  An
eager loop runs every trip, so the counter needs no trip-count
multiplier; the JAX side compiles the same function (a ``lax.scan``) and
counts it with ``analyze_hlo``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.roofline.analyze import roofline_terms as jax_roofline_terms
from repro.roofline.hlo_costs import analyze_hlo
from repro_torch.launch.mesh import HW
from repro_torch.roofline import breakdown
from repro_torch.roofline.analyze import collective_stats, roofline_terms
from repro_torch.roofline.op_costs import CostCounter, OpCosts, tensor_bytes


def count(fn, *args, record_ops: bool = False, track=()):
    """``(fn(*args), OpCosts)``: one call counted, the tensors of
    ``track`` live from the start."""
    counter = CostCounter(record_ops=record_ops)
    counter.track(*track)
    counter.reset_peak()
    with counter:
        out = fn(*args)
    return out, counter.costs


def jax_flops(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def torch_flops(fn, *shapes):
    g = torch.Generator().manual_seed(0)
    _, costs = count(fn, *[torch.randn(s, generator=g) for s in shapes])
    return costs.flops


# ---------------------------------------------------------------------------
# tests/test_hlo_costs.py's cases, eager
# ---------------------------------------------------------------------------


class TestDotFlops:
    def test_single_matmul(self):
        want = 2 * 64 * 128 * 32
        got = torch_flops(lambda a, b: a @ b, (64, 128), (128, 32))
        assert got == want
        assert got == pytest.approx(jax_flops(lambda a, b: a @ b, (64, 128), (128, 32)), rel=0.01)

    def test_loop_runs_every_trip(self):
        def loop(x, ws):
            for i in range(ws.shape[0]):
                x = x @ ws[i]
            return x

        def scanned(x, ws):
            return jax.lax.scan(lambda c, w: (c @ w, None), x, ws)[0]

        want = 10 * 2 * 32 * 64 * 64
        assert torch_flops(loop, (32, 64), (10, 64, 64)) == want
        assert torch_flops(loop, (32, 64), (10, 64, 64)) == pytest.approx(
            jax_flops(scanned, (32, 64), (10, 64, 64)), rel=0.01)

    def test_nested_loops_multiply(self):
        def nested(x, ws):
            for i in range(ws.shape[0]):
                for j in range(ws.shape[1]):
                    x = x @ ws[i, j]
            return x

        def scanned(x, ws):
            def outer(c, wpair):
                return jax.lax.scan(lambda c2, w: (c2 @ w, None), c, wpair)[0], None
            return jax.lax.scan(outer, x, ws)[0]

        want = 12 * 2 * 16 * 32 * 32
        assert torch_flops(nested, (16, 32), (4, 3, 32, 32)) == want
        assert want == pytest.approx(jax_flops(scanned, (16, 32), (4, 3, 32, 32)), rel=0.01)

    def test_batched_einsum(self):
        want = 2 * 8 * 16 * 32 * 24
        got = torch_flops(lambda a, b: torch.einsum("bij,bjk->bik", a, b), (8, 16, 32), (8, 32, 24))
        assert got == want
        assert got == pytest.approx(
            jax_flops(lambda a, b: jnp.einsum("bij,bjk->bik", a, b), (8, 16, 32), (8, 32, 24)), rel=0.01)

    def test_matmul_family_equals_flop_counter_mode(self):
        def f(x, w, b):
            h = torch.nn.functional.linear(x, w, b)
            return torch.baddbmm(h.view(2, 4, 8)[..., :4], h.view(2, 4, 8), h.view(2, 8, 4)).sum()

        x, w, b = torch.randn(8, 16), torch.randn(8, 16), torch.randn(8)
        fc = FlopCounterMode(display=False)
        with fc:
            f(x, w, b)
        _, costs = count(f, x, w, b)
        reductions = 2 * 4 * 4 * 4 / 4  # the final sum: operand bytes / 4
        assert costs.flops == fc.get_total_flops() + reductions


class TestReductions:
    def test_operand_bytes_over_four_each(self):
        x = torch.randn(100, 32)
        assert count(lambda t: t.sum(), x)[1].flops == 100 * 32
        assert count(lambda t: t.amax(dim=-1), x)[1].flops == 100 * 32
        assert count(lambda t: torch.softmax(t, dim=-1), x)[1].flops == 2 * 100 * 32  # max, then sum
        assert count(lambda t: t.to(torch.bfloat16).sum(), x)[1].flops == 100 * 32 / 2  # bf16 bytes / 4

    def test_elementwise_max_is_no_reduction(self):
        x, y = torch.randn(10), torch.randn(10)
        assert count(torch.max, x, y)[1].flops == 0
        assert count(torch.max, x)[1].flops == 10


# ---------------------------------------------------------------------------
# traffic and peak bytes, by hand
# ---------------------------------------------------------------------------


class TestTraffic:
    def test_matmul_reads_both_operands_and_writes_the_result(self):
        a, b = torch.randn(64, 128), torch.randn(128, 32)
        _, c = count(lambda x, y: x @ y, a, b)
        assert c.traffic_bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)

    def test_a_view_costs_nothing(self):
        a = torch.randn(64, 128)
        _, c = count(lambda x: x.view(128, 64).t()[::2].unsqueeze(0).expand(3, -1, -1), a)
        assert c.traffic_bytes == 0 and c.n_ops > 0

    def test_an_inplace_slice_write_costs_twice_the_slice(self):
        big, small = torch.zeros(100, 32), torch.randn(10, 32)

        def write(b, s):
            b[20:30] = s

        _, c = count(write, big, small)
        assert c.traffic_bytes == 2 * 10 * 32 * 4

    def test_an_index_put_costs_twice_the_values_plus_the_index(self):
        big, vals, idx = torch.zeros(100, 8), torch.randn(5, 8), torch.tensor([1, 3, 5, 7, 9])

        def put(b, i, v):
            b.index_put_((i,), v)

        _, c = count(put, big, idx, vals)
        assert c.traffic_bytes == 2 * 5 * 8 * 4 + 5 * 8

    def test_a_broadcast_operand_counts_the_bytes_it_addresses(self):
        x, b = torch.randn(64, 32), torch.randn(32)
        _, c = count(lambda t, u: t + u, x, b)
        assert c.traffic_bytes == 4 * (64 * 32 + 32 + 64 * 32)
        assert tensor_bytes(b.expand(64, 32)) == 32 * 4

    def test_an_inplace_update_reads_and_writes_its_target(self):
        x, y = torch.randn(64), torch.randn(64)
        _, c = count(lambda t, u: t.add_(u), x, y)
        assert c.traffic_bytes == 3 * 64 * 4


class TestPeakBytes:
    def test_alloc_free_sequence(self):
        def seq():
            a = torch.empty(1000)  # 4,000 live
            b = torch.empty(500)  # 6,000
            del a  # 2,000
            c = torch.empty(2000)  # 10,000: the peak
            del b, c
            d = torch.empty(100)  # 400
            return d

        counter = CostCounter()
        with counter:
            d = seq()
        assert counter.costs.peak_bytes == 10_000
        assert counter.live_bytes == 400
        del d
        assert counter.live_bytes == 0

    def test_tracked_state_counts_from_the_start(self):
        state = {"w": torch.empty(1000), "m": [torch.empty(250)]}
        _, c = count(lambda: torch.empty(10), track=(state,))
        assert c.peak_bytes == 5_040

    def test_a_view_shares_its_base(self):
        def f():
            a = torch.empty(1000)
            return a[:10], a.view(10, 100)

        _, c = count(f)
        assert c.peak_bytes == 4_000


def _mlp_step(fake: bool):
    """Two linear layers, a loss and an SGD step on real or fake tensors."""
    with FakeTensorMode() if fake else contextlib.nullcontext():
        g = torch.Generator().manual_seed(0)
        w1 = torch.randn(64, 32, generator=g).requires_grad_()
        w2 = torch.randn(32, 8, generator=g).requires_grad_()
        x = torch.randn(16, 64, generator=g)
        counter = CostCounter()
        counter.track([w1, w2, x])
        counter.reset_peak()
        with counter:
            loss = torch.tanh(x @ w1).matmul(w2).pow(2).mean()
            g1, g2 = torch.autograd.grad(loss, [w1, w2])
            with torch.no_grad():
                w1.sub_(0.1 * g1)
                w2.sub_(0.1 * g2)
        return counter.costs


def test_real_and_fake_tensors_count_alike():
    real, fake = _mlp_step(False), _mlp_step(True)
    assert (real.flops, real.traffic_bytes, real.peak_bytes, real.n_ops) == \
        (fake.flops, fake.traffic_bytes, fake.peak_bytes, fake.n_ops)
    # forward 2 matmuls, backward 3 (no input gradient of x is asked for)
    assert real.flops >= 2 * (16 * 64 * 32 + 16 * 32 * 8) + 2 * (32 * 16 * 8 + 16 * 8 * 32 + 64 * 16 * 32)


# ---------------------------------------------------------------------------
# the roofline and the breakdown
# ---------------------------------------------------------------------------


class TestRooflineTerms:
    def test_dominant_selection(self):
        hw = {"peak_flops_bf16": 100.0, "hbm_bw": 10.0, "ici_bw": 1.0}
        t = roofline_terms(flops=1000.0, hlo_bytes=10.0, coll_bytes=0.0, chips=1, hw=hw)
        assert t["dominant"] == "compute"
        assert t["roofline_fraction"] == pytest.approx(1.0)
        t2 = roofline_terms(flops=10.0, hlo_bytes=1000.0, coll_bytes=0.0, chips=1, hw=hw)
        assert t2["dominant"] == "memory"
        assert t2["roofline_fraction"] < 0.01

    def test_equals_the_references_on_the_h100(self):
        for args in ((1e15, 1e12, 0.0, 1), (1e12, 5e12, 1e9, 256), (3e14, 2e13, 4e11, 512)):
            for per_device in (True, False):
                assert roofline_terms(*args, HW, per_device) == jax_roofline_terms(*args, HW, per_device)

    def test_a_step_against_the_data_sheet(self):
        t = roofline_terms(989e12, 3.35e12, 0.0, 1, HW)
        assert t["t_compute_s"] == pytest.approx(1.0) and t["t_memory_s"] == pytest.approx(1.0)


def _recorded():
    def f(x, w):
        h = x @ w
        return (h * 2).sum(), h.t().contiguous()

    return count(f, torch.randn(32, 64), torch.randn(64, 16), record_ops=True)[1]


def test_breakdown_ranks_ops_and_names_their_lines():
    costs = _recorded()
    rows = breakdown.top_traffic(costs, 10)
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    assert sum(r[0] for r in rows) == costs.traffic_bytes
    mm = next(r for r in rows if r[2] == "aten.mm")
    assert mm[:2] == (4 * (32 * 64 + 64 * 16 + 32 * 16), 1) and mm[3] == "float32[32,16]"
    assert mm[5] == "forward"
    assert breakdown.top_collectives(costs) == []


def test_breakdown_names_the_issuing_line_and_the_backward_node():
    from repro_torch.models import layers

    x, s = torch.randn(4, 8, requires_grad=True), torch.zeros(8, requires_grad=True)
    with torch.enable_grad():
        _, costs = count(lambda: torch.autograd.grad(layers.rms_norm(x, s).sum(), [x]), record_ops=True)
    wheres = {r.where for r in costs.ops}
    assert any(w.startswith("models/layers.py:") and w.endswith(" rms_norm") for w in wheres), wheres
    assert any(r.node.endswith("Backward0") for r in costs.ops)


def test_collective_stats_reads_records():
    costs = OpCosts()
    costs.ops = [type("R", (), {"coll_type": t, "coll_bytes": b})() for t, b in
                 (("all-reduce", 10.0), ("", 0.0), ("all-reduce", 5.0), ("all-gather", 2.0))]
    st = collective_stats(costs)
    assert st.as_dict() == {"bytes_by_type": {"all-reduce": 15.0, "all-gather": 2.0},
                            "count_by_type": {"all-reduce": 2, "all-gather": 1}, "total_bytes": 17.0}
    assert collective_stats(_recorded()).total_bytes == 0


def test_as_dict_has_the_references_keys():
    from repro.roofline.hlo_costs import HloCosts

    assert set(HloCosts().as_dict()) | {"peak_bytes"} == set(OpCosts().as_dict())
    assert np.isfinite(list(OpCosts().as_dict().values())[0])
