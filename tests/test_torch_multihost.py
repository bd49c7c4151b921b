"""The port's multi-host layer: the ownership map against the JAX
package's, the payload wire, the single-process fallback and the forced
partition, owner shipping and shipped errors, the engine's ownership
contract, ``merge_owner_times``, and a two-process gloo smoke test with
the JAX package's assertions (``tests/test_multihost.py``).

The JAX package is imported inside the tests that compare against it, so
the ``cuda``-marked round trip also runs on a machine with a card and no
JAX: ``python -m pytest -q -m cuda tests/test_torch_multihost.py``.
"""

import dataclasses
import json
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path
from typing import NamedTuple

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.compat import pack_payload, unpack_payload
from repro_torch.core.apriori import LocalMineResult, TransactionDB
from repro_torch.launch.mesh import allgather_bytes, allgather_payload, init_multihost, site_ownership
from repro_torch.runtime import GridRuntime
from repro_torch.runtime.backends import MultiHostBackend
from repro_torch.workflow.dag import DAG, TimedResult
from repro_torch.workflow.engine import Engine, RunReport
from repro_torch.workflow.executor import ExecutionBackend, Partition, resolve_backend
from repro_torch.workflow.overhead import GridModel
from repro_torch.workflow.sitejob import merge_owner_times, timed_batch

SRC = str(Path(__file__).resolve().parent.parent / "src")
ZERO = GridModel(prep_latency_s=0.0)


def _compute_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


# ---------------------------------------------------------------------------
# site ownership
# ---------------------------------------------------------------------------


class TestSiteOwnership:
    def test_round_robin_uniform(self):
        assert site_ownership([0, 1, 2, 3], n_processes=2) == {0: 0, 1: 1, 2: 0, 3: 1}
        assert site_ownership([0, 1, 2, 3, 4], n_processes=3) == {0: 0, 1: 1, 2: 2, 3: 0, 4: 1}

    def test_single_process_and_order(self):
        assert set(site_ownership([0, 5, 9], n_processes=1).values()) == {0}
        assert site_ownership([3, 1, 2, 0], n_processes=2) == site_ownership([0, 1, 2, 3], n_processes=2)
        # alone, the default process count is this process's
        assert site_ownership([4, 7]) == {4: 0, 7: 0}

    def test_capacity_proportional(self):
        # 2 local devices on p0, 1 on p1: p0 owns 2 of 3 sites
        assert site_ownership([0, 1, 2], capacity={0: 2, 1: 1}) == {0: 0, 1: 1, 2: 0}

    def test_weights(self):
        uniform = {s: 4.0 for s in range(4)}
        assert site_ownership([0, 1, 2, 3], n_processes=2, site_weights=uniform) == {0: 0, 1: 1, 2: 0, 3: 1}
        owner = site_ownership([0, 1, 2], n_processes=2, site_weights={0: 10.0, 1: 1.0, 2: 1.0})
        assert owner == {0: 0, 1: 1, 2: 1}

    def test_invalid_process_count(self):
        with pytest.raises(ValueError, match="n_processes"):
            site_ownership([0], n_processes=0)

    @settings(max_examples=60, deadline=None)
    @given(
        st.lists(st.integers(min_value=0, max_value=400), min_size=1, max_size=40),
        st.integers(min_value=1, max_value=5),
        st.lists(st.integers(min_value=1, max_value=4), min_size=1, max_size=5),
        st.one_of(st.none(), st.lists(st.floats(min_value=0.0, max_value=20.0), min_size=40, max_size=40)),
    )
    def test_equal_to_the_jax_packages(self, sites, n_proc, devices, weights):
        """Unit capacities, device capacities (the JAX mesh's per-process
        device counts) and per-site weights give the JAX package's map."""
        from repro.launch.mesh import site_ownership as jax_site_ownership

        w = None if weights is None else {s: weights[i % 40] for i, s in enumerate(sorted(set(sites)))}
        assert site_ownership(sites, n_processes=n_proc, site_weights=w) == jax_site_ownership(
            sites, n_processes=n_proc, site_weights=w
        )

        class _Dev:
            def __init__(self, p):
                self.process_index = p

        class _Mesh:
            class devices:
                flat = [_Dev(p) for p, n in enumerate(devices) for _ in range(n)]

        capacity = dict(enumerate(devices))
        assert site_ownership(sites, capacity=capacity, site_weights=w) == jax_site_ownership(
            sites, mesh=_Mesh(), site_weights=w
        )


# ---------------------------------------------------------------------------
# the payload wire
# ---------------------------------------------------------------------------


class _Pair(NamedTuple):
    a: torch.Tensor
    b: dict


def _same(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal dtype, shape and bits."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    flat = lambda t: t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)  # noqa: E731
    return torch.equal(flat(x), flat(y))


def _tensor_zoo(device) -> dict:
    gen = torch.Generator().manual_seed(0)
    base = torch.randn(5, 7, generator=gen)
    return {
        "f32": base.to(device),
        "bf16": base.to(torch.bfloat16).to(device),
        "f16": base.to(torch.float16).to(device),
        "i32": torch.randint(-(2**31), 2**31 - 1, (9,), generator=gen, dtype=torch.int64).to(torch.int32).to(device),
        "i64": torch.randint(-(2**62), 2**62, (3, 2), generator=gen).to(device),
        "u8": torch.randint(0, 256, (4,), generator=gen, dtype=torch.uint8).to(device),
        "bool": (base > 0).to(device),
        "scalar": torch.tensor(3.5, device=device),
        "empty": torch.zeros((0, 4), dtype=torch.int32, device=device),
        "strided": base.t().to(device),  # not contiguous
        "nan": torch.tensor([float("nan"), -0.0, float("inf")], device=device),
    }


def _check_round_trip(device):
    zoo = _tensor_zoo(device)
    db = TransactionDB(packed=zoo["i32"].reshape(3, 3), n_items=70, n_tx=3)
    lm = LocalMineResult(counts={(2, 1): 7, (0,): 3}, frequent={1: [(0,)], 2: [(2, 1)]},
                         count_calls=2, candidates_counted=5)
    payload = TimedResult({"zoo": zoo, "pair": _Pair(zoo["bf16"], {"db": db}), "lm": lm,
                           "order": {"z": 1, "a": 2}}, 0.25)
    out = unpack_payload(pack_payload(payload))
    assert isinstance(out, TimedResult) and out.compute_s == 0.25
    for name, t in zoo.items():
        got = out.value["zoo"][name]
        assert isinstance(got, torch.Tensor) and got.device.type == torch.device(device).type, name
        assert _same(got, t) and got.is_contiguous(), name
    pair = out.value["pair"]
    assert isinstance(pair, _Pair) and _same(pair.a, zoo["bf16"]) and pair.a.dtype == torch.bfloat16
    got_db = pair.b["db"]
    assert isinstance(got_db, TransactionDB) and (got_db.n_items, got_db.n_tx) == (70, 3)
    assert _same(got_db.packed, db.packed) and got_db.packed.device.type == torch.device(device).type
    assert out.value["lm"] == lm
    assert list(out.value["order"]) == ["z", "a"]  # keys keep their order
    return out


class TestPayload:
    def test_round_trip_on_the_cpu(self):
        _check_round_trip("cpu")

    def test_wire_is_plain_pickle(self):
        # no process group and no custom unpickler needed to decode
        data = pack_payload([1, "x", None, torch.arange(3)])
        got = pickle.loads(data)
        assert got[:3] == [1, "x", None] and torch.equal(got[3], torch.arange(3))

    def test_shares_no_storage_with_the_sender(self):
        t = torch.arange(4)
        got = unpack_payload(pack_payload(t))
        got[0] = 99
        assert int(t[0]) == 0

    def test_allgather_single_process_identity(self):
        assert allgather_bytes(b"abc") == [b"abc"]
        assert allgather_bytes(b"") == [b""]
        got = allgather_payload({"t": torch.ones(2)})
        assert len(got) == 1 and torch.equal(got[0]["t"], torch.ones(2))

    def test_init_multihost_without_coordinator_is_single_process(self):
        assert init_multihost() is False
        with pytest.raises(ValueError, match="together"):
            init_multihost("127.0.0.1:1", num_processes=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the round trip restores tensors onto it")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_round_trip_restores_tensors_on_the_card(cuda_device):
    out = _check_round_trip(cuda_device)
    assert out.value["zoo"]["f32"].device == torch.device("cuda", torch.cuda.current_device())
    # a shipped result meets the card's tensors in later jobs
    assert torch.equal(out.value["zoo"]["f32"] + _tensor_zoo(cuda_device)["f32"], 2 * _tensor_zoo(cuda_device)["f32"])


# ---------------------------------------------------------------------------
# the backend on one process
# ---------------------------------------------------------------------------


def _owned_partition(*names, sites=(0,)):
    return Partition(owned=frozenset(names), owner_of=dict.fromkeys(names, 0), n_processes=1,
                     process_index=0, owned_sites=tuple(sites))


class TestSingleProcess:
    def test_resolved_by_name(self):
        assert isinstance(resolve_backend("multihost"), MultiHostBackend)

    def test_describe_and_allgather_check(self):
        be = MultiHostBackend()
        info = be.describe()
        assert info["is_multiprocess"] is False
        assert (info["process_index"], info["process_count"], info["n_local_devices"]) == (0, 1, 1)
        assert (info["device"], info["capacity"], info["wire"]) == (_compute_device(), {"0": 1}, None)
        out = be.allgather_check(7.0)
        assert out.shape == (1, 1) and float(out[0, 0]) == 7.0

    def test_engine_runs_inline(self):
        dag = DAG("d")
        dag.job("a", lambda: 2)
        dag.job("b", lambda a: a + 3, deps=["a"])
        results = {}
        be = MultiHostBackend()
        rep = Engine(model=ZERO, backend=be).run(dag, results=results)
        assert results["b"] == 5 and rep.backend == "multihost"
        assert rep.n_processes == 1 and rep.owned_jobs is None and rep.shipments == 0
        assert be.executed_log == ["a", "b"] and be.shipped_log == []

    def test_partition_none_alone_or_disabled(self, monkeypatch):
        dag = DAG("d")
        dag.job("a", lambda: 1, site=0)
        assert MultiHostBackend().partition(dag, GridModel()) is None
        be = MultiHostBackend(partition_sites=False, force_partition=True)
        monkeypatch.setattr(be, "is_multiprocess", True)
        assert be.partition(dag, GridModel()) is None

    def test_force_partition_owns_everything(self):
        be = MultiHostBackend(force_partition=True)
        dag = DAG("d")
        dag.job("a", lambda: 1, site=0)
        dag.job("b", lambda: 2, site=1)
        dag.job("c", lambda: 3, site=0)
        part = be.partition(dag, GridModel())
        assert part.owned == frozenset({"a", "b", "c"}) and part.owner_of == {"a": 0, "b": 0, "c": 0}
        assert part.owned_sites == (0, 1) and (part.n_processes, part.process_index) == (1, 0)

    def test_owner_shipping_round_trips(self):
        """The per-job owner path: pack, gather (identity), unpack; an
        untimed callable gets the owner's host bracket, and the value the
        engine sees is the round-tripped one."""
        be = MultiHostBackend()
        dag = DAG("d")
        t = torch.arange(3)
        job = dag.job("a", lambda: {"frequent": {(0, 1): 7}, "t": t}, site=0)
        be._partition = _owned_partition("a")
        out = be.call(job, [])
        assert isinstance(out, TimedResult) and out.compute_s >= 0.0
        assert out.value["frequent"] == {(0, 1): 7} and torch.equal(out.value["t"], t)
        assert out.value["t"] is not t
        assert be.executed_log == ["a"] and be.shipped_log == [] and be.ledger()["shipments"] == 1

    @pytest.mark.parametrize("fuse", [False, True])
    def test_owned_job_exception_ships(self, fuse):
        """An owned job raising must not propagate before the collective
        (the peers would wait in all_gather): it ships, and every process
        raises it after the shipment."""

        def boom(*a):
            raise ValueError("corrupt site data")

        dag = DAG("d")
        dag.job("a", boom, site=0)
        be = MultiHostBackend(force_partition=True, fuse_waves=fuse)
        with pytest.raises(RuntimeError, match="failed on its owning process 0.*corrupt"):
            Engine(model=ZERO, backend=be).run(dag)
        assert be.executed_log == [] and be.shipments == 1

    def test_unpicklable_wave_result_ships_an_error(self):
        dag = DAG("d")
        dag.job("a", lambda: TimedResult(lambda: 0, 0.0), site=0)
        be = MultiHostBackend(force_partition=True)
        with pytest.raises(RuntimeError, match="failed on its owning process 0"):
            Engine(model=ZERO, backend=be).run(dag)
        assert be.executed_log == []

    @pytest.mark.parametrize("app", ["gfm", "fdm", "cd_apriori", "vclustering"])
    @pytest.mark.parametrize("fuse", [False, True])
    def test_forced_partition_matches_inline(self, app, fuse):
        """Every job owned here, every result through the wire: the same
        digest and fingerprint as inline, and a ledger that adds up."""
        from repro_torch.runtime import conformance as tconf

        be = MultiHostBackend(force_partition=True, fuse_waves=fuse)
        run = tconf.run_app(app, 3, "staged", be)
        ref = tconf.run_app(app, 3, "staged", "inline")
        assert tconf.result_digest(app, run) == tconf.result_digest(app, ref)
        assert tconf.schedule_fingerprint(run.report) == tconf.schedule_fingerprint(ref.report)
        rep = run.report
        assert rep.owned_sites == (0, 1, 2) and run.owned_sites == (0, 1, 2) and rep.n_processes == 1
        assert rep.owned_jobs == tuple(sorted(rep.job_times)) and rep.shipped_results == 0
        assert rep.collective_rounds == 2 * rep.shipments
        assert rep.shipments == (be.waves if fuse else len(rep.job_times))
        if fuse:
            assert be.waves < len(rep.job_times)
        assert set(run.measured) == set(rep.job_times)


# ---------------------------------------------------------------------------
# the engine's ownership contract
# ---------------------------------------------------------------------------


class _RemoteStub(ExecutionBackend):
    """Claims another process owns some jobs."""

    name = "stub"

    def __init__(self, owned: set[str], ship_timed: bool = True):
        self._owned = owned
        self.ship_timed = ship_timed

    def partition(self, dag, model=None) -> Partition:
        owner_of = {n: (0 if n in self._owned else 1) for n in dag.jobs}
        return Partition(owned=frozenset(self._owned), owner_of=owner_of, n_processes=2,
                         process_index=0, owned_sites=(0,))

    def call(self, job, args):
        out = job.fn(*args)
        if job.name in self._owned:
            return out
        return TimedResult(out, 0.125) if self.ship_timed else out


def _two_site_dag():
    dag = DAG("d")
    dag.job("a", lambda: 1, site=0)
    dag.job("b", lambda a: a + 1, deps=["a"], site=1)
    return dag


class TestEngineOwnershipContract:
    def test_report_carries_partition(self):
        rep = Engine(model=ZERO, backend=_RemoteStub({"a"})).run(_two_site_dag())
        assert (rep.n_processes, rep.process_index) == (2, 0)
        assert rep.owned_jobs == ("a",) and rep.owned_sites == (0,)
        assert rep.job_times["b"] == pytest.approx(0.125)  # the owner's time

    def test_non_owned_job_must_ship_a_timed_result(self):
        eng = Engine(model=ZERO, backend=_RemoteStub({"a"}, ship_timed=False))
        with pytest.raises(RuntimeError, match="owner-measured TimedResult"):
            eng.run(_two_site_dag())

    def test_report_fields_are_the_jax_packages(self):
        from repro.workflow.engine import RunReport as JaxRunReport

        assert [f.name for f in dataclasses.fields(RunReport)] == [f.name for f in dataclasses.fields(JaxRunReport)]


class TestOwnerTimes:
    CASES = [
        ({"a": 0.1}, {"a": 0.2, "b": 0.3}, ("a",)),
        ({"a": 0.1, "b": 9.0}, {"a": 0.2, "b": 0.3}, ("a",)),  # a stale non-owned entry
        ({}, {"a": 0.2}, None),
        ({"a": 0.1}, {"a": 0.2, "c": 0.5}, None),
        ({"a": 0.1, "b": 0.4}, {"a": 0.2, "b": 0.3}, frozenset({"a", "b"})),
    ]

    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_merge_owner_times_matches_jax(self, case):
        from repro.workflow.sitejob import merge_owner_times as jax_merge

        measured, job_times, owned = self.CASES[case]
        got = merge_owner_times(dict(measured), job_times, owned)
        assert got == jax_merge(dict(measured), job_times, owned)
        assert set(got) == set(measured) | set(job_times)

    def test_stray_owned_name_raises(self):
        with pytest.raises(ValueError, match="not in the job_times ledger: ghost"):
            merge_owner_times({}, {"a": 0.1}, ("a", "ghost"))

    def test_timed_batch_records_owned_members_only(self):
        record: dict = {}
        fn = timed_batch(lambda bargs, argss: [x * 2 for x in bargs], record, owned=lambda n: n != "b")
        outs = fn(["a", "b", "c"], [1, 2, 3], [[], [], []])
        assert [o.value for o in outs] == [2, 4, 6]
        assert set(record) == {"a", "c"} and record["a"] == outs[0].compute_s


def test_gridruntime_threads_the_backend():
    rt = GridRuntime(backend="multihost", device="cpu")
    assert isinstance(rt.engine.backend, MultiHostBackend)
    be = MultiHostBackend(fuse_waves=False)
    assert GridRuntime(backend=be, device="cpu").engine.backend is be


# ---------------------------------------------------------------------------
# two processes, one gloo group
# ---------------------------------------------------------------------------

CHILD = textwrap.dedent(
    """
    import json, sys
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    from repro_torch.runtime.backends import MultiHostBackend
    from repro_torch.workflow.dag import DAG, TimedResult
    from repro_torch.workflow.engine import Engine
    from repro_torch.workflow.overhead import GridModel

    pid = int(sys.argv[1])
    be = MultiHostBackend(
        coordinator_address="127.0.0.1:{port}", num_processes=2, process_id=pid, timeout=60
    )
    info = be.describe()
    gathered = be.allgather_check(float(pid + 1)).reshape(-1).tolist()

    # two sites, two processes: site i's job must execute ONLY on its
    # owning process; results ship and agree everywhere
    dag = DAG("smoke")
    dag.job("a", lambda: TimedResult(torch.tensor([20]), 0.0), site=0)
    dag.job("b", lambda a: TimedResult(int(a[0]) + 22, 0.0), deps=["a"], site=1)
    results = {{}}
    rep = Engine(model=GridModel(prep_latency_s=0.0), backend=be).run(dag, results=results)
    print("MULTIHOST " + json.dumps({{
        "pid": pid,
        "info": info,
        "gathered": gathered,
        "result": int(results["b"]),
        "backend": rep.backend,
        "n_processes": rep.n_processes,
        "owned_jobs": list(rep.owned_jobs or []),
        "owned_sites": list(rep.owned_sites or []),
        "executed": list(be.executed_log),
        "shipped": sorted(be.shipped_log),
        "ledger": be.ledger(),
    }}), flush=True)
    torch.distributed.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_smoke(tmp_path):
    """Two processes, one gloo group: topology, a cross-process
    all_gather, true per-site ownership, and the same shipped results on
    both processes."""
    script = tmp_path / "child.py"
    script.write_text(CHILD.format(src=SRC, port=_free_port()))
    procs = [
        subprocess.Popen([sys.executable, str(script), str(pid)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, f"child failed:\nstdout:\n{out}\nstderr:\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    infos = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("MULTIHOST ")]
        assert lines, f"no smoke marker in child output: {out!r}"
        infos.append(json.loads(lines[0][len("MULTIHOST "):]))
    infos.sort(key=lambda d: d["pid"])
    for pid, info in enumerate(infos):
        topo = info["info"]
        assert topo["is_multiprocess"] is True and topo["process_count"] == 2 and topo["process_index"] == pid
        assert topo["n_local_devices"] == 1 and topo["capacity"] == {"0": 1, "1": 1}
        assert (topo["device"], topo["wire"]) == (_compute_device(), "gloo")
        assert info["gathered"] == [1.0, 2.0]  # the collective really crossed processes
        assert info["result"] == 42  # shipped results are identical on every process
        assert info["backend"] == "multihost" and info["n_processes"] == 2
        assert info["ledger"] == {"shipments": 2, "collective_rounds": 4, "shipped_results": 1}
    assert infos[0]["executed"] == ["a"] and infos[0]["shipped"] == ["b"]
    assert infos[1]["executed"] == ["b"] and infos[1]["shipped"] == ["a"]
    assert infos[0]["owned_jobs"] == ["a"] and infos[1]["owned_jobs"] == ["b"]
    assert infos[0]["owned_sites"] == [0] and infos[1]["owned_sites"] == [1]
