"""The per-site mesh: ``launch.mesh.make_site_mesh``/``make_multihost_mesh``
and ``allgather_stats``, ``GridRuntime.for_sites`` and its ``sync`` modes,
and ``vcluster_shard_map``, held bit for bit to the JAX package's
4-device ``shard_map`` runs.

The port's mesh is one gloo process a site.  A 4-process group (one rank
a site) runs ``vcluster_shard_map`` and the SPMD-redundant
``GridRuntime.for_sites(4, backend=MultiHostBackend(partition_sites=False))``
on the same points as the JAX package's ``vcluster_shard_map`` and
``GridRuntime(sync="shard_map")`` over 4 host devices (a subprocess with
``--xla_force_host_platform_device_count=4``, as ``tests/test_vclustering.py``
runs them).  ``jax.random`` cannot be redrawn in torch, so the JAX
k-means++ draws reach the ranks through ``init_centers`` as an ``.npy``.
Every rank counts its gathers with a spy on ``mesh.allgather_stats``.  A
2-process group with 4 sites has no mesh: ``auto`` falls back to the
pooled merge, and ``shard_map`` raises the reference's messages.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.core import vclustering as jvc
from repro.data import synthetic as jsyn
from repro.runtime import GridRuntime as JaxGridRuntime
from repro.workflow.registry import get_workload as jax_workload
from repro_torch.core import vclustering as tvc
from repro_torch.core.stats import SuffStats
from repro_torch.launch import mesh
from repro_torch.launch.serve import MiningService
from repro_torch.runtime import GridRuntime
from repro_torch.runtime.backends import MultiHostBackend
from repro_torch.runtime.gridruntime import RuntimeRun
from repro_torch.workflow.registry import get_workload

SRC = str(Path(__file__).resolve().parent.parent / "src")
N_SITES, K_LOCAL, ITERS, BORDER = 4, 6, 15, 4
CHILD_TIMEOUT_S = 120
MARKER = "SITE_MESH "


def _sites() -> np.ndarray:
    """(4, 500, 2) float32: the reference's shard_map test points."""
    pts, _ = jsyn.gaussian_mixture(0, 2000, 2, 4, spread=12.0, sigma=0.5)
    return jsyn.split_sites(pts, N_SITES, seed=1).astype(np.float32)


def _jax_init(xs: np.ndarray, seed: int = 0) -> np.ndarray:
    """The per-site k-means++ centres both JAX entry points draw for ``seed``."""
    keys = jax.random.split(jax.random.PRNGKey(seed), xs.shape[0])
    return np.stack([np.asarray(jkm.kmeans_plus_plus_init(keys[i], jnp.asarray(xs[i]), K_LOCAL))
                     for i in range(xs.shape[0])])


def _cfg() -> tvc.VClusterConfig:
    return tvc.VClusterConfig(k_local=K_LOCAL, kmeans_iters=ITERS, border_candidates=BORDER, use_kernel=False)


def _digest(result) -> dict:
    return get_workload("vclustering").digest(result)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


def test_make_site_mesh_without_a_group():
    assert mesh.make_site_mesh(4, device="cpu") is None
    one = mesh.make_site_mesh(1, device="cpu")
    assert (one.axis, one.shape, one.ranks, one.group) == ("sites", {"sites": 1}, (0,), None)
    assert one.coordinate() == 0 and one.device == torch.device("cpu")
    assert mesh.make_multihost_mesh(device="cpu").shape == {"sites": 1}
    assert mesh.make_multihost_mesh(3, device="cpu") is None
    assert mesh.make_site_mesh(0, device="cpu") is None


def test_one_site_gather_is_the_identity():
    g = torch.Generator().manual_seed(0)
    st = SuffStats(sizes=torch.rand(5, generator=g), centers=torch.rand(5, 3, generator=g),
                   sse=torch.rand(5, generator=g))
    out = mesh.allgather_stats(st, mesh.make_site_mesh(1, device="cpu"))
    for a, b in zip(out, st):
        assert a.shape == (1, *b.shape) and torch.equal(a[0], b)
    with pytest.raises(ValueError, match="float32"):
        mesh.allgather_stats(SuffStats(*(t.double() for t in st)), mesh.make_site_mesh(1, device="cpu"))


def test_mesh_constructors_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: mesh.make_site_mesh(4), lambda: mesh.make_site_mesh(1), mesh.make_multihost_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_unknown_sync_mode_raises():
    with pytest.raises(ValueError, match="unknown sync mode 'bogus'"):
        GridRuntime(sync="bogus", device="cpu")


def test_shard_map_sync_requires_a_mesh():
    rt = GridRuntime(sync="shard_map", device="cpu", use_kernel=False)
    with pytest.raises(RuntimeError, match=r"shard_map sync requires a mesh with sites=4 \(have None\)"):
        rt.run("vclustering", _sites(), {"cfg": _cfg()})


def test_for_sites_without_a_group_runs_pooled_and_equals_jax():
    xs = _sites()
    cfg_j = jvc.VClusterConfig(k_local=K_LOCAL, kmeans_iters=ITERS, border_candidates=BORDER, use_kernel=False)
    jrun = JaxGridRuntime(sync="pooled", use_kernel=False).run_vclustering(jax.random.PRNGKey(0), xs, cfg_j)
    rt = GridRuntime.for_sites(N_SITES, device="cpu", use_kernel=False)
    assert rt.mesh is None and rt.sync == "auto"
    run = rt.run("vclustering", xs, {"cfg": _cfg(), "init_centers": _jax_init(xs)})
    assert (run.sync_mode, jrun.sync_mode) == ("pooled", "pooled")
    assert _digest(run.result) == jax_workload("vclustering").digest(jrun.result)


def test_one_site_mesh_equals_jax_one_device_shard_map():
    """One site is a one-process mesh on both sides: the gather is the
    identity, the mode is shard_map."""
    xs = _sites()[:1]
    cfg_j = jvc.VClusterConfig(k_local=K_LOCAL, kmeans_iters=ITERS, border_candidates=BORDER, use_kernel=False)
    jrun = JaxGridRuntime.for_sites(1, use_kernel=False).run_vclustering(jax.random.PRNGKey(0), xs, cfg_j)
    run = GridRuntime.for_sites(1, device="cpu", use_kernel=False).run(
        "vclustering", xs, {"cfg": _cfg(), "init_centers": _jax_init(xs)})
    assert (run.sync_mode, jrun.sync_mode) == ("shard_map", "shard_map")
    assert _digest(run.result) == jax_workload("vclustering").digest(jrun.result)
    one = mesh.make_site_mesh(1, device="cpu")
    labels, merged = tvc.vcluster_shard_map(one, "sites", _cfg())(xs.reshape(-1, 2), seed=3)
    ref = tvc.vcluster_pooled(torch.from_numpy(xs), _cfg(), seed=3)
    assert torch.equal(labels, ref.labels.reshape(-1)) and torch.equal(merged.labels, ref.merged.labels)
    assert (merged.n_global, merged.n_merges) == (ref.merged.n_global, ref.merged.n_merges)


def test_the_defaults_name_the_pooled_merge():
    assert RuntimeRun(result=None, report=None).sync_mode == "pooled"
    assert MiningService(device="cpu").runtime.sync == "pooled"
    assert MultiHostBackend().describe()["mesh_shape"] == {"sites": 1}


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------

JAX_CHILD = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from repro.core.vclustering import VClusterConfig, vcluster_shard_map
    from repro.runtime import GridRuntime
    from repro.workflow.registry import get_workload

    xs = np.load({data!r})
    cfg = VClusterConfig(k_local={k}, kmeans_iters={iters}, border_candidates={border}, use_kernel=False)
    key = jax.random.PRNGKey(0)
    fn = vcluster_shard_map(jax.make_mesh((4,), ("sites",)), "sites", cfg)
    labels, merged = fn(jax.random.split(key, 4), jnp.asarray(xs.reshape(-1, xs.shape[-1])))
    run = GridRuntime(sync="shard_map", use_kernel=False).run_vclustering(key, xs, cfg)
    print({marker!r} + json.dumps({{
        "labels": np.asarray(labels).astype(int).tolist(),
        "merge_labels": np.asarray(merged.labels).astype(int).tolist(),
        "n_global": int(merged.n_global), "n_merges": int(merged.n_merges),
        "sync_mode": run.sync_mode, "digest": get_workload("vclustering").digest(run.result),
    }}), flush=True)
    """
)

PORT_CHILD = textwrap.dedent(
    """
    import json, sys
    sys.path.insert(0, {src!r})
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.core.vclustering import VClusterConfig, vcluster_pooled, vcluster_shard_map
    from repro_torch.launch import mesh
    from repro_torch.runtime import GridRuntime
    from repro_torch.runtime.backends import MultiHostBackend
    from repro_torch.workflow.engine import Engine
    from repro_torch.workflow.faults import FaultInjector
    from repro_torch.workflow.registry import get_workload

    pid, nprocs = int(sys.argv[1]), int(sys.argv[2])
    torch.set_num_threads(1)
    digest = get_workload("vclustering").digest
    xs = np.load({data!r})
    init = np.load({init!r})
    cfg = VClusterConfig(k_local={k}, kmeans_iters={iters}, border_candidates={border}, use_kernel=False)
    mesh.init_multihost("127.0.0.1:{port}", nprocs, pid, timeout=60)
    gathers = [0]
    real = mesh.allgather_stats

    def spy(stats, m):
        gathers[0] += 1
        return real(stats, m)

    mesh.allgather_stats = spy

    def counted(fn):
        before = gathers[0]
        out = fn()
        return out, gathers[0] - before

    def raises(fn):
        before = gathers[0]
        try:
            fn()
        except (RuntimeError, ValueError) as e:
            return [type(e).__name__, str(e), gathers[0] - before]
        return None

    def pooled(**params):
        return GridRuntime(sync="pooled", backend="inline", device="cpu", use_kernel=False).run(
            "vclustering", xs, dict(cfg=cfg, **params))

    out = {{"pid": pid}}
    if nprocs == 4:
        m = mesh.make_site_mesh(4, device="cpu")
        out["mesh"] = [m.shape, list(m.ranks), m.coordinate()]
        fn = vcluster_shard_map(m, "sites", cfg)
        (labels, merged), n = counted(lambda: fn(xs.reshape(-1, xs.shape[-1]), init_centers=init))
        out["shard_map"] = {{"labels": labels.tolist(), "merge_labels": merged.labels.tolist(),
                             "n_global": merged.n_global, "n_merges": merged.n_merges, "gathers": n}}
        # seeded: site i draws from site_generator(seed, i), as in vcluster_pooled
        (labels, merged), n = counted(lambda: fn(torch.from_numpy(xs.reshape(-1, xs.shape[-1])), seed=5))
        ref = vcluster_pooled(torch.from_numpy(xs), cfg, seed=5)
        out["seeded_equal"] = [bool(torch.equal(labels, ref.labels.reshape(-1))),
                               bool(torch.equal(merged.labels, ref.merged.labels)),
                               (merged.n_global, merged.n_merges) == (ref.merged.n_global, ref.merged.n_merges), n]

        def spmd(**engine_kw):
            eng = Engine(backend=MultiHostBackend(partition_sites=False), **engine_kw)
            return GridRuntime.for_sites(4, engine=eng, device="cpu", use_kernel=False)

        rt = GridRuntime.for_sites(4, backend=MultiHostBackend(partition_sites=False), device="cpu", use_kernel=False)
        run, n = counted(lambda: rt.run("vclustering", xs, {{"cfg": cfg, "init_centers": init}}))
        out["runtime"] = {{"sync_mode": run.sync_mode, "digest": digest(run.result), "gathers": n,
                           "describe_mesh": rt.engine.backend.describe()["mesh_shape"]}}
        params = [{{"cfg": cfg, "seed": 0}}, {{"cfg": cfg, "seed": 1}}]
        runs, n = counted(lambda: rt.run_many("vclustering", [xs, xs], params))
        out["run_many"] = {{"digests": [digest(r.result) for r in runs], "gathers": n,
                            "serial": [digest(pooled(seed=0).result), digest(pooled(seed=1).result)]}}
        out["run_many_async"] = raises(
            lambda: spmd(schedule="async").run_many("vclustering", [xs, xs], params))
        given = {{"cfg": cfg, "init_centers": init}}
        run, n = counted(lambda: spmd(faults=FaultInjector(fail={{"merge": 1}})).run("vclustering", xs, given))
        out["fault"] = {{"sync_mode": run.sync_mode, "digest": digest(run.result), "gathers": n,
                         "retries": run.report.retries}}
        out["speculation"] = {{}}
        for schedule in ("staged", "async"):
            run, n = counted(lambda: spmd(straggler_factor=1e-9, schedule=schedule).run("vclustering", xs, given))
            out["speculation"][schedule] = {{"digest": digest(run.result), "gathers": n,
                                             "speculative": run.report.speculative}}
        out["larger_group"] = raises(lambda: mesh.make_site_mesh(2, device="cpu"))
    else:
        out["site_mesh_4"] = mesh.make_site_mesh(4, device="cpu") is None
        out["multihost_mesh"] = mesh.make_multihost_mesh(device="cpu").shape
        rt = GridRuntime.for_sites(4, backend="inline", device="cpu", use_kernel=False)
        run, n = counted(lambda: rt.run("vclustering", xs, {{"cfg": cfg, "init_centers": init}}))
        out["auto"] = {{"mesh": rt.mesh, "sync_mode": run.sync_mode, "digest": digest(run.result), "gathers": n}}
        out["shard_map"] = raises(lambda: GridRuntime(sync="shard_map", device="cpu", use_kernel=False).run(
            "vclustering", xs, {{"cfg": cfg}}))
        be = MultiHostBackend()
        run = GridRuntime(backend=be, device="cpu", use_kernel=False).run(
            "vclustering", xs, {{"cfg": cfg, "init_centers": init}})
        out["partitioned_auto"] = {{"sync_mode": run.sync_mode, "digest": digest(run.result),
                                    "owned_sites": list(run.owned_sites)}}
        out["partitioned_shard_map"] = raises(lambda: GridRuntime(
            backend=be, sync="shard_map", device="cpu", use_kernel=False).run("vclustering", xs, {{"cfg": cfg}}))
    out["reference"] = digest(pooled(init_centers=init).result)
    print({marker!r} + json.dumps(out), flush=True)
    dist.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _marker(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith(MARKER)]
    assert len(lines) == 1, f"no report line in:\n{out}"
    return json.loads(lines[0][len(MARKER):])


def _wait(procs) -> list[str]:
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            assert p.returncode == 0, f"child failed:\nstdout:\n{out}\nstderr:\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The JAX package's 4-device runs, a 4-process group and a 2-process
    group of the port, all started together; each process's report."""
    tmp = tmp_path_factory.mktemp("site_mesh")
    xs = _sites()
    np.save(tmp / "xs.npy", xs)
    np.save(tmp / "init.npy", _jax_init(xs))
    fmt = dict(src=SRC, data=str(tmp / "xs.npy"), init=str(tmp / "init.npy"), k=K_LOCAL, iters=ITERS,
               border=BORDER, marker=MARKER)
    (tmp / "jax_child.py").write_text(JAX_CHILD.format(**fmt))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = {"jax": [subprocess.Popen([sys.executable, str(tmp / "jax_child.py")], stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True, env=env)]}
    for nprocs in (4, 2):
        script = tmp / f"port_child_{nprocs}.py"
        script.write_text(PORT_CHILD.format(port=_free_port(), **fmt))
        procs[nprocs] = [subprocess.Popen([sys.executable, str(script), str(pid), str(nprocs)],
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                         for pid in range(nprocs)]
    try:
        out = {name: [_marker(o) for o in _wait(ps)] for name, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out["jax"] = out["jax"][0]
    return out


def test_four_ranks_form_one_mesh(groups):
    for pid, r in enumerate(groups[4]):
        assert r["pid"] == pid
        assert r["mesh"] == [{"sites": 4}, [0, 1, 2, 3], pid]
        assert r["runtime"]["describe_mesh"] == {"sites": 4}


def test_vcluster_shard_map_equals_jax_on_every_rank(groups):
    want = groups["jax"]
    for r in groups[4]:
        got = r["shard_map"]
        assert got["labels"] == want["labels"]
        assert got["merge_labels"] == want["merge_labels"]
        assert (got["n_global"], got["n_merges"]) == (want["n_global"], want["n_merges"])
        assert got["gathers"] == 1
        assert r["seeded_equal"] == [True, True, True, 1]
    assert want["n_global"] > 1 and want["n_merges"] > 0


def test_runtime_mesh_sync_equals_jax_shard_map_on_every_rank(groups):
    want = groups["jax"]
    assert want["sync_mode"] == "shard_map"
    for r in groups[4]:
        got = r["runtime"]
        assert got["sync_mode"] == "shard_map"
        assert got["digest"] == want["digest"] == r["reference"]
        assert got["gathers"] == 1


def test_run_many_enters_the_gather_once_a_member(groups):
    for r in groups[4]:
        rm = r["run_many"]
        assert rm["digests"] == rm["serial"] == groups[4][0]["run_many"]["serial"]
        assert rm["gathers"] == 2
        kind, msg, n = r["run_many_async"]
        assert kind == "RuntimeError" and "schedule='staged'" in msg and n == 0


def test_seeded_merge_fault_retries_alike_on_every_rank(groups):
    for r in groups[4]:
        f = r["fault"]
        assert (f["sync_mode"], f["retries"], f["gathers"]) == ("shard_map", 1, 1)
        assert f["digest"] == groups["jax"]["digest"]


def test_speculation_never_runs_the_merge_twice(groups):
    """The engine's speculative copy lives on the simulated clock only:
    the merge's callable, and so its gather, runs once on every rank."""
    for r in groups[4]:
        for schedule, s in r["speculation"].items():
            assert s["speculative"] > 0, schedule
            assert s["gathers"] == 1 and s["digest"] == groups["jax"]["digest"], schedule


def test_a_group_larger_than_the_mesh_is_refused(groups):
    for r in groups[4]:
        kind, msg, _ = r["larger_group"]
        assert kind == "ValueError" and "4 processes for 2 sites" in msg


def test_undersized_group_falls_back_to_pooled(groups):
    for r in groups[2]:
        assert r["site_mesh_4"] is True and r["multihost_mesh"] == {"sites": 2}
        auto = r["auto"]
        assert (auto["mesh"], auto["sync_mode"], auto["gathers"]) == (None, "pooled", 0)
        assert auto["digest"] == r["reference"] == groups["jax"]["digest"]
        kind, msg, n = r["shard_map"]
        assert kind == "RuntimeError" and msg == "shard_map sync requires a mesh with sites=4 (have None)" and n == 0


def test_partitioned_runs_refuse_the_mesh_sync(groups):
    owned = []
    for r in groups[2]:
        assert r["partitioned_auto"]["sync_mode"] == "pooled"
        assert r["partitioned_auto"]["digest"] == groups["jax"]["digest"]
        owned += r["partitioned_auto"]["owned_sites"]
        kind, msg, n = r["partitioned_shard_map"]
        assert kind == "RuntimeError" and n == 0
        assert msg == (
            "sync='shard_map' is not supported on a site-partitioned multi-process runtime: the merge job "
            "executes on its owning process only; use sync='pooled' (bit-identical logical merge) or "
            "MultiHostBackend(partition_sites=False)"
        )
    assert sorted(owned) == [0, 1, 2, 3]
