"""Algorithm 1 (variance-based clustering) end to end: the port against the
JAX package, on the CPU.

Both packages cluster the same seeded points.  ``jax.random`` draws cannot
be redrawn in torch, so the JAX package's per-site k-means++ centres are
handed to the port through ``init_centers``.  Runs are compared by each
package's registered ``vclustering`` digest (every point's global label,
n_global, n_merges, comm_bytes) and by the JAX conformance harness's
scheduling fingerprint under fixed placement: exact equality.  The merge
and the perturbation are also held to the JAX package's alone, on the same
JAX-made statistics and merge result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.core import stats as jst
from repro.core import vclustering as jvc
from repro.data import synthetic as jsyn
from repro.runtime import GridRuntime as JaxGridRuntime
from repro.runtime.conformance import schedule_fingerprint
from repro.workflow.registry import get_workload as jax_workload
from repro_torch.convert import init_centers_from_reference, site_points_from_reference
from repro_torch.core import stats as tst
from repro_torch.core import vclustering as tvc
from repro_torch.kernels import ops
from repro_torch.runtime import GridRuntime
from repro_torch.workflow.registry import get_workload

K_LOCAL, ITERS = 8, 10


def _sites(n_sites=4, n=3000, seed=7):
    pts, _ = jsyn.gaussian_mixture(seed, n_sites * n, 8, 12, spread=20.0, sigma=0.8)
    return jsyn.split_sites(pts, n_sites, seed=1)


def _jax_init(xs, seed=0, k=K_LOCAL):
    """The per-site k-means++ centres the JAX runtime draws for ``seed``
    (``vcluster_site_jobs`` splits ``PRNGKey(seed)`` over the sites)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), xs.shape[0])
    return np.stack([np.asarray(jkm.kmeans_plus_plus_init(keys[i], jnp.asarray(xs[i]), k)) for i in range(len(xs))])


def _digest(result) -> dict:
    return get_workload("vclustering").digest(result)


@pytest.mark.parametrize("schedule", ["staged", "async"])
@pytest.mark.parametrize("backend", ["inline", "batched"])
def test_runtime_vclustering_matches_jax(backend, schedule):
    xs = _sites()
    params = {"k_local": K_LOCAL, "iters": ITERS, "seed": 0}
    jrun = JaxGridRuntime(use_kernel=True, backend=backend, schedule=schedule).run("vclustering", xs, params)
    ops.reset_launches()
    trun = GridRuntime(backend=backend, schedule=schedule, device="cpu").run(
        "vclustering",
        site_points_from_reference(xs, "cpu"),
        {"k_local": K_LOCAL, "iters": ITERS, "init_centers": init_centers_from_reference(_jax_init(xs), "cpu")},
    )
    want = jax_workload("vclustering").digest(jrun.result)
    assert _digest(trun.result) == want
    assert want["n_global"] > 1 and want["n_merges"] > 0
    assert schedule_fingerprint(trun.report) == schedule_fingerprint(jrun.report)
    assert (trun.backend, trun.schedule, trun.placement, trun.sync_mode) == (backend, schedule, "fixed", "pooled")
    assert set(trun.measured) == set(trun.report.job_times)
    assert all(v == 0 for v in ops.LAUNCHES.values())  # CPU tensors launch nothing


def test_plain_assignment_path_matches_jax():
    """``use_kernel=False``: the matmul form and argmin on both sides."""
    xs = _sites(n_sites=3, n=2000)
    cfg_j = jvc.VClusterConfig(k_local=K_LOCAL, kmeans_iters=ITERS, use_kernel=False)
    jrun = JaxGridRuntime(use_kernel=False).run_vclustering(jax.random.PRNGKey(0), xs, cfg_j)
    cfg_t = tvc.VClusterConfig(k_local=K_LOCAL, kmeans_iters=ITERS, use_kernel=False)
    trun = GridRuntime(device="cpu", use_kernel=False).run_vclustering(
        xs, cfg_t, init_centers=_jax_init(xs)
    )
    assert _digest(trun.result) == jax_workload("vclustering").digest(jrun.result)


def test_vcluster_pooled_matches_jax():
    xs = _sites(n_sites=3, n=2000)
    cfg = dict(k_local=K_LOCAL, kmeans_iters=ITERS, use_kernel=True, border_candidates=4)
    j = jvc.vcluster_pooled(jax.random.PRNGKey(0), jnp.asarray(xs), jvc.VClusterConfig(**cfg))
    t = tvc.vcluster_pooled(torch.from_numpy(xs.copy()), tvc.VClusterConfig(**cfg),
                            init_centers=torch.from_numpy(_jax_init(xs)))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert (t.merged.n_global, t.merged.n_merges, t.comm_bytes) == (
        int(j.merged.n_global), int(j.merged.n_merges), int(j.comm_bytes))
    np.testing.assert_array_equal(t.site_stats.sizes.numpy(), np.asarray(j.site_stats.sizes))


def test_port_recovers_planted_structure():
    """The port on its own seeding (no JAX draws): every planted
    component maps onto one global cluster."""
    pts, comp = jsyn.gaussian_mixture(7, 4 * 5000, 8, 12, spread=20.0, sigma=0.8)
    perm = np.random.default_rng(1).permutation(len(pts))
    xs = pts[perm].reshape(4, -1, 8)
    run = GridRuntime(device="cpu").run("vclustering", xs, {"k_local": 20, "iters": 20, "seed": 0})
    labels = run.result.labels.numpy().reshape(-1)
    truth = comp[perm]
    hit = sum(np.bincount(labels[truth == c]).max() for c in np.unique(truth))
    assert hit / len(labels) >= 0.99
    assert run.result.merged.n_global == 12
    assert int(run.result.merged.stats.sizes.sum()) == len(labels)


def test_seeded_runs_repeat_and_differ_by_seed():
    xs = _sites(n_sites=3, n=1000)
    rt = GridRuntime(device="cpu")
    a = rt.run("vclustering", xs, {"k_local": 6, "iters": 5, "seed": 3})
    b = rt.run("vclustering", xs, {"k_local": 6, "iters": 5, "seed": 3})
    c = rt.run("vclustering", xs, {"k_local": 6, "iters": 5, "seed": 4})
    assert _digest(a.result) == _digest(b.result)
    assert not torch.equal(a.result.site_stats.centers, c.result.site_stats.centers)
    inline = GridRuntime(device="cpu", backend="inline", schedule="async").run(
        "vclustering", xs, {"k_local": 6, "iters": 5, "seed": 3})
    assert _digest(inline.result) == _digest(a.result)


def _jax_stats(xs, k=K_LOCAL):
    """JAX-made per-site stats and assignments (JAX's own kmeans)."""
    keys = jax.random.split(jax.random.PRNGKey(0), xs.shape[0])
    res = [jkm.kmeans(keys[i], jnp.asarray(xs[i]), k, iters=ITERS) for i in range(len(xs))]
    per_site = jst.SuffStats(*(jnp.stack([r.stats[f] for r in res]) for f in range(3)))
    return per_site, np.stack([np.asarray(r.assign) for r in res])


def _t_stats(st) -> tst.SuffStats:
    return tst.SuffStats(*(torch.from_numpy(np.array(f)) for f in st))


def _t_merged(m) -> tvc.MergeResult:
    return tvc.MergeResult(labels=torch.from_numpy(np.array(m.labels)), stats=_t_stats(m.stats),
                           n_merges=int(m.n_merges), n_global=int(m.n_global))


@pytest.mark.parametrize("criterion", ["increase", "merged_var"])
def test_merge_subclusters_matches_jax(criterion):
    per_site, _ = _jax_stats(_sites())
    flat = jst.stack_site_stats(per_site)
    tau = jvc.paper_threshold(flat, 2.0)
    j = jvc.merge_subclusters(flat, tau, criterion=criterion)
    tflat = _t_stats(flat)
    t = tvc.merge_subclusters(tflat, tvc.paper_threshold(tflat, 2.0), criterion=criterion)
    assert float(tvc.paper_threshold(tflat, 2.0)) == float(tau)
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert (t.n_merges, t.n_global) == (int(j.n_merges), int(j.n_global))
    np.testing.assert_array_equal(t.stats.sizes.numpy(), np.asarray(j.stats.sizes))
    np.testing.assert_allclose(t.stats.centers.numpy(), np.asarray(j.stats.centers), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t.stats.sse.numpy(), np.asarray(j.stats.sse), rtol=1e-4)
    assert torch.equal(tflat.sizes, torch.from_numpy(np.array(flat.sizes)))  # the input is not mutated


@pytest.mark.parametrize("b", [1, 8, 64])
def test_perturb_site_matches_jax(b):
    """On the same JAX-made stats and merge result.  At b = 64 some global
    clusters have fewer than b points on a site (the rest of JAX's top_k
    are invalid no-ops)."""
    xs = _sites(n_sites=3, n=400)
    per_site, assigns = _jax_stats(xs)
    merged = jvc.merge_gathered(per_site, jvc.VClusterConfig(k_local=K_LOCAL))
    tm = _t_merged(merged)
    for i in range(len(xs)):
        slots = assigns[i] + i * K_LOCAL
        jl, jst_ = jvc.perturb_site(jnp.asarray(xs[i]), jnp.asarray(slots), merged, b)
        tl, tst_ = tvc.perturb_site(torch.from_numpy(xs[i].copy()), torch.from_numpy(slots), tm, b)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tst_.sizes.numpy(), np.asarray(jst_.sizes))
        np.testing.assert_allclose(tst_.centers.numpy(), np.asarray(jst_.centers), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(tst_.sse.numpy(), np.asarray(jst_.sse), rtol=1e-4, atol=1e-2)
    if b == 64:
        counts = [np.bincount(np.asarray(merged.labels)[assigns[i] + i * K_LOCAL]) for i in range(len(xs))]
        assert any(0 < c < b for cs in counts for c in cs)


def _hand_merged(jax_side: bool):
    """Two live global clusters at integer centres with integer points, so
    the expanded distances are exact and tie; sizes make moves possible."""
    sizes = np.array([6.0, 0.0, 5.0], np.float32)
    centers = np.array([[0.0, 0.0], [0.0, 0.0], [4.0, 0.0]], np.float32)
    sse = np.array([40.0, 0.0, 30.0], np.float32)
    labels = np.array([0, 0, 2], np.int32)
    if jax_side:
        st = jst.SuffStats(jnp.asarray(sizes), jnp.asarray(centers), jnp.asarray(sse))
        return jvc.MergeResult(labels=jnp.asarray(labels), stats=st, n_merges=jnp.int32(1), n_global=jnp.int32(2))
    st = tst.SuffStats(torch.from_numpy(sizes), torch.from_numpy(centers), torch.from_numpy(sse))
    return tvc.MergeResult(labels=torch.from_numpy(labels), stats=st, n_merges=1, n_global=2)


@pytest.mark.parametrize("b", [1, 2, 3])
def test_perturb_site_tied_distances_match_jax(b):
    """Points tied at the same distance from their global centre: JAX's
    top_k takes the lower point index first, and so must the port: of the
    three points at distance 3 from centre 0, only the first, (3, 0), is
    better off in cluster 2, so at b = 1 it moves only if it is the one
    chosen.  Global cluster 2 has one point on this site, fewer than b."""
    x = np.array([[1.0, 0.0], [3.0, 0.0], [-3.0, 0.0], [0.0, 3.0], [0.0, -1.0], [5.0, 0.0]], np.float32)
    slots = np.array([0, 1, 0, 1, 0, 2], np.int32)  # slot 1 merged into 0
    jl, jst_ = jvc.perturb_site(jnp.asarray(x), jnp.asarray(slots), _hand_merged(True), b)
    tl, tst_ = tvc.perturb_site(torch.from_numpy(x), torch.from_numpy(slots), _hand_merged(False), b)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for f in range(3):
        np.testing.assert_allclose(tst_[f].numpy(), np.asarray(jst_[f]), rtol=1e-6)
    assert tl.tolist() == [0, 2, 0, 0, 0, 2]  # (3, 0) moved


def test_run_vclustering_wrapper_and_registry():
    from repro_torch.workflow.registry import app_names, validate_registry

    assert validate_registry() == []
    assert "vclustering" in app_names()
    xs = _sites(n_sites=2, n=500)
    rt = GridRuntime(device="cpu")
    cfg = tvc.VClusterConfig(k_local=4, kmeans_iters=3, use_kernel=True)
    a = rt.run_vclustering(xs, cfg, seed=2)
    b = rt.run("vclustering", xs, {"cfg": cfg, "seed": 2})
    assert _digest(a.result) == _digest(b.result)
    assert a.estimated_s > 0 and a.estimated_staged_s > 0
    assert a.result.labels.shape == (2, 500) and a.result.labels.dtype == torch.int32


def _counting_launches(monkeypatch):
    """CPU tensors take the wrappers' kernel branch, with the plain version
    in place of the launch: what the wrappers count is what the card would
    launch."""
    from repro_torch.kernels import ref

    def fake_launch(xs, centers_s, counter):
        ops.LAUNCHES[counter] += 1
        return ref.kmeans_assign_sites_ref(xs, centers_s)

    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(ops, "_kmeans_launch", fake_launch)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_explicit_cfg_keeps_the_runtimes_kernel_choice(monkeypatch, use_kernel):
    _counting_launches(monkeypatch)
    xs = _sites(n_sites=2, n=300)
    rt = GridRuntime(device="cpu", use_kernel=use_kernel)
    for run in (lambda cfg: rt.run("vclustering", xs, {"cfg": cfg}), lambda cfg: rt.run_vclustering(xs, cfg)):
        ops.reset_launches()
        run(tvc.VClusterConfig(k_local=4, kmeans_iters=3, threshold_factor=3.0))
        want = 3 + 1 if use_kernel else 0  # one batched launch per Lloyd step and the final assignment
        assert ops.LAUNCHES["kmeans_assign_sites"] == want and ops.LAUNCHES["kmeans_assign"] == 0


def test_vclustering_rejects_a_cfg_that_contradicts_the_runtime():
    xs = _sites(n_sites=2, n=50)
    with pytest.raises(ValueError, match="disagrees with the runtime"):
        GridRuntime(device="cpu").run("vclustering", xs, {"cfg": tvc.VClusterConfig(k_local=2, use_kernel=False)})
    with pytest.raises(ValueError, match="disagrees with the runtime"):
        GridRuntime(device="cpu", use_kernel=False).run_vclustering(xs, tvc.VClusterConfig(k_local=2, use_kernel=True))
    for key in ("k_local", "iters"):
        with pytest.raises(ValueError, match="not both"):
            GridRuntime(device="cpu").run("vclustering", xs, {"cfg": tvc.VClusterConfig(k_local=2), key: 3})


@pytest.mark.parametrize("key", ["n_sites", "split_seed", "key", "block"])
def test_vclustering_rejects_params_it_does_not_read(key):
    with pytest.raises(ValueError, match="known params"):
        GridRuntime(device="cpu").run("vclustering", _sites(n_sites=2, n=50), {key: 3})


def test_vclustering_rejects_bad_shapes():
    rt = GridRuntime(device="cpu")
    with pytest.raises(ValueError, match=r"\(S, n, D\)"):
        rt.run("vclustering", np.zeros((10, 2), np.float32), {"k_local": 2})
    with pytest.raises(ValueError, match="init_centers"):
        rt.run("vclustering", _sites(n_sites=2, n=50), {"k_local": 2, "init_centers": np.zeros((2, 3, 8))})
