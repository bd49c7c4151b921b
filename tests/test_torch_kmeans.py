"""The port's K-Means assignment, statistics and Lloyd iteration against the
JAX package's, on the CPU.

The same seeded numpy arrays go to ``repro.kernels.ops.kmeans_assign``
(the Pallas kernel in interpret mode, as tests/test_kernels.py runs it),
to ``repro.core.{stats,kmeans}`` and to their ``repro_torch``
counterparts, whose kernel wrappers run the plain PyTorch version for CPU
tensors.  Assignments must be equal.  Distances and statistics differ
only by summation order (the D-term dot products; the per-cluster sums,
which the port takes exactly and the JAX package in fp32), so they are
held to stated float32 tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.core import stats as jst
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro_torch.core import kmeans as tkm
from repro_torch.core import stats as tst
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops, ref

# min d² tolerance: the dot products are summed in another order (and, in
# the Pallas kernel, over 128 zero-padded lanes), so values differ by a few
# float32 roundings of the largest term, ‖x‖² + ‖c‖²: 8 of them, absolute
RTOL, ULPS = 1e-5, 8


def _atol(xs, cs):
    big = float((xs.astype(np.float64) ** 2).sum(-1).max(initial=0) + (cs.astype(np.float64) ** 2).sum(-1).max())
    return ULPS * float(np.finfo(np.float32).eps) * big


# (s, n, k, d, duplicate centres, points on centres): ragged N, N = 0,
# K = 1, D = 1, K·D past one shared-memory tile of the CUDA kernel (4,096
# floats), ties, the clamp at 0
CASES = [
    (1, 1000, 20, 8, False, False),
    (4, 777, 1, 1, False, False),
    (1, 0, 5, 3, False, False),
    (2, 301, 600, 8, True, True),
    (2, 257, 70, 100, True, True),
    (4, 129, 5, 3, True, False),
]
IDS = [f"s{s}-n{n}-k{k}-d{d}{'-dup' if u else ''}{'-on' if o else ''}" for s, n, k, d, u, o in CASES]


def _case(seed, s, n, k, d, dup, on_center):
    rng = np.random.default_rng(seed)
    xs = (rng.normal(size=(s, n, d)) * 5).astype(np.float32)
    cs = (rng.normal(size=(s, k, d)) * 5).astype(np.float32)
    if dup and k > 1:
        cs[:, k - 1] = cs[:, 0]
    if on_center and n > 0:
        m = min(n, k)
        xs[:, :m] = cs[:, :m]
    return xs, cs


@pytest.mark.parametrize("s,n,k,d,dup,on", CASES, ids=IDS)
def test_kmeans_assign_matches_jax_kernel(s, n, k, d, dup, on):
    xs, cs = _case(s * 7 + k, s, n, k, d, dup, on)
    ops.reset_launches()
    ta, tm = ops.kmeans_assign_sites(torch.from_numpy(xs), torch.from_numpy(cs))
    for i in range(s):
        ja, jm = jops.kmeans_assign(jnp.asarray(xs[i]), jnp.asarray(cs[i]))
        np.testing.assert_array_equal(ta[i].numpy(), np.asarray(ja))
        np.testing.assert_allclose(tm[i].numpy(), np.asarray(jm), rtol=RTOL, atol=_atol(xs, cs))
        oa, om = ops.kmeans_assign(torch.from_numpy(xs[i]), torch.from_numpy(cs[i]))
        assert torch.equal(oa, ta[i]) and torch.equal(om, tm[i])
    assert ta.dtype == torch.int32 and tm.dtype == torch.float32
    assert (tm >= 0).all()
    if dup and k > 1:
        assert not (ta == k - 1).any()  # the duplicate of centre 0 never wins
    assert all(v == 0 for v in ops.LAUNCHES.values())  # CPU tensors launch nothing


def test_kmeans_assign_sites_matches_jax_vmap():
    """The site form at S = 200 sites (the path's site count), small N."""
    xs, cs = _case(11, 200, 33, 20, 8, False, True)
    ta, tm = ops.kmeans_assign_sites(torch.from_numpy(xs), torch.from_numpy(cs))
    ja, jm = jops.kmeans_assign_sites(jnp.asarray(xs), jnp.asarray(cs))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL, atol=_atol(xs, cs))


def test_plain_version_argmin_before_clamp():
    """Both d² round negative here: the argmin over the unclamped d² (the
    TPU kernel's semantics) picks centre 1, the JAX package's own oracle,
    which clamps first, would tie both at 0 and pick centre 0."""
    x = torch.tensor([[8.53061294555664, 0.29659587144851685, -11.07544994354248]])
    c = torch.tensor([[8.531898498535156, 0.2956944406032562, -11.074413299560547],
                      [8.530946731567383, 0.2963753342628479, -11.075488090515137]])
    d2 = (ref.dot_last(x, x)[:, None] + ref.dot_last(c, c)[None]) - 2.0 * ref.dot_last(x[:, None], c[None])
    assert (d2 < 0).all() and float(d2[0, 1]) < float(d2[0, 0])
    a, m = ref.kmeans_assign_ref(x, c)
    assert int(a[0]) == 1 and float(m[0]) == 0.0
    assert int(torch.argmin(d2.clamp(min=0.0)[0])) == 0


def test_synthetic_arrays_equal_the_reference():
    jp, jl = jsyn.gaussian_mixture(7, 5000, 8, 12, spread=20.0, sigma=0.8)
    tp, tl = tsyn.gaussian_mixture(7, 5000, 8, 12, spread=20.0, sigma=0.8)
    assert tp.tobytes() == jp.tobytes() and np.array_equal(tl, jl)
    assert tsyn.split_sites(tp, 7, seed=1).tobytes() == jsyn.split_sites(jp, 7, seed=1).tobytes()


def _points(n=3000, d=8, seed=7):
    pts, _ = jsyn.gaussian_mixture(seed, n, d, 12, spread=20.0, sigma=0.8)
    return pts.copy()  # writable, for torch.from_numpy


def test_stats_from_assignment_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(5000, 8)) * 10).astype(np.float32)
    a = rng.integers(0, 7, 5000).astype(np.int32)  # cluster 7 of 8 stays empty
    j = jst.stats_from_assignment(jnp.asarray(x), jnp.asarray(a), 8)
    t = tst.stats_from_assignment(torch.from_numpy(x), torch.from_numpy(a), 8)
    np.testing.assert_array_equal(t.sizes.numpy(), np.asarray(j.sizes))
    np.testing.assert_allclose(t.centers.numpy(), np.asarray(j.centers), rtol=1e-5, atol=1e-5)
    # JAX's fp32 SSE cancels in sqsum - N|c|^2; the port's is formed in fp64
    np.testing.assert_allclose(t.sse.numpy(), np.asarray(j.sse), rtol=1e-5)
    exact = np.stack([x[a == i].astype(np.float64).mean(0) if (a == i).any() else np.zeros(8) for i in range(8)])
    np.testing.assert_allclose(t.centers.numpy(), exact, rtol=0, atol=1e-6)
    assert float(t.sizes[7]) == 0 and float(t.sse[7]) == 0 and not t.centers[7].any()
    assert tst.stats_bytes(t) == jst.stats_bytes(j)
    np.testing.assert_allclose(float(tst.total_sse(t)), float(jst.total_sse(j)), rtol=1e-5)


def test_segment_sums_do_not_depend_on_the_batch():
    """A site's sums are the same bits alone and among other sites, and
    equal an fp64 recount to fp64 precision."""
    rng = np.random.default_rng(1)
    xs = torch.from_numpy((rng.normal(size=(5, 999, 3)) * 30).astype(np.float32))
    assign = torch.from_numpy(rng.integers(0, 6, (5, 999)).astype(np.int32))
    counts, sums, sq = tst.segment_sums(xs, assign, 6, squares=True)
    for i in range(5):
        c1, s1, q1 = tst.segment_sums(xs[i : i + 1], assign[i : i + 1], 6, squares=True)
        assert torch.equal(c1[0], counts[i]) and torch.equal(s1[0], sums[i]) and torch.equal(q1[0], sq[i])
        x64 = xs[i].double()
        want = torch.zeros((6, 3), dtype=torch.float64).index_add_(0, assign[i].long(), x64)
        torch.testing.assert_close(sums[i], want, rtol=1e-12, atol=1e-9)
        assert torch.equal(counts[i], torch.bincount(assign[i].long(), minlength=6))


def test_merge_cost_and_merge_stats_match_jax():
    rng = np.random.default_rng(2)
    sizes = rng.integers(0, 50, 12).astype(np.float32)
    sizes[[3, 7]] = 0
    centers = (rng.normal(size=(12, 8)) * 4).astype(np.float32)
    sse = rng.uniform(0, 100, 12).astype(np.float32)
    jstats = jst.SuffStats(jnp.asarray(sizes), jnp.asarray(centers), jnp.asarray(sse))
    tstats = tst.SuffStats(torch.from_numpy(sizes), torch.from_numpy(centers), torch.from_numpy(sse))
    jc, tc = np.asarray(jst.merge_cost(jstats)), tst.merge_cost(tstats).numpy()
    np.testing.assert_array_equal(np.isinf(tc), np.isinf(jc))
    fin = np.isfinite(jc)
    np.testing.assert_allclose(tc[fin], jc[fin], rtol=1e-4, atol=1e-3)
    jm = jst.merge_stats(jstats, 1, 5)
    tm = tst.merge_stats(tstats, 1, 5)
    for f in range(3):
        np.testing.assert_allclose(tm[f].numpy(), np.asarray(jm[f]), rtol=1e-6, atol=1e-5)
    assert tm is tstats and float(tstats.sizes[5]) == 0  # in place: the merge loop's one copy of the formulas
    # one-element index tensors (the merge loop's, read back from no host) give the same bits
    again = tst.SuffStats(torch.from_numpy(sizes), torch.from_numpy(centers), torch.from_numpy(sse))
    tst.merge_stats(again, torch.tensor([1]), torch.tensor([5]))
    assert all(torch.equal(a, b) for a, b in zip(again, tm))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_kmeans_from_jax_seeds_matches_jax(use_kernel):
    """``kmeans`` started from the JAX package's own k-means++ draws
    (``init_centers``) against JAX's ``kmeans`` with that key."""
    pts = _points()
    key = jax.random.PRNGKey(3)
    init = np.array(jkm.kmeans_plus_plus_init(key, jnp.asarray(pts), 20))
    j = jkm.kmeans(key, jnp.asarray(pts), 20, iters=20, use_kernel=use_kernel)
    t = tkm.kmeans(torch.from_numpy(pts), 20, iters=20, use_kernel=use_kernel, init_centers=torch.from_numpy(init))
    np.testing.assert_array_equal(t.assign.numpy(), np.asarray(j.assign))
    np.testing.assert_allclose(t.centers.numpy(), np.asarray(j.centers), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(t.inertia), float(j.inertia), rtol=1e-4)
    np.testing.assert_array_equal(t.stats.sizes.numpy(), np.asarray(j.stats.sizes))


@pytest.mark.parametrize("iters", [0, 1, 6])
def test_kmeans_warm_matches_jax(iters):
    pts = _points(n=1500, seed=8)
    c0 = pts[:: 1500 // 9][:9].copy()
    c0[4] = 1e4  # a centre no point picks: the empty-cluster repair runs
    j = jkm.kmeans_warm(jnp.asarray(pts), jnp.asarray(c0), iters=iters, use_kernel=True)
    t = tkm.kmeans_warm(torch.from_numpy(pts), torch.from_numpy(c0), iters=iters, use_kernel=True)
    np.testing.assert_array_equal(t.assign.numpy(), np.asarray(j.assign))
    np.testing.assert_allclose(t.centers.numpy(), np.asarray(j.centers), rtol=1e-5, atol=1e-4)


def test_kmeans_plus_plus_is_seeded_per_site():
    """The port's own seeding: distinct data points, the same for a seed,
    another for another seed, and the same between the per-site and the
    batched forms."""
    xs = torch.from_numpy(jsyn.split_sites(_points(n=2400), 3, seed=1))
    gens = [tkm.site_generator(5, i) for i in range(3)]
    a = tkm.kmeans_plus_plus_sites(xs, 10, gens)
    b = tkm.kmeans_plus_plus_sites(xs, 10, [tkm.site_generator(5, i) for i in range(3)])
    c = tkm.kmeans_plus_plus_sites(xs, 10, [tkm.site_generator(6, i) for i in range(3)])
    assert torch.equal(a, b) and not torch.equal(a, c)
    for i in range(3):
        rows = {tuple(r) for r in a[i].tolist()}
        assert len(rows) == 10  # distinct
        pts = {tuple(r) for r in xs[i].tolist()}
        assert rows <= pts  # data points of that site
        one = tkm.kmeans_plus_plus_sites(xs[i : i + 1], 10, [tkm.site_generator(5, i)])
        assert torch.equal(one[0], a[i])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_kmeans_per_site_equals_batched(use_kernel):
    xs = torch.from_numpy(jsyn.split_sites(_points(n=2400), 3, seed=1))
    b = tkm.kmeans_sites(xs, 12, iters=8, use_kernel=use_kernel, seed=4)
    for i in range(3):
        o = tkm.kmeans(xs[i], 12, iters=8, use_kernel=use_kernel, seed=4, site=i)
        assert torch.equal(o.assign, b.assign[i]) and torch.equal(o.centers, b.centers[i])
        assert torch.equal(o.stats.sse, b.stats.sse[i])


def _planted(seed: int, n: int):
    """tests/test_vclustering.py's planted data: 4 components in 2-D."""
    return jsyn.gaussian_mixture(seed, n, 2, 4, spread=12.0, sigma=0.5)[0]


@pytest.mark.parametrize("k", [1, 2, 5])
def test_pooled_inertia_matches_jax(k):
    """``_pooled_inertia`` from the JAX package's k-means++ draw against
    the JAX package's own (``kmeans(key, x, k, iters).inertia``); float32
    sums in another order, so within 1e-5 relative."""
    pts = _planted(5, 600)
    key = jax.random.PRNGKey(k)
    init = np.array(jkm.kmeans_plus_plus_init(key, jnp.asarray(pts), k))
    want = float(jkm._pooled_inertia(key, jnp.asarray(pts), k, 10))
    got = tkm._pooled_inertia(torch.from_numpy(pts), k, 10, init_centers=torch.from_numpy(init))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_gap_statistic_k_hat_equals_jax():
    """tests/test_vclustering.py:37-39: the planted data (4 components),
    k_max 6, two reference sets, 10 iterations, seed 0 on both sides.  The
    draws differ (jax.random against torch.Generator); k_hat is the same.
    Neither package's k_hat is stable under every seed: where the k = 2
    data fit ends in a poor local optimum, gap(2) < gap(1) and k_hat is 1
    (the JAX package's own PRNGKey(1) does that)."""
    pts = _planted(5, 600)
    j_hat, j_gaps = jkm.gap_statistic(jax.random.PRNGKey(0), jnp.asarray(pts), 6, n_ref=2, iters=10)
    t_hat, t_gaps = tkm.gap_statistic(torch.from_numpy(pts), 6, n_ref=2, iters=10, seed=0)
    assert t_hat == j_hat == 4
    assert t_gaps.shape == (6,) and bool(torch.isfinite(t_gaps).all())
    assert int(torch.argmax(t_gaps)) == int(np.argmax(np.asarray(j_gaps))) == 3
    again, again_gaps = tkm.gap_statistic(torch.from_numpy(pts), 6, n_ref=2, iters=10, seed=0)
    assert again == t_hat and torch.equal(again_gaps, t_gaps)  # one generator: deterministic
