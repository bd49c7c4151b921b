"""The port's launch-variant autotuner (``repro_torch.kernels.autotune``)
and the ``block=`` seam of its mining wrappers, against the reference's
contract (``tests/test_autotune.py``): deterministic candidates with the
default first, feasibility by shared memory, the default kept within the
2% margin, a memo hit on the second call, keys that bucket as documented,
a pure ``lookup``, tables that round-trip, a mode that validates and
restores, a capture that only looks up, and configs that never change a
result, on the registry apps too, where the digests equal the JAX
package's.

On the CPU the plain versions split their work as a config says (word
shares summed, points in blocks), so the search times real alternatives
and every result is compared exactly: counts and flags are integers, and
each assignment and min d² is computed by the same arithmetic whatever the
config.  The ``cuda`` tests hold every compiled variant and forced split
to the default on the card, bit for bit, and skip elsewhere; the JAX
package is imported only by the tests that compare with it, so the card,
which has no jax, runs ``python -m pytest -q -m cuda
tests/test_torch_autotune.py``.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hermetic env: deterministic shim, no shrinking
    from repro.testing import given, settings, strategies as st

from repro_torch.core.apriori import pack_bool_matrix, pack_itemsets
from repro_torch.kernels import _build, autotune, ops, ref
from repro_torch.launch.mesh import tuned_platform
from repro_torch.runtime import conformance as tconf

SRC = str(Path(__file__).resolve().parent.parent / "src")
CSRC = Path(SRC) / "repro_torch" / "kernels" / "csrc"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_cache():
    """Each test starts from an empty memo, the tiny smoke lattice and the
    default block mode (the full lattice's sweep belongs to the card)."""
    autotune.clear_cache()
    prev = autotune.set_smoke(True)
    prev_mode = ops.set_default_block("default")
    yield
    ops.set_default_block(prev_mode)
    autotune.set_smoke(prev)
    autotune.clear_cache()


def _support_inputs(s, n, items, c, seed):
    """(tx (S, N, W), masks (S, C, W)) int32 views of packed words: dense
    random transactions and itemsets of 1-4 items, the first mask empty."""
    rng = np.random.default_rng(seed)
    txs, mks = [], []
    for _ in range(s):
        txs.append(pack_bool_matrix(rng.random((n, items)) < 0.3))
        sets = [tuple(sorted(rng.choice(items, size=rng.integers(1, min(4, items) + 1), replace=False).tolist()))
                for _ in range(c)]
        mk = pack_itemsets(sets, items)
        mk[0] = 0
        mks.append(mk)
    return (torch.from_numpy(np.stack(txs).view(np.int32)), torch.from_numpy(np.stack(mks).view(np.int32)))


def _points(s, n, k, d, seed):
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.normal(size=(s, n, d)).astype(np.float32))
    cs = torch.from_numpy(rng.normal(size=(s, k, d)).astype(np.float32))
    return xs, cs


class TestSearch:
    def test_candidates_deterministic_default_first(self):
        for smoke in (True, False):
            cands = autotune.support_count_candidates(4, 32, 25_000, 300, smoke=smoke)
            assert cands[0] == autotune.DEFAULT_SUPPORT_CONFIG == (256, 4, 4, 0)
            assert cands == autotune.support_count_candidates(4, 32, 25_000, 300, smoke=smoke)
            assert len(cands) == len(set(cands)) > 1
            kc = autotune.kmeans_assign_candidates(200, 250_000, 20, 8, smoke=smoke)
            assert kc[0] == autotune.DEFAULT_KMEANS_CONFIG[8] == (256, 4)
            assert kc == autotune.kmeans_assign_candidates(200, 250_000, 20, 8, smoke=smoke)
            assert len(kc) == len(set(kc)) > 1
        full = autotune.support_count_candidates(4, 32, 25_000, 300, smoke=False)
        assert len(full) == len(autotune.SUPPORT_VARIANTS) * 5
        assert set(autotune.kmeans_assign_candidates(1, 10, 3, 8, smoke=False)) == set(autotune.KMEANS_VARIANTS[8])

    def test_defaults_are_todays_launches(self):
        """The defaults equal the compiled launch: a 256-thread count CTA
        with kU = kI = 4 and the heuristic split; 256 threads and the
        Tiling points (8, 4, 2, then 1) for the assignment."""
        assert autotune.DEFAULT_KMEANS_CONFIG == {4: (256, 8), 8: (256, 4), 16: (256, 2), 32: (256, 1),
                                                  64: (256, 1), 128: (256, 1)}
        for d, maxd in [(1, 4), (4, 4), (5, 8), (8, 8), (9, 16), (16, 16), (17, 32), (100, 128), (300, 128)]:
            assert autotune.kmeans_maxd(d) == maxd
            assert autotune.kmeans_default_config(d) == autotune.DEFAULT_KMEANS_CONFIG[maxd]

    def test_python_tables_equal_the_cuda_sources(self):
        """The lattices name the variants the CUDA sources compile, in
        their order (the card checks the same through the libraries)."""
        sc = (CSRC / "support_count.cu").read_text()
        body = re.search(r"kCountVariants\[\]\[3\] = \{(.*?)\};", sc, re.S).group(1)
        got = tuple(tuple(int(v) for v in t) for t in re.findall(r"\{(\d+), (\d+), (\d+)\}", body))
        assert got == autotune.SUPPORT_VARIANTS
        km = (CSRC / "kmeans_assign.cuh").read_text()
        for maxd in (4, 8, 16):
            body = re.search(rf"struct Variants<{maxd}> \{{.*?kList\[\d+\]\[2\] = \{{(.*?)\}};", km, re.S).group(1)
            got = tuple(tuple(int(v) for v in t) for t in re.findall(r"\{(\d+), (\d+)\}", body))
            assert got == autotune.KMEANS_VARIANTS[maxd]
        assert re.search(r"kTileFloats = (\d+);", km).group(1) == str(autotune.KMEANS_TILE_FLOATS)

    def test_shared_memory_formulas_and_feasibility(self, monkeypatch):
        assert [autotune.support_count_smem(t) for t in (128, 256, 512, 1024)] == [8192, 16384, 32768, 65536]
        assert autotune.kmeans_assign_smem(8) == 4 * (4096 + 512) == 18432
        assert autotune.kmeans_assign_smem(128) == 4 * (4096 + 32)
        assert autotune.STATIC_SMEM_BYTES == 48 * 1024 and autotune.CTA_SMEM_BYTES == 227 * 1024
        for cfg in autotune.support_count_candidates(16, 32, 100_000, 10_000, smoke=False):
            assert autotune.smem_fits(autotune.support_count_smem(cfg[0]))
        for maxd in autotune.KMEANS_VARIANTS:
            assert autotune.smem_fits(autotune.kmeans_assign_smem(maxd))
        # a 1024-thread count CTA would take 64 KB of static shared memory: dropped
        monkeypatch.setattr(autotune, "SUPPORT_VARIANTS", autotune.SUPPORT_VARIANTS + ((1024, 4, 4),))
        assert not autotune.smem_fits(autotune.support_count_smem(1024))
        assert all(cfg[0] != 1024 for cfg in autotune.support_count_candidates(4, 32, 25_000, 300, smoke=False))

    @pytest.mark.parametrize("n,most", [(1, 1), (1024, 1), (1025, 2), (25_000, 25), (100_000, 98)])
    def test_forced_splits_stay_within_one_word_a_lane(self, n, most):
        assert autotune.max_count_shares(n) == most
        for cfg in autotune.support_count_candidates(2, 8, n, 50, smoke=False):
            assert cfg[3] <= most
        for split in (0, 1, 2, 4, 8, 30, 200):
            shares = ref.count_shares(n, split)
            assert shares[0][0] == 0 and shares[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
            assert all((r1 - r0) % 1024 == 0 for r0, r1 in shares[:-1])
            assert len(shares) <= max(1, min(split, most))

    def test_wide_d_has_its_default_alone(self):
        for d in (17, 64, 100, 128):
            assert autotune.kmeans_assign_candidates(3, 500, 7, d, smoke=False) == [(256, 1)]

    def test_pick_keeps_default_within_margin(self):
        default = autotune.DEFAULT_SUPPORT_CONFIG
        other = (128, 4, 4, 2)
        assert autotune.MARGIN == 0.02
        assert autotune._pick([(default, 1.00), (other, 0.99)]) == default  # a 1% win is noise
        assert autotune._pick([(default, 1.00), (other, 0.50)]) == other
        assert autotune._pick([(default, 1.00), (other, 2.00)]) == default

    def test_memo_hit_on_second_call(self):
        tx, masks = _support_inputs(2, 300, 32, 40, seed=0)
        e1 = autotune.tune_support_count(tx, masks)
        stats = autotune.cache_stats()
        assert stats["misses"] == 1 and stats["entries"] == 1
        e2 = autotune.tune_support_count(tx, masks)
        assert e2 is e1  # the literal cached entry, nothing re-timed
        assert autotune.cache_stats()["hits"] == 1
        assert e1["platform"] == "cpu+plain" and e1["config_default"] == list(autotune.DEFAULT_SUPPORT_CONFIG)
        assert set(e1["timings"]) == {str(c) for c in autotune.support_count_candidates(2, 32, 300, 40)}
        assert e1["seconds_tuned"] <= e1["seconds_default"]
        xs, cs = _points(3, 200, 5, 8, seed=0)
        k1 = autotune.tune_kmeans_assign(xs, cs)
        assert autotune.tune_kmeans_assign(xs, cs) is k1
        assert autotune.cache_stats() == {"entries": 2, "hits": 2, "misses": 2}

    @pytest.mark.parametrize("x,want", [(1, 1), (8, 8), (9, 10), (10, 10), (11, 12), (18, 20), (100, 112),
                                        (25_000, 28_672), (28_672, 28_672), (28_673, 32_768),
                                        (250_000, 262_144), (10_883, 12_288), (10_662, 12_288)])
    def test_bucket_rounds_to_three_significant_bits(self, x, want):
        assert autotune.bucket(x) == want
        assert want < 1.25 * x + 1

    def test_key_buckets_with_sites_and_platform(self):
        """Shapes in one bucket share a key and a candidate list; the sites,
        the words, the platform and (for K-Means) K and D stay exact."""
        k1 = autotune.support_count_key(4, 32, 24_600, 10_883, torch.int32, "cpu+plain")
        k2 = autotune.support_count_key(4, 32, 25_000, 10_662, torch.int32, "cpu+plain")
        assert k1 == k2 == ("support_count", (4, 32, 28_672, 12_288), "torch.int32", "cpu+plain")
        assert (autotune.support_count_candidates(4, 32, 24_600, 10_883)
                == autotune.support_count_candidates(4, 32, 25_000, 10_662))
        assert k1 != autotune.support_count_key(3, 32, 25_000, 10_662, torch.int32, "cpu+plain")
        assert k1 != autotune.support_count_key(4, 31, 25_000, 10_662, torch.int32, "cpu+plain")
        assert k1 != autotune.support_count_key(4, 32, 28_673, 10_662, torch.int32, "cpu+plain")
        assert k1 != autotune.support_count_key(4, 32, 25_000, 10_662, torch.int32, "cuda:H100:0123456789ab")
        m1 = autotune.kmeans_assign_key(200, 250_000, 20, 8, torch.float32, "cpu+plain")
        assert m1 == autotune.kmeans_assign_key(200, 240_000, 20, 8, torch.float32, "cpu+plain")
        assert m1[1] == (200, 262_144, 20, 8)
        for other in [(400, 250_000, 20, 8), (200, 250_000, 21, 8), (200, 250_000, 20, 9)]:
            assert m1 != autotune.kmeans_assign_key(*other, torch.float32, "cpu+plain")
        assert (autotune.kmeans_assign_candidates(200, 250_000, 20, 8)
                == autotune.kmeans_assign_candidates(200, 240_000, 20, 8))

    def test_shapes_in_one_bucket_share_one_search(self):
        a = _support_inputs(2, 1000, 32, 40, seed=1)
        b = _support_inputs(2, 900, 32, 37, seed=2)  # N 1,000 and 900: bucket 1,024; C 40 and 37: 40
        ent = autotune.tune_support_count(*a)
        assert autotune.tune_support_count(*b) is ent
        assert autotune.cache_stats()["misses"] == 1

    def test_lookup_is_pure(self):
        key = autotune.support_count_key(4, 32, 100, 10, torch.int32, "cpu+plain")
        assert autotune.lookup(key) is None
        assert autotune.cache_stats() == {"entries": 0, "hits": 0, "misses": 0}

    def test_platform_names_the_device_and_build(self):
        assert autotune.platform(CPU, "support_count") == "cpu+plain"
        h = _build.source_hash("support_count")
        assert re.fullmatch(r"[0-9a-f]{12}", h) and h != _build.source_hash("kmeans_assign")
        assert _build._target("support_count").name == f"libsupport_count-{h}.so"


class TestTunedEqualsDefault:
    """No config changes a result: tuned == default == every candidate,
    bit for bit, over odd shapes, through the config-aware plain versions."""

    @given(
        s=st.integers(1, 3),
        n=st.integers(1, 3000),
        items=st.integers(1, 64),
        c=st.integers(1, 60),
        seed=st.integers(0, 2**31 - 1),
    )
    @settings(max_examples=10, deadline=None)
    def test_support_count(self, s, n, items, c, seed):
        tx, masks = _support_inputs(s, n, items, c, seed)
        mc = torch.tensor([1 + (n * i) // 3 for i in range(s)], dtype=torch.int32)
        ent = autotune.tune_support_count(tx, masks)
        want = ref.support_count_sites_ref(tx, masks)
        for cfg in [tuple(ent["config"])] + autotune.support_count_candidates(s, tx.shape[2], n, c, smoke=False):
            assert torch.equal(ref.support_count_sites_ref(tx, masks, config=cfg), want), cfg
            counts, flags = ops.support_count_prune_sites(tx, masks, mc, block=cfg)
            assert torch.equal(counts, want) and torch.equal(flags, want >= mc[:, None]), cfg
            assert ops.LAST_CONFIG["support_count_prune_sites"] == cfg

    @given(
        s=st.integers(1, 3),
        n=st.integers(1, 700),
        d=st.integers(1, 40),
        k=st.integers(1, 40),
        seed=st.integers(0, 2**31 - 1),
    )
    @settings(max_examples=10, deadline=None)
    def test_kmeans_assign(self, s, n, d, k, seed):
        xs, cs = _points(s, n, k, d, seed)
        ent = autotune.tune_kmeans_assign(xs, cs)
        a0, m0 = ref.kmeans_assign_sites_ref(xs, cs)
        for cfg in [tuple(ent["config"])] + autotune.kmeans_assign_candidates(s, n, k, d, smoke=False):
            a, m = ops.kmeans_assign_sites(xs, cs, block=cfg)
            assert torch.equal(a, a0) and torch.equal(m, m0), cfg
            a, m = ref.kmeans_assign_sites_ref(xs, cs, config=cfg)
            assert torch.equal(a, a0) and torch.equal(m, m0), cfg

    def test_ops_auto_equals_default(self):
        """The seam end to end: block='auto' == block=None on all six
        wrappers, and the results equal the JAX package's with its own
        autotuned blocks (its Pallas kernels in interpret mode)."""
        import jax.numpy as jnp

        from repro.kernels import ops as jops

        tx, masks = _support_inputs(3, 1413, 48, 77, seed=5)
        mc = torch.tensor([37, 0, 500], dtype=torch.int32)
        default = ops.support_count_sites(tx, masks)
        assert torch.equal(ops.support_count_sites(tx, masks, block="auto"), default)
        counts, flags = ops.support_count_prune_sites(tx, masks, mc, block="auto")
        assert torch.equal(counts, default) and torch.equal(flags, default >= mc[:, None])
        assert torch.equal(ops.support_count(tx[1], masks[1], block="auto"), default[1])
        cnt, freq = ops.support_count_prune(tx[1], masks[1], 37, block="auto")
        assert torch.equal(cnt, default[1]) and torch.equal(freq, default[1] >= 37)
        want = np.asarray(jops.support_count(jnp.asarray(tx[1].numpy().view(np.uint32)),
                                             jnp.asarray(masks[1].numpy().view(np.uint32)), block="auto"))
        np.testing.assert_array_equal(cnt.numpy(), want)
        xs, cs = _points(2, 900, 6, 8, seed=6)
        a0, m0 = ops.kmeans_assign_sites(xs, cs)
        a, m = ops.kmeans_assign_sites(xs, cs, block="auto")
        assert torch.equal(a, a0) and torch.equal(m, m0)
        a1, m1 = ops.kmeans_assign(xs[0], cs[0], block="auto")
        assert torch.equal(a1, a0[0]) and torch.equal(m1, m0[0])
        ja, jm = jops.kmeans_assign(jnp.asarray(xs[0].numpy()), jnp.asarray(cs[0].numpy()), block="auto")
        np.testing.assert_array_equal(a1.numpy(), np.asarray(ja))
        np.testing.assert_allclose(m1.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-4)
        assert set(ops.LAST_CONFIG) == set(ops.MINING_WRAPPERS)
        assert all(ops.LAST_CONFIG[name] is not None for name in ops.MINING_WRAPPERS)

    def test_default_mode_runs_the_default_config(self):
        tx, masks = _support_inputs(2, 300, 40, 20, seed=7)
        xs, cs = _points(2, 300, 4, 3, seed=7)
        ops.support_count_sites(tx, masks)
        ops.support_count_prune(tx[0], masks[0], 5)
        ops.kmeans_assign_sites(xs, cs)
        ops.kmeans_assign(xs[0], cs[0])
        assert ops.LAST_CONFIG["support_count_sites"] == autotune.DEFAULT_SUPPORT_CONFIG
        assert ops.LAST_CONFIG["support_count_prune"] == autotune.DEFAULT_SUPPORT_CONFIG
        assert ops.LAST_CONFIG["kmeans_assign_sites"] == ops.LAST_CONFIG["kmeans_assign"] == (256, 8)
        assert autotune.cache_stats()["entries"] == 0

    def test_explicit_configs_are_checked(self):
        tx, masks = _support_inputs(1, 100, 8, 5, seed=8)
        xs, cs = _points(1, 50, 3, 8, seed=8)
        for bad in [(256, 4, 4), (100, 4, 4, 0), (256, 4, 4, -1), "turbo"]:
            with pytest.raises(ValueError):
                ops.support_count_sites(tx, masks, block=bad)
        for bad in [(256, 1), (100, 4), "fast"]:
            with pytest.raises(ValueError):
                ops.kmeans_assign_sites(xs, cs, block=bad)
        assert torch.equal(ops.kmeans_assign_sites(xs, cs, block=[128, 8])[0], ops.kmeans_assign_sites(xs, cs)[0])

    def test_zero_sizes_resolve_nothing(self):
        ops.LAST_CONFIG.update(dict.fromkeys(ops.MINING_WRAPPERS))
        z = torch.zeros((0, 2), dtype=torch.int32)
        m = torch.zeros((3, 2), dtype=torch.int32)
        assert torch.equal(ops.support_count(z, m, block="auto"), torch.zeros(3, dtype=torch.int32))
        assert ops.support_count_prune(m, z, 1, block="auto")[0].numel() == 0
        a, _ = ops.kmeans_assign(torch.zeros((0, 3)), torch.zeros((2, 3)), block="auto")
        assert a.numel() == 0
        assert autotune.cache_stats()["misses"] == 0
        assert all(v is None for v in ops.LAST_CONFIG.values())


class TestTableRoundTrip:
    def test_save_load_reproduces_memo(self, tmp_path):
        tx, masks = _support_inputs(2, 300, 32, 40, seed=1)
        ent = autotune.tune_support_count(tx, masks)
        xs, cs = _points(2, 300, 5, 8, seed=1)
        autotune.tune_kmeans_assign(xs, cs)
        path = str(tmp_path / "tuned.json")
        assert autotune.save_table(path) == 2
        memo = dict(autotune._cache)
        with open(path) as fh:
            assert json.load(fh)["version"] == 1
        autotune.clear_cache()
        assert autotune.load_table(path) == 2
        assert autotune._cache == memo
        key = autotune.support_count_key(2, tx.shape[2], 300, 40, torch.int32, "cpu+plain")
        assert autotune.lookup(key) == tuple(ent["config"])
        again = autotune.tune_support_count(tx, masks)  # a pure cache hit: no re-search
        assert again["config"] == ent["config"]
        autotune.tune_kmeans_assign(xs, cs)
        assert autotune.cache_stats()["misses"] == 0

    def test_load_replace_resets(self, tmp_path):
        tx, masks = _support_inputs(2, 300, 32, 40, seed=2)
        autotune.tune_support_count(tx, masks)
        path = str(tmp_path / "tuned.json")
        autotune.save_table(path)
        autotune.tune_support_count(tx[:1], masks[:1])
        assert autotune.cache_stats()["entries"] == 2
        autotune.load_table(path, replace=True)
        assert autotune.cache_stats()["entries"] == 1

    def test_other_versions_are_refused(self, tmp_path):
        path = tmp_path / "tuned.json"
        path.write_text(json.dumps({"version": 2, "entries": []}))
        with pytest.raises(ValueError, match="version"):
            autotune.load_table(str(path))


class TestModeSeam:
    def test_set_default_block_validates_and_restores(self):
        prev = ops.set_default_block("auto")
        try:
            assert ops.default_block() == "auto"
            with pytest.raises(ValueError):
                ops.set_default_block("turbo")
            assert ops.default_block() == "auto"
        finally:
            ops.set_default_block(prev)
        assert ops.default_block() == "default"

    def test_auto_mode_tunes_block_none_calls(self):
        tx, masks = _support_inputs(2, 500, 16, 30, seed=3)
        default = ops.support_count_sites(tx, masks)
        ops.set_default_block("auto")
        assert torch.equal(ops.support_count_sites(tx, masks), default)
        assert autotune.cache_stats()["misses"] == 1

    def test_environment_sets_the_modes(self):
        env = dict(os.environ, PYTHONPATH=SRC, REPRO_KERNEL_BLOCKS="auto", REPRO_AUTOTUNE_SMOKE="1")
        code = ("from repro_torch.kernels import autotune, ops; "
                "print(ops.default_block(), autotune._smoke_default)")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
        assert out.stdout.split() == ["auto", "True"], out.stderr
        env.update(REPRO_KERNEL_BLOCKS="default", REPRO_AUTOTUNE_SMOKE="0")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
        assert out.stdout.split() == ["default", "False"], out.stderr

    def test_a_call_during_capture_only_looks_up(self, monkeypatch, tmp_path):
        """While a CUDA graph is being captured nothing is timed: the
        memoized winner if there is one, else the default."""
        tx, masks = _support_inputs(2, 2100, 32, 30, seed=4)
        xs, cs = _points(2, 300, 5, 8, seed=4)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        assert autotune.capturing()
        want = ops.support_count_sites(tx, masks, block="auto")
        ops.kmeans_assign_sites(xs, cs, block="auto")
        assert autotune.cache_stats() == {"entries": 0, "hits": 0, "misses": 0}
        assert ops.LAST_CONFIG["support_count_sites"] == autotune.DEFAULT_SUPPORT_CONFIG
        assert ops.LAST_CONFIG["kmeans_assign_sites"] == (256, 4)
        # a table that names other winners: the capture uses them, still timing nothing
        entries = [
            {"kernel": "support_count", "shape": [2, tx.shape[2], autotune.bucket(2100), autotune.bucket(30)],
             "dtype": "torch.int32", "platform": "cpu+plain", "config": [128, 4, 4, 2]},
            {"kernel": "kmeans_assign", "shape": [2, autotune.bucket(300), 5, 8], "dtype": "torch.float32",
             "platform": "cpu+plain", "config": [512, 4]},
        ]
        path = tmp_path / "tuned.json"
        path.write_text(json.dumps({"version": 1, "entries": entries}))
        autotune.load_table(str(path))
        assert torch.equal(ops.support_count_sites(tx, masks, block="auto"), want)
        ops.kmeans_assign_sites(xs, cs, block="auto")
        assert ops.LAST_CONFIG["support_count_sites"] == (128, 4, 4, 2)
        assert ops.LAST_CONFIG["kmeans_assign_sites"] == (512, 4)
        assert autotune.cache_stats()["misses"] == 0

    @pytest.mark.parametrize("backend", ["inline", "batched"])
    def test_conformance_digest_with_auto_blocks(self, backend):
        """The registry's GFM on the kernel path with autotuned launches
        gives the JAX package's digest (the plain inline run), and the mode
        is restored after the run."""
        from repro.runtime import conformance as jconf

        want = jconf.result_digest("gfm", jconf.run_app("gfm", 3, "staged", "inline"))
        run = tconf.run_app("gfm", 3, "staged", backend, count_backend="kernel", use_kernel=True, block="auto")
        assert tconf.result_digest("gfm", run) == want
        assert ops.default_block() == "default"
        assert autotune.cache_stats()["misses"] >= 1
        assert ops.LAST_CONFIG["support_count_prune_sites" if backend == "batched" else "support_count_prune"]

    def test_tuned_platform_pins_and_keeps_full_float32(self):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            assert tuned_platform("cpu") == "cpu"
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = True
        with pytest.raises(ValueError, match="unknown platform"):
            tuned_platform("gpu")
        if not torch.cuda.is_available():
            for platform in (None, "cuda"):
                with pytest.raises(RuntimeError, match='device="cpu"'):
                    tuned_platform(platform)


# ---------------------------------------------------------------------------
# on the card: every compiled variant and forced split against the default
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _all_support_configs(n):
    return [v + (split,) for v in autotune.SUPPORT_VARIANTS
            for split in sorted({0, 1, 2, 3, 4, 8, autotune.max_count_shares(n), autotune.max_count_shares(n) + 5})]


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,w,c", [(2, 1, 1, 1), (2, 31, 1, 1), (2, 33, 32, 1), (3, 33, 1, 9), (2, 31, 32, 5),
                                     (3, 5000, 4, 40), (2, 25_000, 32, 300)])
def test_cuda_every_count_variant_and_split_is_exact(cuda_device, s, n, w, c):
    """Every count variant with every split, forced past the most shares
    too, against the default and the plain version: counts and flags
    equal, with thresholds <= 0, crossed by a later share, and never met."""
    gen = torch.Generator().manual_seed(s * n + w + c)
    tx = torch.randint(-(2**31), 2**31, (s, n, w), generator=gen, dtype=torch.int64)
    tx = (tx | torch.randint(-(2**31), 2**31, (s, n, w), generator=gen, dtype=torch.int64)).to(torch.int32)
    masks = torch.zeros((s, c, w), dtype=torch.int64)
    bits = torch.randint(0, 32 * w, (s, c, 2), generator=gen)
    for k in range(2):
        masks.scatter_(2, bits[..., k, None] // 32, masks.gather(2, bits[..., k, None] // 32) | (1 << (bits[..., k, None] % 32)))
    masks[:, 0] = 0  # counts every row: its flag crosses at whichever share takes it past the threshold
    tx, masks = tx.to(cuda_device), masks.to(torch.int32).to(cuda_device)
    thresholds = [0, -3, n // 2 + 1, n, n + 1]
    want = ref.support_count_sites_ref(tx.cpu(), masks.cpu()).to(cuda_device)
    default = ops.support_count_sites(tx, masks)
    torch.cuda.synchronize()
    assert torch.equal(default, want)
    for cfg in _all_support_configs(n):
        got = ops.support_count_sites(tx, masks, block=cfg)
        assert torch.equal(got, want), cfg
        for t in thresholds:
            mc = torch.full((s,), t, dtype=torch.int32, device=cuda_device)
            counts, flags = ops.support_count_prune_sites(tx, masks, mc, block=cfg)
            assert torch.equal(counts, want) and torch.equal(flags, want >= t), (cfg, t)
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 4, 8, 9, 16])
@pytest.mark.parametrize("s,n,k", [(1, 1, 1), (2, 1000, 1), (3, 2049, 5), (2, 70_001, 20)])
def test_cuda_every_kmeans_variant_is_bit_identical(cuda_device, s, n, k, d):
    """Every assignment variant at D in {1, 3, 4, 8, 9, 16} against the
    default and the plain version, bit for bit: K = 1, tied centres (the
    lowest index wins) and points on a centre (the clamp at 0)."""
    gen = torch.Generator().manual_seed(s + n + k + d)
    xs = torch.randn((s, n, d), generator=gen) * 5
    cs = torch.randn((s, k, d), generator=gen) * 5
    if k > 1:
        cs[:, k - 1] = cs[:, 0]
    xs[:, : min(n, k)] = cs[:, : min(n, k)]
    xs, cs = xs.to(cuda_device), cs.to(cuda_device)
    ra, rm = ref.kmeans_assign_sites_ref(xs, cs)
    a0, m0 = ops.kmeans_assign_sites(xs, cs)
    torch.cuda.synchronize()
    assert torch.equal(a0, ra) and torch.equal(m0, rm)
    for cfg in autotune.KMEANS_VARIANTS[autotune.kmeans_maxd(d)]:
        a, m = ops.kmeans_assign_sites(xs, cs, block=cfg)
        torch.cuda.synchronize()
        assert torch.equal(a, a0) and torch.equal(m, m0), cfg


@pytest.mark.cuda
def test_cuda_block_none_launches_the_default_variant(cuda_device):
    tx = torch.randint(-(2**31), 2**31, (2, 700, 4), dtype=torch.int64).to(torch.int32).to(cuda_device)
    masks = tx[:, :30].clone()
    xs = torch.randn((2, 500, 8), device=cuda_device)
    ops.reset_launches()
    ops.support_count_sites(tx, masks)
    ops.support_count_prune_sites(tx, masks, [3, 4])
    ops.support_count(tx[0], masks[0])
    ops.support_count_prune(tx[0], masks[0], 3)
    ops.kmeans_assign_sites(xs, xs[:, :5].contiguous())
    ops.kmeans_assign(xs[0], xs[0, :5].contiguous())
    torch.cuda.synchronize()
    assert all(ops.LAUNCHES[name] == 1 for name in ops.MINING_WRAPPERS)
    assert all(ops.LAST_CONFIG[name] == autotune.DEFAULT_SUPPORT_CONFIG for name in ops.MINING_WRAPPERS[:4])
    assert ops.LAST_CONFIG["kmeans_assign"] == ops.LAST_CONFIG["kmeans_assign_sites"] == (256, 4)
    assert autotune.cache_stats()["entries"] == 0


@pytest.mark.cuda
def test_cuda_variant_attributes_match_the_tables(cuda_device):
    """The libraries' variants are the lattices' and their shared memory
    is the formulas'; the default spills nothing."""
    for v, (threads, u, i) in enumerate(autotune.SUPPORT_VARIANTS):
        info = ops.support_count_variant_info(v)
        assert (info["threads"], info["u"], info["i"]) == (threads, u, i)
        assert info["shared_bytes"] == autotune.support_count_smem(threads)
    assert autotune.variant_fits(ops.support_count_variant_info(0))
    for d in (1, 4, 8, 9, 16, 17, 100):
        variants = autotune.KMEANS_VARIANTS[autotune.kmeans_maxd(d)]
        for v, cfg in enumerate(variants):
            info = ops.kmeans_assign_variant_info(v, d)
            assert info["variants"] == len(variants) and (info["threads"], info["points"]) == cfg
            assert info["shared_bytes"] == autotune.kmeans_assign_smem(autotune.kmeans_maxd(d))
        assert autotune.variant_fits(ops.kmeans_assign_variant_info(0, d))


@pytest.mark.cuda
def test_cuda_tuning_keys_by_the_card_and_build(cuda_device):
    tx = torch.randint(-(2**31), 2**31, (2, 3000, 8), dtype=torch.int64).to(torch.int32).to(cuda_device)
    masks = tx[:, :100].clone()
    ent = autotune.tune_support_count(tx, masks)
    assert ent["platform"] == f"cuda:{torch.cuda.get_device_name(0)}:{_build.source_hash('support_count')}"
    assert ent["seconds_tuned"] <= ent["seconds_default"]
    assert torch.equal(ops.support_count_sites(tx, masks, block="auto"), ops.support_count_sites(tx, masks))
