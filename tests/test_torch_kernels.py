"""The port's support-count wrappers against the JAX package's, on the CPU.

The same seeded numpy words go to ``repro.kernels.ops`` (the Pallas
kernels in interpret mode, as tests/test_kernels.py runs them), to
``repro.kernels.ref.support_count_ref`` and to ``repro_torch.kernels.ops``
(whose wrappers run the plain PyTorch versions for CPU tensors).  Every
result is an integer count or a flag, so the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import support_count_ref as jax_support_count_ref
from repro_torch.kernels import ops, ref

# (n, c, w, zero_masks): odd sizes that are no tile multiple, empty inputs,
# all-zero masks, and the narrowest and widest word counts
CASES = [
    (700, 37, 1, 0),
    (700, 37, 32, 0),
    (0, 5, 2, 0),
    (50, 0, 2, 0),
    (90, 12, 3, 4),
    (1, 1, 1, 0),
]
IDS = [f"n{n}-c{c}-w{w}-z{z}" for n, c, w, z in CASES]


def _words(rng, n, c, w, zero_masks):
    """Transactions with dense random bits (bit 31 included, so int32
    views are negative) and masks of 1-3 bits, some all zero."""
    tx = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64)
    tx |= rng.integers(0, 2**32, size=(n, w), dtype=np.uint64)  # ~75% bit density
    tx = tx.astype(np.uint32)
    masks = np.zeros((c, w), dtype=np.uint32)
    for i in range(c):
        for _ in range(rng.integers(1, 4)):
            b = int(rng.integers(0, 32 * w))
            masks[i, b // 32] |= np.uint32(1) << np.uint32(b % 32)
    masks[:zero_masks] = 0
    return tx, masks


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _sites(seed, n, c, w, zero_masks, s=3):
    rng = np.random.default_rng(seed)
    pairs = [_words(rng, n, c, w, zero_masks) for _ in range(s)]
    tx = np.stack([p[0] for p in pairs]) if s else np.zeros((0, n, w), np.uint32)
    masks = np.stack([p[1] for p in pairs]) if s else np.zeros((0, c, w), np.uint32)
    return tx, masks


@pytest.mark.parametrize("n,c,w,z", CASES, ids=IDS)
def test_support_count_matches_jax(n, c, w, z):
    tx, masks = _words(np.random.default_rng(n * 31 + c), n, c, w, z)
    got = ops.support_count(_t(tx), _t(masks)).numpy()
    want = np.asarray(jops.support_count(jnp.asarray(tx), jnp.asarray(masks)))
    oracle = np.asarray(jax_support_count_ref(jnp.asarray(tx), jnp.asarray(masks)))
    assert got.dtype == np.int32 and got.shape == (c,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("n,c,w,z", CASES, ids=IDS)
def test_support_count_prune_matches_jax(n, c, w, z):
    tx, masks = _words(np.random.default_rng(n * 17 + c), n, c, w, z)
    min_count = max(1, n // 3)
    got_c, got_f = ops.support_count_prune(_t(tx), _t(masks), min_count)
    want_c, want_f = jops.support_count_prune(jnp.asarray(tx), jnp.asarray(masks), min_count)
    assert got_f.dtype == torch.bool
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


@pytest.mark.parametrize("n,c,w,z", CASES, ids=IDS)
def test_support_count_sites_matches_jax(n, c, w, z):
    tx, masks = _sites(n + c + w, n, c, w, z)
    got = ops.support_count_sites(_t(tx), _t(masks)).numpy()
    want = np.asarray(jops.support_count_sites(jnp.asarray(tx), jnp.asarray(masks)))
    assert got.shape == (3, c)
    np.testing.assert_array_equal(got, want)
    for s in range(3):
        np.testing.assert_array_equal(
            got[s], np.asarray(jax_support_count_ref(jnp.asarray(tx[s]), jnp.asarray(masks[s])))
        )


@pytest.mark.parametrize("n,c,w,z", CASES, ids=IDS)
def test_support_count_prune_sites_matches_jax(n, c, w, z):
    tx, masks = _sites(2 * n + c + w, n, c, w, z)
    min_counts = np.array([1, max(1, n // 4), max(1, n // 2)], dtype=np.int32)  # unequal per site
    got_c, got_f = ops.support_count_prune_sites(_t(tx), _t(masks), torch.from_numpy(min_counts))
    want_c, want_f = jops.support_count_prune_sites(
        jnp.asarray(tx), jnp.asarray(masks), jnp.asarray(min_counts)
    )
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


def test_all_zero_mask_counts_every_row():
    """No pad rows, so no pad correction: an empty itemset is in every
    transaction the kernel is given."""
    tx, _ = _words(np.random.default_rng(5), 33, 1, 2, 0)
    masks = np.zeros((2, 2), dtype=np.uint32)
    np.testing.assert_array_equal(ops.support_count(_t(tx), _t(masks)).numpy(), [33, 33])


def test_plain_version_chunks_over_candidates():
    """The C chunking of the plain version never changes a count."""
    tx, masks = _sites(9, 120, 70, 2, 3)
    full = ref.support_count_sites_ref(_t(tx), _t(masks))
    chunked = ref.support_count_sites_ref(_t(tx), _t(masks), block_c=16)
    assert torch.equal(full, chunked)


def test_wrappers_reject_what_the_kernel_does_not_take():
    tx = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.support_count(tx.to(torch.int64), torch.zeros((3, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        ops.support_count(tx, torch.zeros((3, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.support_count_prune_sites(tx[None], torch.zeros((1, 3, 2), dtype=torch.int32), [1, 2])


def test_cpu_calls_launch_nothing():
    ops.reset_launches()
    tx, masks = _sites(3, 40, 6, 2, 0)
    ops.support_count_sites(_t(tx), _t(masks))
    ops.support_count_prune(_t(tx[0]), _t(masks[0]), 3)
    assert all(v == 0 for v in ops.LAUNCHES.values())


# the bit-sliced layout of the CUDA count's two stages (ref.vertical_bitmap_ref,
# ref.support_count_vertical_sites_ref): N on both sides of a 32-row word,
# the narrowest, an odd and the widest word count
VERTICAL = [(n, w) for n in (1, 31, 32, 33, 700) for w in (1, 3, 32)]
VERTICAL_IDS = [f"n{n}-w{w}" for n, w in VERTICAL]


def _vertical_case(n, w, s=3):
    """Dense transactions whose last rows are zero (the pad rows
    ``_stack_sites`` adds to shorter sites), and masks: two all-zero, 1-3
    items, every bit of word 0, and 40 items spread over the words (all 32
    bits of the one word when W = 1)."""
    rng = np.random.default_rng(n * 7 + w)
    tx, masks = _sites(n + 5 * w, n, 12, w, 2, s)
    tx[:, n - min(n, 2) :] = 0
    masks[:, 2] = 0
    masks[:, 2, 0] = 0xFFFFFFFF
    masks[:, 3] = 0
    for b in rng.choice(32 * w, size=min(40, 32 * w), replace=False):
        masks[:, 3, b // 32] |= np.uint32(1) << np.uint32(b % 32)
    return tx, masks


@pytest.mark.parametrize("n,w", VERTICAL, ids=VERTICAL_IDS)
def test_vertical_bitmap_layout(n, w):
    """Bit r of vt[s, i, j] is item i of transaction 32j + r, zero past N;
    ops.vertical_bitmap takes the plain version on the CPU."""
    tx, _ = _vertical_case(n, w)
    vt = ref.vertical_bitmap_ref(_t(tx))
    nw = -(-n // 32)
    assert vt.dtype == torch.int32 and tuple(vt.shape) == (3, 32 * w, nw)
    bits = np.unpackbits(tx.view(np.uint8).reshape(3, n, w, 4), axis=-1, bitorder="little").reshape(3, n, 32 * w)
    rows = np.zeros((3, 32 * nw, 32 * w), dtype=np.uint8)
    rows[:, :n] = bits
    got = np.unpackbits(vt.numpy().view(np.uint8).reshape(3, 32 * w, nw, 4), axis=-1, bitorder="little")
    np.testing.assert_array_equal(got.reshape(3, 32 * w, 32 * nw), rows.transpose(0, 2, 1))
    assert torch.equal(ops.vertical_bitmap(_t(tx)), vt)


@pytest.mark.parametrize("n,w", VERTICAL, ids=VERTICAL_IDS)
def test_vertical_count_matches_jax(n, w):
    """Counts from the vertical layout equal the JAX Pallas kernel's (in
    interpret mode), its oracle's and the horizontal plain version's, pad
    rows and all-zero masks included; so do the thresholds."""
    tx, masks = _vertical_case(n, w)
    vt = ref.vertical_bitmap_ref(_t(tx))
    got = ref.support_count_vertical_sites_ref(vt, _t(masks), n)
    want = np.asarray(jops.support_count_sites(jnp.asarray(tx), jnp.asarray(masks)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref.support_count_sites_ref(_t(tx), _t(masks)).numpy())
    for s in range(3):
        np.testing.assert_array_equal(
            got[s].numpy(), np.asarray(jax_support_count_ref(jnp.asarray(tx[s]), jnp.asarray(masks[s])))
        )
    assert (got[:, :2] == n).all()  # all-zero masks count every row given, pad rows too
    min_counts = torch.tensor([1, max(1, n // 4), n], dtype=torch.int32)
    counts, flags = ops.support_count_vertical_sites(vt, _t(masks), n, min_counts)
    assert torch.equal(counts, got) and torch.equal(flags, got >= min_counts[:, None])
