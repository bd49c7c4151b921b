"""The port's flash attention against the JAX package's, on the CPU.

``repro_torch.kernels.ops.flash_attention`` on CPU tensors runs the plain
version (``ref.flash_attention_ref``); ``repro.kernels.ops.flash_attention``
on the CPU runs the Pallas kernel in interpret mode, as tests/test_kernels.py
runs it.  The same seeded numpy arrays go to both.  Tolerances:

* float32: 1e-4 (relative and absolute).  Both compute in f32; only the
  order of the dot products' sums and the key tiles differ.
* bfloat16: 3e-2, the JAX smoke test's bound.  Both round q, k, v, p and
  the output to bf16, but the sums that feed those roundings run in other
  orders, so an output may land one bf16 ulp away.

The CUDA kernel itself is held to the plain version on the card
(``tests/test_torch_guards.py``, marked ``cuda``; ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro_torch.kernels import ops

F32_TOL = 1e-4
BF16_TOL = 3e-2


def _inputs(seed, b, sq, skv, h, kvh, dh):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, n, dh)).astype(np.float32) for s, n in ((sq, h), (skv, kvh), (skv, kvh))]


def _jax(arrays, dtype, **kw):
    q, k, v = (jnp.asarray(a).astype(dtype) for a in arrays)
    return np.asarray(jops.flash_attention(q, k, v, **kw).astype(jnp.float32))


def _port(arrays, dtype, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    out = ops.flash_attention(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


@given(
    b=st.integers(1, 3),
    sq=st.integers(1, 96),
    h_kv=st.sampled_from([(1, 1), (2, 1), (4, 2), (4, 4), (4, 1)]),
    dh=st.sampled_from([16, 32, 64, 96]),
    causal=st.booleans(),
    window=st.sampled_from([0, 16]),
    cap=st.sampled_from([0.0, 30.0]),
    seed=st.integers(0, 2**31 - 1),
)
@settings(max_examples=12, deadline=None)
def test_plain_version_matches_pallas_kernel(b, sq, h_kv, dh, causal, window, cap, seed):
    h, kvh = h_kv
    # the JAX wrapper refuses a non-causal Skv that is not a block multiple
    skv = sq if causal else (sq + 15) // 16 * 16
    arrays = _inputs(seed, b, sq, skv, h, kvh, dh)
    kw = dict(causal=causal, window=window, cap=cap)
    want = _jax(arrays, jnp.float32, block_q=16, block_k=16, **kw)
    got = _port(arrays, torch.float32, **kw)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_plain_version_matches_pallas_kernel_bf16():
    arrays = _inputs(0, 2, 72, 72, 4, 2, 32)
    kw = dict(causal=True, window=16, cap=30.0)
    want = _jax(arrays, jnp.bfloat16, block_q=16, block_k=16, **kw)
    got = _port(arrays, torch.bfloat16, **kw)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("sq,skv", [(40, 64), (64, 64), (96, 32)])
def test_non_causal_block_multiple(sq, skv):
    """Sq != Skv, every key visible to every row (Skv a block multiple, so
    the JAX wrapper pads no key)."""
    arrays = _inputs(sq + skv, 2, sq, skv, 4, 2, 16)
    want = _jax(arrays, jnp.float32, causal=False, cap=30.0, block_q=16, block_k=16)
    got = _port(arrays, torch.float32, causal=False, cap=30.0)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_fully_masked_rows_give_zero():
    """Non-causal with a window shorter than the distance to every key:
    rows 47.. of 72 see none of the 32 keys.  Both give exact zeros there."""
    arrays = _inputs(3, 1, 72, 32, 4, 4, 16)
    kw = dict(causal=False, window=16)
    want = _jax(arrays, jnp.float32, block_q=8, block_k=16, **kw)
    got = _port(arrays, torch.float32, **kw)
    assert np.all(want[:, 47:] == 0.0) and np.all(got[:, 47:] == 0.0)
    assert np.all(np.abs(got[:, :47]).max(axis=-1) > 0)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
