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


@pytest.mark.parametrize("dh", [16, 64, 96, 128, 256])
def test_tensor_core_scores_keep_the_plain_versions_semantics(dh):
    """The contract the bf16 tensor-core kernel (csrc/flash_attention_wgmma.cu)
    relies on.  It computes ``scale·(q·k)`` with bf16 x bf16 products (exact
    in f32) summed in f32 in 16-deep steps; the plain version computes
    ``(f32(q)·scale)·f32(k)``.  Where ``scale = 1/sqrt(Dh)`` is a power of
    two, ``q·scale`` is exact in bf16 (it round-trips), so the two differ only
    in the order of the sums; elsewhere by one more f32 rounding.  Either way
    they lie within ``4·Dh·2⁻²⁴·Σ|q·k|·scale`` of each other (each sum is
    within ``Dh·2⁻²⁴·Σ|q·k|`` of the exact one)."""
    rng = np.random.default_rng(dh)
    q = torch.from_numpy(rng.normal(size=(64, dh)).astype(np.float32)).to(torch.bfloat16).float()
    k = torch.from_numpy(rng.normal(size=(64, dh)).astype(np.float32)).to(torch.bfloat16).float()
    scale = 1.0 / np.sqrt(dh)
    power_of_two = float(np.log2(scale)).is_integer()
    qs = q * scale
    assert torch.equal(qs.to(torch.bfloat16).float(), qs) == power_of_two
    plain = torch.einsum("qd,kd->qk", qs, k)
    steps = torch.zeros_like(plain)
    for d0 in range(0, dh, 16):  # one wgmma k-step at a time, accumulated in f32
        steps = steps + q[:, d0 : d0 + 16] @ k[:, d0 : d0 + 16].T
    kernel = steps * scale
    bound = 4 * dh * 2.0**-24 * (q.abs() @ k.abs().T) * scale
    assert bool(((kernel - plain).abs() <= bound).all())
