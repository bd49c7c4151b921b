"""The port's xLSTM pieces against the JAX package's, on the CPU.

The same seeded numpy arrays go to ``repro.models.{ssm,xlstm}`` and
``repro.kernels.ops.slstm_scan`` (the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it) and to their ``repro_torch`` counterparts,
whose kernel wrapper runs the plain PyTorch version for CPU tensors.  Every
comparison is in float32 except the stated bfloat16 case, so the two sides
differ only by summation order; each tolerance is stated beside its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro.models import xlstm as jx
from repro.models.config import ModelConfig as JModelConfig
from repro.models.layers import init_from_specs as j_init
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as tx
from repro_torch.models.config import ModelConfig

# float32 against float32 in another summation order: sums of up to a few
# hundred O(1) terms, a few float32 roundings of their size
F32_TOL = 2e-5
# one bfloat16 rounding of the output (2^-8 relative) lands on either side
# of a tie when the float32 values differ in their last bits: one bf16 ulp
BF16_RTOL = 2.0**-7


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree_to_torch(tree):
    return {k: _tree_to_torch(v) if isinstance(v, dict) else _t(v) for k, v in tree.items()}


def _close(got, want, rtol=F32_TOL, atol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# (a) the gated outer-product scan
# ---------------------------------------------------------------------------


def _scan_inputs(seed, b, s, h, n, p):
    rng = np.random.default_rng(seed)
    log_a = -np.log1p(np.exp(-rng.normal(size=(b, s, h)) - 1.0)).astype(np.float32)  # log σ(·) ≤ 0
    gate = (1.0 / (1.0 + np.exp(-rng.normal(size=(b, s, h))))).astype(np.float32)
    k = (rng.normal(size=(b, s, h, n)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(b, s, h, p)) * 0.5).astype(np.float32)
    q = (rng.normal(size=(b, s, h, n)) * 0.5).astype(np.float32)
    h0 = (rng.normal(size=(b, h, n, p)) * 0.5).astype(np.float32)
    return log_a, gate, k, v, q, h0


@pytest.mark.parametrize("s,chunk", [(32, 16), (27, 16), (16, 128)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_gated_outer_scan_matches_jax(s, chunk, with_h0):
    """S a multiple of the chunk, S not a multiple (the identity-step tail
    padding), and one chunk shorter than the default; with and without h0."""
    arrs = _scan_inputs(s + chunk, 2, s, 3, 8, 5)
    h0 = arrs[5] if with_h0 else None
    jy, jh = jssm.gated_outer_scan(*map(jnp.asarray, arrs[:5]), h0=None if h0 is None else jnp.asarray(h0),
                                   chunk=chunk)
    ty, th = tssm.gated_outer_scan(*map(_t, arrs[:5]), h0=None if h0 is None else _t(h0), chunk=chunk)
    assert ty.shape == (2, s, 3, 5) and th.shape == (2, 3, 8, 5)
    _close(ty, jy)
    _close(th, jh)


def test_gated_outer_step_matches_jax():
    log_a, gate, k, v, q, h0 = _scan_inputs(7, 2, 1, 3, 8, 5)
    args = (log_a[:, 0], gate[:, 0], k[:, 0], v[:, 0], q[:, 0], h0)
    jy, jh = jssm.gated_outer_step(*map(jnp.asarray, args))
    ty, th = tssm.gated_outer_step(*map(_t, args))
    _close(ty, jy)
    _close(th, jh)


# ---------------------------------------------------------------------------
# (b) the sLSTM scan's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def _slstm_case(seed, b, s, d, h):
    cfg = JModelConfig(n_layers=1, d_model=d, n_heads=h, n_kv_heads=h, head_dim=d // h, d_ff=0, vocab=64,
                       dtype="float32")
    p = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), jx.slstm_spec(cfg)))
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, s, d)) * 0.5).astype(np.float32)
    wx = np.einsum("bsd,dhq->bshq", x, p["w"]).astype(np.float32)
    return p, wx


@pytest.mark.parametrize("b,s,d,h", [(2, 16, 32, 2), (3, 24, 64, 4), (1, 8, 16, 1)])
def test_slstm_scan_ref_matches_pallas(b, s, d, h):
    """The JAX kernel tests' shapes, f32, zero initial state."""
    p, wx = _slstm_case(0, b, s, d, h)
    zero = np.zeros((b, h, d // h), np.float32)
    jh, jst = jops.slstm_scan(jnp.asarray(wx), jnp.asarray(p["r"]), jnp.asarray(p["bias"]),
                              (jnp.asarray(zero),) * 3)
    th, tst = ref.slstm_scan_ref(_t(wx), _t(p["r"]), _t(p["bias"]), (_t(zero),) * 3)
    assert th.shape == (b, s, h, d // h) and th.dtype == torch.float32
    _close(th, jh)
    for a, c in zip(tst, jst):
        _close(a, c)
    # the wrapper takes the plain version for CPU tensors, and launches nothing
    ops.reset_launches()
    wh, wst = ops.slstm_scan(_t(wx), _t(p["r"]), _t(p["bias"]), (_t(zero),) * 3)
    assert torch.equal(wh, th) and all(torch.equal(x, y) for x, y in zip(wst, tst))
    assert ops.LAUNCHES["slstm_scan"] == 0


def test_slstm_scan_ref_matches_pallas_bf16_nonzero_state():
    """bf16 wx, f32 R and bias, a non-zero bf16 initial state: both carry the
    state in f32 and round only the outputs to bf16."""
    b, s, d, h = 3, 24, 64, 4
    p, wx = _slstm_case(1, b, s, d, h)
    rng = np.random.default_rng(1)
    st = [rng.normal(size=(b, h, d // h)).astype(np.float32) * sc for sc in (1.0, 0.5, 0.5)]
    st[1] = np.abs(st[1]) + 0.5  # the normaliser is positive
    jwx = jnp.asarray(wx).astype(jnp.bfloat16)
    jstate = tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in st)
    jh, jst = jops.slstm_scan(jwx, jnp.asarray(p["r"]), jnp.asarray(p["bias"]), jstate)
    th, tst = ref.slstm_scan_ref(_t(wx, torch.bfloat16), _t(p["r"]), _t(p["bias"]),
                                 tuple(_t(a, torch.bfloat16) for a in st))
    assert th.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in tst)
    # the same bf16 inputs on both sides
    np.testing.assert_array_equal(_np(_t(wx, torch.bfloat16)), _np(jwx))
    _close(th, jh, rtol=BF16_RTOL, atol=1e-6)
    for a, c in zip(tst, jst):
        _close(a, c, rtol=BF16_RTOL, atol=1e-6)


# xlstm-1.3b's sLSTM head shape (d_model 2048 over 4 heads: P 512), at the
# serving batch and a short sequence
XL_HEADS, XL_P, XL_B, XL_S = 4, 512, 8, 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_scan_matches_pallas_at_xlstm_head_shape(dtype):
    """The plain version, and the wrapper on CPU tensors (which launches
    nothing), against the Pallas kernel at xlstm-1.3b's real head shape:
    float32 from a zero state, bfloat16 from a non-zero one."""
    p, wx = _slstm_case(2, XL_B, XL_S, XL_HEADS * XL_P, XL_HEADS)
    shape = (XL_B, XL_HEADS, XL_P)
    if dtype == "float32":
        st = [np.zeros(shape, np.float32)] * 3
        tdt, jdt, rtol, atol = torch.float32, jnp.float32, F32_TOL, F32_TOL
    else:
        rng = np.random.default_rng(2)
        st = [rng.normal(size=shape).astype(np.float32) * sc for sc in (1.0, 0.5, 0.5)]
        st[1] = np.abs(st[1]) + 0.5  # the normaliser is positive
        tdt, jdt, rtol, atol = torch.bfloat16, jnp.bfloat16, BF16_RTOL, 1e-6
    jh, jst = jops.slstm_scan(jnp.asarray(wx).astype(jdt), jnp.asarray(p["r"]), jnp.asarray(p["bias"]),
                              tuple(jnp.asarray(a).astype(jdt) for a in st))
    args = (_t(wx, tdt), _t(p["r"]), _t(p["bias"]), tuple(_t(a, tdt) for a in st))
    th, tst = ref.slstm_scan_ref(*args)
    assert th.shape == (XL_B, XL_S, XL_HEADS, XL_P) and th.dtype == tdt
    _close(th, jh, rtol=rtol, atol=atol)
    for a, c in zip(tst, jst):
        _close(a, c, rtol=rtol, atol=atol)
    ops.reset_launches()
    wh, wst = ops.slstm_scan(*args)
    assert torch.equal(wh, th) and all(torch.equal(x, y) for x, y in zip(wst, tst))
    assert ops.LAUNCHES["slstm_scan"] == 0


@pytest.mark.parametrize(
    "b,h,p,max_ctas,match",
    [(9, 4, 512, None, "B <= 8"), (8, 4, 520, None, "multiple of 16"), (8, 4, 0, None, "multiple of 16"),
     (1, 1, 784, None, "at most 768"), (8, 5, 512, 132, "co-resident"), (1, 1, 8, None, "multiple of 16")],
)
def test_slstm_kernel_limits_raise_past_them(b, h, p, max_ctas, match):
    with pytest.raises(ValueError, match=match):
        ops.check_slstm_kernel_limits(b, h, p, max_ctas)


@pytest.mark.parametrize("b,h,p", [(XL_B, XL_HEADS, XL_P), (1, 1, 16), (8, 1, 768), (3, 2, 48)])
def test_slstm_kernel_limits_accept_the_path_and_its_edges(b, h, p):
    ops.check_slstm_kernel_limits(b, h, p, 132)


@pytest.mark.parametrize("b,nb", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8)])
def test_slstm_scratch_shapes(b, nb):
    """The exchange buffer holds two steps of one tagged word per (head,
    unit, padded batch row); the phase timers one row per CTA (H·P/16)."""
    shapes = ops.slstm_scratch_shapes(b, 4, 512)
    assert shapes["exchange"] == (2, 4, 512, nb)
    assert shapes["cycles"] == (128, len(ops.SLSTM_PHASES))


def test_slstm_phase_split_from_cycles():
    """Phases as µs a step, the clock calibrated so that they add up to the
    timed launch; the wait's spread over CTAs."""
    cycles = torch.tensor([[400, 100, 50, 300, 150], [400, 100, 50, 500, 150]], dtype=torch.int64) * 1000
    split = ops.slstm_phase_split(cycles, steps=10, timed_ms=1.2)
    assert split["ctas"] == 2 and split["timed_us_per_step"] == pytest.approx(120.0)
    assert split["clock_mhz"] == pytest.approx(1100e3 / 1.2e-3 / 1e6)
    us = split["us_per_step"]
    assert list(us) == list(ops.SLSTM_PHASES)
    assert sum(us.values()) == pytest.approx(120.0)
    assert us["wait"] == pytest.approx(400e3 / (1100e3 / 1.2e-3) * 1e6 / 10)
    lo, hi = split["wait_us_per_step_min_max"]
    assert lo < us["wait"] < hi


def test_slstm_phase_cycles_refuses_cpu_tensors():
    wx = torch.zeros((1, 2, 1, 64))
    st = (torch.zeros((1, 1, 16)),) * 3
    with pytest.raises(ValueError, match="CUDA"):
        ops.slstm_scan_phase_cycles(wx, torch.zeros((1, 16, 64)), torch.zeros((1, 64)), st)


def test_slstm_scan_wrapper_checks_its_operands():
    wx = torch.zeros((2, 3, 2, 64))
    r, bias = torch.zeros((2, 16, 64)), torch.zeros((2, 64))
    st = (torch.zeros((2, 2, 16)),) * 3
    with pytest.raises(ValueError, match="want R"):
        ops.slstm_scan(wx, r[:, :8], bias, st)
    with pytest.raises(TypeError, match="R and bias must be float32"):
        ops.slstm_scan(wx, r.double(), bias, st)
    with pytest.raises(TypeError, match="initial state"):
        ops.slstm_scan(wx.bfloat16(), r, bias, st)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.slstm_scan(wx, r.to("meta"), bias, st)
    h, (c, n, hh) = ops.slstm_scan(wx[:, :0], r, bias, st)  # S = 0: the state passes through
    assert h.shape == (2, 0, 2, 16) and torch.equal(c, st[0])
    ops.check_slstm_kernel_limits(8, 4, 512, 132)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.check_slstm_kernel_limits(1, 1, 24)
    with pytest.raises(ValueError, match="at most 768"):
        ops.check_slstm_kernel_limits(1, 1, 784)
    with pytest.raises(ValueError, match="B <= 8"):
        ops.check_slstm_kernel_limits(9, 1, 16)
    with pytest.raises(ValueError, match="co-resident"):
        ops.check_slstm_kernel_limits(8, 8, 512, 132)


# ---------------------------------------------------------------------------
# (c) the mixers at reduced widths
# ---------------------------------------------------------------------------


def _mixer_case(spec_fn, seed, b, s):
    jcfg = JModelConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=0, vocab=64,
                        dtype="float32")
    tcfg = ModelConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=0, vocab=64,
                       dtype="float32")
    p = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), spec_fn(jcfg)))
    x = (np.random.default_rng(seed).normal(size=(b, s, 64)) * 0.5).astype(np.float32)
    return jcfg, tcfg, p, _tree_to_torch(p), x


def test_mlstm_apply_and_decode_match_jax():
    jcfg, tcfg, p, tp, x = _mixer_case(jx.mlstm_spec, 3, 2, 20)
    jy, jc = jx.apply_mlstm(jcfg, p, jnp.asarray(x[:, :-1]))
    ty, tc = tx.apply_mlstm(tcfg, tp, _t(x[:, :-1]))
    _close(ty, jy)
    _close(tc["h"], jc["h"])
    jd, jc2 = jx.mlstm_decode(jcfg, p, jnp.asarray(x[:, -1:]), jc)
    td, tc2 = tx.mlstm_decode(tcfg, tp, _t(x[:, -1:]), tc)
    _close(td, jd)
    _close(tc2["h"], jc2["h"])


@pytest.mark.parametrize("kernel", [False, True])
def test_slstm_apply_and_decode_match_jax(kernel):
    """Both branches of apply_slstm (the kernel's plain version on the CPU,
    and the per-step cell loop), then the cell's decode step."""
    jcfg, tcfg, p, tp, x = _mixer_case(jx.slstm_spec, 4, 2, 20)
    jcfg, tcfg = jcfg.scaled(slstm_kernel=kernel), tcfg.scaled(slstm_kernel=kernel)
    jy, jc = jx.apply_slstm(jcfg, p, jnp.asarray(x[:, :-1]))
    ty, tc = tx.apply_slstm(tcfg, tp, _t(x[:, :-1]))
    _close(ty, jy)
    for k in ("c", "n", "hid"):
        _close(tc[k], jc[k])
    jd, jc2 = jx.slstm_decode(jcfg, p, jnp.asarray(x[:, -1:]), jc)
    td, tc2 = tx.slstm_decode(tcfg, tp, _t(x[:, -1:]), tc)
    _close(td, jd)
    for k in ("c", "n", "hid"):
        _close(tc2[k], jc2[k])
