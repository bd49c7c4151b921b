"""The port's xlstm-1.3b model against the JAX package's, on the CPU.

``reduced(xlstm-1.3b)`` (the same reduction on both sides), with the sLSTM
kernel path off and on, in float32 and in bfloat16.  The JAX package draws
the parameters; ``convert.model_params_from_reference`` hands them to the
port.  Seeded numpy tokens go through ``forward_train``, ``prefill`` and
``decode_step`` on both sides; the logits and every cache leaf are held to
stated tolerances.  136 tokens, so the prefill of 135 takes the mLSTM
scan's tail padding (chunk 128).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import transformer as JT
from repro.sharding import ShapeAxes
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import transformer as TT
from repro_torch.train.steps import make_decode_step, make_prefill_step

B, S = 2, 136
# float32: the two sides differ by summation order only, through 16 layers
F32_TOL = 1e-4
# bfloat16: both round every op's result to bf16, in places that differ
# (XLA may keep a fusion's intermediates in f32): the JAX smoke test's
# prefill/decode tolerance
BF16_TOL = 3e-2


def _configs(kernel: bool, dtype: str):
    j = JC.reduced(JC.get("xlstm-1.3b")).scaled(slstm_kernel=kernel, dtype=dtype)
    t = TC.reduced(TC.get("xlstm-1.3b")).scaled(slstm_kernel=kernel, dtype=dtype)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_host(got), _host(want), rtol=tol, atol=tol)


def _close_trees(got: dict, want: dict, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _close_trees(got[k], want[k], tol)
        elif isinstance(want[k], list):
            assert len(got[k]) == len(want[k])
            for g, w in zip(got[k], want[k]):
                _close_trees(g, w, tol)
        else:
            assert got[k].shape == np.shape(want[k]), k
            _close(got[k], want[k], tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("kernel", [False, True])
def test_xlstm_serving_matches_jax(kernel, dtype, tol):
    jcfg, tcfg = _configs(kernel, dtype)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.model_params_from_reference(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    ttoks = torch.from_numpy(toks).long()

    jfull, _ = JT.forward_train(jcfg, jparams, jnp.asarray(toks))
    with torch.inference_mode():
        tfull, aux = TT.forward_train(tcfg, model, ttoks)
    assert tfull.shape == (B, S, tcfg.vocab_padded) and tfull.dtype == torch.float32
    assert float(aux["aux_loss"]) == 0.0
    _close(tfull, jfull, tol)

    jcache0 = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), JT.cache_specs(jcfg, B, S),
                           is_leaf=lambda x: isinstance(x, ShapeAxes))
    jlg, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :-1]), jcache0)
    tlg, tcache = make_prefill_step(tcfg)(model, {"tokens": ttoks[:, :-1]}, TT.init_cache(tcfg, B, S, "cpu"))
    _close(tlg, jlg, tol)
    _close_trees(convert.cache_to_reference(tcfg, tcache), jax.tree.map(np.asarray, jcache), tol)

    jd, jcache2 = JT.decode_step(jcfg, jparams, jnp.asarray(toks[:, -1:]), jnp.int32(S - 1), jcache)
    td, tcache2 = make_decode_step(tcfg)(model, {"token": ttoks[:, -1:], "pos": S - 1}, tcache)
    _close(td, jd, tol)
    _close_trees(convert.cache_to_reference(tcfg, tcache2), jax.tree.map(np.asarray, jcache2), tol)
    # the port's own prefill/decode parity, at the JAX smoke test's tolerance
    _close(td[:, 0], tfull[:, -1], 3e-2)


def test_cache_round_trip_keeps_bits():
    """The JAX cache -> the port's -> back, bf16 leaves included."""
    jcfg, tcfg = _configs(False, "bfloat16")
    rng = np.random.default_rng(1)
    jcache = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape), s.dtype), JT.cache_specs(jcfg, B, S),
                          is_leaf=lambda x: isinstance(x, ShapeAxes))
    tcache = convert.cache_from_reference(tcfg, jax.tree.map(np.asarray, jcache), "cpu")
    assert len(tcache) == tcfg.n_layers and tcache[0]["h"].dtype == torch.bfloat16
    _close_trees(convert.cache_to_reference(tcfg, tcache), jax.tree.map(np.asarray, jcache), 0.0)
    # layer g·P + slot is group g, slot `slot`
    np.testing.assert_array_equal(_host(tcache[8 + 7]["c"]), _host(jcache["groups"]["7"]["c"][1]))


def test_cache_specs_match_jax():
    jcfg, tcfg = _configs(True, "bfloat16")
    want = JT.cache_specs(jcfg, B, S)["groups"]
    got = TT.cache_specs(tcfg, B, S)["groups"]
    assert sorted(got) == sorted(want)
    for slot in want:
        assert {k: (v.shape, v.dtype) for k, v in got[slot].items()} == \
            {k: (v.shape, v.dtype) for k, v in want[slot].items()}


def test_param_count_matches_jax_at_full_width():
    """Counted from specs on both sides, never materialised."""
    n = TT.param_count(TC.get("xlstm-1.3b"))
    assert n == JT.param_count(JC.get("xlstm-1.3b")) == 1_665_014_096
    assert dataclasses.asdict(TC.get("xlstm-1.3b")) == dataclasses.asdict(JC.get("xlstm-1.3b"))


# the archs the port runs: the dense attention archs since its attention
# slice (tests/test_torch_gemma2.py holds them to the JAX package), the MoE
# archs and zamba2 since the MoE and Mamba-2 slice (tests/test_torch_moe.py,
# tests/test_torch_zamba2.py), the encoder-decoder and the patch frontend
# since slice 7d (tests/test_torch_seamless.py, tests/test_torch_phi3_vision.py)
DENSE_ATTENTION_ARCHS = ("phi3-mini-3.8b", "granite-20b", "stablelm-1.6b", "gemma2-2b")
RUNNABLE_ARCHS = DENSE_ATTENTION_ARCHS + ("deepseek-moe-16b", "mixtral-8x22b", "zamba2-1.2b",
                                          "seamless-m4t-large-v2", "phi-3-vision-4.2b")


@pytest.mark.parametrize("arch", [a for a in JC.ARCHS if a != "xlstm-1.3b"])
def test_archs_the_port_cannot_run_yet_raise(arch):
    """No arch of the repo is left that the port cannot run: each one's
    config equals the reference's, and its reduced model builds (an
    encoder-decoder's with its encoder)."""
    assert arch in TC.ARCHS and arch in RUNNABLE_ARCHS
    assert dataclasses.asdict(TC.get(arch)) == dataclasses.asdict(JC.get(arch))
    model = TT.Model(TC.reduced(TC.get(arch)), device="cpu")
    assert model.cfg.name == f"{arch}-reduced"
    assert hasattr(model, "encoder") == TC.get(arch).is_encdec
