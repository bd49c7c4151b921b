"""Prefill/decode parity of the xLSTM model in bf16, in both packages, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xlstm_bf16_parity.py [d_model] [tokens]

The JAX smoke test's property (tests/test_models_smoke.py:48-63): decode of
the last token after a prefill of the rest equals the full forward's last
position within 3e-2.  It holds in float32 at every size; in bfloat16 it
fails at long prompts.  This script prints the largest |decode - forward|
of the JAX package and of the port on reduced xlstm-1.3b widened to
``d_model`` (default 512) over ``tokens`` tokens (default 1,024), in bf16
and f32, and the port's with its mLSTM mixers alone run in f32, which
shows where the bf16 drift comes from.  Takes about a minute.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as JC
from repro.models import transformer as JT
from repro.sharding import ShapeAxes
from repro_torch.configs import get, reduced
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX

B = 2


def jax_drift(d, s, dtype):
    cfg = JC.reduced(JC.get("xlstm-1.3b")).scaled(d_model=d, dtype=dtype, vocab=2048)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.default_rng(1).integers(0, cfg.vocab, (B, s), dtype=np.int32))
    full, _ = JT.forward_train(cfg, params, toks)
    cache = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), JT.cache_specs(cfg, B, s),
                         is_leaf=lambda x: isinstance(x, ShapeAxes))
    _, cache = JT.prefill(cfg, params, toks[:, :-1], cache)
    last, _ = JT.decode_step(cfg, params, toks[:, -1:], jnp.int32(s - 1), cache)
    return float(jnp.abs(last[:, 0] - full[:, -1]).max())


def _mixer_in_f32(fn):
    """A mixer run in f32 on f32 copies of its input and cache; its output
    cast back, its cache kept in f32."""
    def run(cfg, p, x, *cache):
        args = [{k: v.float() for k, v in cache[0].items()}] if cache else []
        y, new = fn(cfg.scaled(dtype="float32"), p, x.float(), *args)
        return y.to(x.dtype), new
    return run


def port_drift(d, s, dtype, mlstm_f32=False):
    real = TX.apply_mlstm, TX.mlstm_decode
    if mlstm_f32:
        TX.apply_mlstm, TX.mlstm_decode = map(_mixer_in_f32, real)
    try:
        cfg = reduced(get("xlstm-1.3b")).scaled(d_model=d, dtype=dtype, vocab=2048)
        model = TT.Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        toks = torch.randint(0, cfg.vocab, (B, s), generator=torch.Generator().manual_seed(1))
        with torch.inference_mode():
            full, _ = TT.forward_train(cfg, model, toks)
            _, cache = TT.prefill(cfg, model, toks[:, :-1], TT.init_cache(cfg, B, s, "cpu"))
            last, _ = TT.decode_step(cfg, model, toks[:, -1:], s - 1, cache)
        return float((last[:, 0] - full[:, -1]).abs().max())
    finally:
        TX.apply_mlstm, TX.mlstm_decode = real


def main():
    d = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    s = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    print(f"reduced xlstm-1.3b at d_model {d}, {s} tokens, batch {B}: max |decode - forward|")
    for dtype in ("bfloat16", "float32"):
        print(f"  {dtype}: JAX package {jax_drift(d, s, dtype):.4g}, port {port_drift(d, s, dtype):.4g}")
    print(f"  bfloat16 with the port's mLSTM mixers in f32: {port_drift(d, s, 'bfloat16', mlstm_f32=True):.4g}")


if __name__ == "__main__":
    main()
