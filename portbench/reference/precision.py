"""The matmul every reference calls, in two precisions: float32 (TF32 off),
and the control one step below the configurations' bfloat16, fp8.

The fp8 product rounds both operands to ``float8_e4m3fn`` with one scale a
tensor (its absolute max over 448, the format's largest value) and
multiplies the rounded values in float32; its backward rounds the incoming
gradient to ``float8_e5m2`` (largest 57,344) the same way before its two
products, as an fp8 training recipe does.  Everything outside the
matmuls stays float32.
"""

from __future__ import annotations

import torch


def no_tf32() -> None:
    """Float32 matmuls in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = torch.clamp(x.detach().abs().amax().float(), min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _round(x, torch.float8_e4m3fn, 448.0)


def fp8_grad(x: torch.Tensor) -> torch.Tensor:
    return _round(x, torch.float8_e5m2, 57344.0)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_grad(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.reshape(-1, qa.shape[-1]).transpose(0, 1) @ qg.reshape(-1, qg.shape[-1])
        return ga, gb.reshape(qb.shape)


def matmul(precision: str):
    """``mm(a, b)``: ``a`` (..., K) times ``b`` (K, N) in ``precision``,
    ``"float32"``, ``"fp8"``, or ``"bfloat16"`` (both operands rounded to
    bfloat16, the product in float32: a witness of what bfloat16 GEMMs
    alone do to an answer, never a limit's reading)."""
    if precision == "float32":
        return lambda a, b: a.float() @ b.float()
    if precision == "bfloat16":
        return lambda a, b: a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    if precision == "fp8":
        return lambda a, b: _Fp8Matmul.apply(a.float(), b.float())
    raise ValueError(f"unknown precision {precision!r}")
