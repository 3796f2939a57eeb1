"""Pieces the plain references share: float32 products (TF32 off), the
control's fp8 products, RMSNorm, the row-weighted next-token loss, and the
weight layout rules the benchmark draws weights by.

Plain PyTorch only: nothing here imports the program.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

__all__ = ["PRECISIONS", "exact_float32", "mm", "rmsnorm", "row_nll", "normal", "const"]

# "float32": every product in float32 (the reference). "fp8": the control,
# the reference with each operand of its weight products (projections,
# attention's two products, experts, head) rounded to float8 e4m3 with a
# per-tensor scale, the step below bfloat16 that a later change could be
# tempted by; sums stay float32.
PRECISIONS = ("float32", "fp8")
_E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """Float32 products without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _Fp8(torch.autograd.Function):
    """Round to e4m3 under a per-tensor scale; the gradient passes
    through unchanged (the forward's rounding is what the control adds)."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32, or with both operands rounded to fp8 first."""
    if precision == "fp8":
        a, b = _Fp8.apply(a), _Fp8.apply(b)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r} (known: {PRECISIONS})")
    return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) * (1 + scale): the scale is stored as an offset from 1."""
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * (1.0 + scale)


def row_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each row's mean next-token negative log-likelihood: (R, S, V) -> (R,)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean(dim=-1)


def normal(shape, scale: float, dtype: str = "model"):
    """A leaf drawn from N(0, scale^2), stored in the model's dtype."""
    return (tuple(shape), ("normal", scale), dtype)


def const(shape, value: float, dtype: str = "model"):
    return (tuple(shape), ("const", value), dtype)
