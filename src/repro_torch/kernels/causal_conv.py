"""Python binding of the causal conv + SiLU CUDA kernels of the Mamba-2
mixer.

No TPU kernel stands behind these (the JAX package leaves its mixer's
convolution to XLA as jnp code); the source, its bound and its design are
in ``csrc/causal_conv.cu``. ``causal_conv_silu_kernel`` computes
SiLU(causal depthwise conv(x, w) + b) over (B, S, C), bit for bit the
plain form ``F.silu(ref.causal_conv(x, w, b))`` (the twin
``ref.causal_conv_silu_ref``); ``causal_conv_silu_bwd_kernel`` its gradient
(dx, dw, db), the closed form of ``ref.causal_conv_silu_bwd_ref``, with
dw and db summed in a fixed order (two launches: the pass and the
reduction of its per-block partial sums).

The wrappers only launch: CUDA tensors of one dtype (bfloat16, float32 or
float64), x (B, S, C) with channel stride 1 (any batch and row strides: a
column slice of a wider matrix is read in place), w (W, C) with
1 <= W <= MAX_WIDTH, b (C,), or they raise. They record no gradient:
`repro_torch.kernels.ops.causal_conv_silu` is the entry point (its
autograd Function pairs them on the card; CPU tensors go to the plain
version). ``_build.LAUNCHES`` counts calls, one key a direction.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._build import DTYPE_CODE, I, I64, P, Library, refuse_grad

__all__ = ["KERNEL_NAMES", "MAX_WIDTH", "causal_conv_silu_kernel", "causal_conv_silu_bwd_kernel"]

MAX_WIDTH = 4  # kMaxWidth of the source
# The CUDA kernels of each direction, as a profiler names them.
KERNEL_NAMES = {
    "forward": ("causal_conv_silu_kernel",),
    "backward": ("causal_conv_silu_bwd_kernel", "causal_conv_silu_bwd_reduce_kernel"),
}

_LIB = Library("causal_conv", {
    "causal_conv_silu_launch": (I, [I, P, P, P, P, I, I64, I64, I, I64, I64, P]),
    "causal_conv_silu_bwd_workspace_bytes": (I64, [I, I, I64, I64, I]),
    "causal_conv_silu_bwd_launch": (
        I, [I, P, P, P, P, P, P, P, P, I, I64, I64, I, I64, I64, P]),
})


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, what: str) -> None:
    refuse_grad(what, "causal_conv_silu", x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got x on {x.device}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not supported; the kernel is built for "
                        f"{sorted(str(d) for d in DTYPE_CODE)}")
    if x.dim() != 3 or min(x.shape) < 1 or x.stride(-1) != 1:
        raise ValueError(f"x must be a non-empty (B, S, C) with channel stride 1, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    C = x.shape[-1]
    if w.dim() != 2 or w.shape[1] != C or not 1 <= w.shape[0] <= MAX_WIDTH:
        raise ValueError(f"w must be (W, {C}) with 1 <= W <= {MAX_WIDTH}, got {tuple(w.shape)}")
    for name, t, shape in (("w", w, tuple(w.shape)), ("b", b, (C,))):
        if (tuple(t.shape) != shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: want a contiguous {shape} {x.dtype} tensor on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def causal_conv_silu_kernel(
    x: torch.Tensor,  # (B, S, C), channel stride 1
    w: torch.Tensor,  # (W, C)
    b: torch.Tensor,  # (C,)
) -> torch.Tensor:
    """SiLU(causal conv(x, w) + b), (B, S, C) contiguous in x's dtype."""
    _check(x, w, b, "causal_conv_silu_kernel")
    B, S, C = x.shape
    out = torch.empty((B, S, C), dtype=x.dtype, device=x.device)
    _LIB.launch(
        "causal_conv_silu", x.device,
        DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, S, C, w.shape[0], x.stride(0), x.stride(1),
    )
    return out


def causal_conv_silu_bwd_kernel(
    x: torch.Tensor,  # (B, S, C), channel stride 1
    w: torch.Tensor,  # (W, C)
    b: torch.Tensor,  # (C,)
    g: torch.Tensor,  # (B, S, C) gradient of the output
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx (B, S, C) contiguous, dw (W, C), db (C,)), each in x's dtype.
    ``g`` is taken contiguous in x's dtype (copied if it is not)."""
    _check(x, w, b, "causal_conv_silu_bwd_kernel")
    B, S, C = x.shape
    W = w.shape[0]
    if tuple(g.shape) != (B, S, C) or g.device != x.device:
        raise ValueError(f"g: want {(B, S, C)} on {x.device}, got {tuple(g.shape)} on {g.device}")
    g = g.to(x.dtype).contiguous()
    dx = torch.empty((B, S, C), dtype=x.dtype, device=x.device)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    code = DTYPE_CODE[x.dtype]
    work = torch.empty((_LIB.fn("causal_conv_silu_bwd_workspace_bytes")(code, B, S, C, W),),
                       dtype=torch.uint8, device=x.device)
    _LIB.launch(
        "causal_conv_silu_bwd", x.device,
        code, x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), db.data_ptr(), work.data_ptr(), B, S, C, W, x.stride(0), x.stride(1),
    )
    return dx, dw, db
