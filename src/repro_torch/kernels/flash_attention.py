"""Python binding of the flash-attention CUDA kernel (K3).

Counterpart of the TPU kernel `repro.kernels.flash_attention`
(``flash_attention_kernel``); the CUDA source, its bound and its design
are in ``csrc/flash_attention.cu``. The kernel reads the model's layout
directly: q (B, Sq, H, hd), k/v (B, Skv, KV, hd), out (B, Sq, H, hd).

The wrapper only launches: it takes contiguous CUDA tensors of one dtype
(float32 or bfloat16) with hd in {64, 128, 256} and raises on anything
else. `repro_torch.kernels.ops.flash_attention` is the entry point that
sends CPU tensors to the plain version. ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from . import _build

__all__ = ["LAUNCHES", "HEAD_DIMS", "flash_attention_kernel"]

HEAD_DIMS = (64, 128, 256)  # the instances compiled in the source
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [
        _I, _I, _P, _P, _P, _P, _I, _I, _I, _I64, _I64, _I, _I64, _I64, _P,
    ]
    lib.flash_attention_launch.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got q on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"q dtype {q.dtype} not supported; the kernel is built for "
            f"{sorted(str(d) for d in _DTYPE_CODE)}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-d: (B, S, heads, hd)")
    B, _, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported; built for {HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    for name, t, shape in (("k", k, (B, Skv, KV, hd)), ("v", v, (B, Skv, KV, hd))):
        if tuple(t.shape) != shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name}: want {shape} {q.dtype} on {q.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention_kernel(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention of q over k/v with query positions ``arange(Sq) + q_offset``
    and key positions ``arange(Skv)``; out (B, Sq, H, hd) in q's dtype.

    The kernel has no backward yet: under grad mode, inputs that require a
    gradient raise rather than return an output that would drop it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_kernel has no backward yet (ROADMAP.md Queue 2, "
            "K3 backward kernel): call it under torch.no_grad() or on inputs "
            "that do not require grad"
        )
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_launch(
            _DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, H, KV, Sq, Skv, int(causal),
            0 if window is None else int(window), int(q_offset), stream,
        )
    if err != 0:
        msg = _lib().flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} ({msg})")
    LAUNCHES["flash_attention"] += 1
    return out
