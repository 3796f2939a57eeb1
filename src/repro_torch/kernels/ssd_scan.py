"""Python binding of the chunked SSD scan CUDA kernel (K4).

Counterpart of the TPU kernel `repro.kernels.ssd_scan`
(``ssd_scan_kernel``); the CUDA source, its bound and its design are in
``csrc/ssd_scan.cu``. From a zero state it computes the Mamba-2 scan
h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T, y_t = h_t C_t in the
chunked form and returns y (B, S, H, P) and the final state h_fin
(B, H, P, N), both float32. A ragged S (not a multiple of ``chunk``) is
masked in the kernel, with the reference's dt = 0 padding semantics.

The wrapper only launches: contiguous CUDA tensors, x/Bm/Cm in one of
float32 or bfloat16, dt and A in float32, P <= 64, N <= 128 and
1 <= chunk <= 1024, or it raises. `repro_torch.kernels.ops.ssd_scan` is
the entry point (CPU tensors to the plain version, and the gradient).
``LAUNCHES`` counts calls: one call is the kernel's three passes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from . import _build

__all__ = ["LAUNCHES", "MAX_P", "MAX_N", "MAX_CHUNK", "ssd_scan_kernel"]

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024  # the tiles of the source
LAUNCHES: Dict[str, int] = {"ssd_scan": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I64, _I, _I, _I, _I, _P,
    ]
    lib.ssd_scan_launch.restype = _I
    lib.ssd_scan_error_string.argtypes = [_I]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got x on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"x dtype {x.dtype} not supported; the kernel is built for "
            f"{sorted(str(d) for d in _DTYPE_CODE)}"
        )
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got shape {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(
            f"P={P}, N={N}, chunk={chunk}: the kernel takes P <= {MAX_P}, "
            f"N <= {MAX_N}, 1 <= chunk <= {MAX_CHUNK}"
        )
    operands = (
        ("dt", dt, (B, S, H), torch.float32),
        ("A", A, (H,), torch.float32),
        ("Bm", Bm, (B, S, N), x.dtype),
        ("Cm", Cm, (B, S, N), x.dtype),
    )
    for name, t, shape, dtype in operands:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(
                f"{name}: want {shape} {dtype} on {x.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_scan_kernel(
    x: torch.Tensor,  # (B, S, H, P) float32 | bfloat16
    dt: torch.Tensor,  # (B, S, H) float32, post-softplus
    A: torch.Tensor,  # (H,) float32, negative
    Bm: torch.Tensor,  # (B, S, N), x's dtype
    Cm: torch.Tensor,  # (B, S, N), x's dtype
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) f32, h_fin (B, H, P, N) f32), zero initial
    state."""
    _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    dev = x.device
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    h_fin = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    states = torch.empty((B, H, nc, N, P), dtype=torch.float32, device=dev)
    decay = torch.empty((B, H, nc), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ssd_scan_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
            states.data_ptr(), decay.data_ptr(), B, S, H, P, N, chunk, stream,
        )
    if err != 0:
        msg = _lib().ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err} ({msg})")
    LAUNCHES["ssd_scan"] += 1
    return y, h_fin
