"""Python binding of the RG-LRU scan CUDA kernel (K5).

Counterpart of the TPU kernel `repro.kernels.rglru_scan`
(``rglru_scan_kernel``); the CUDA source, its bound and its design are in
``csrc/rglru_scan.cu``. It computes h_t = a_t * h_{t-1} + b_t over
(B, S, W) float32 inputs from an initial state h0 (B, W) or zeros, as a
chained scan over chunks of S (a reset kernel, then the scan kernel).

The wrapper only launches: contiguous float32 CUDA tensors, or it raises.
`repro_torch.kernels.ops.rglru_scan` is the entry point that sends CPU
tensors to the plain version. ``LAUNCHES`` counts calls: one call is the
reset and the scan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["LAUNCHES", "CHUNK_STEPS", "rglru_scan_kernel"]

LAUNCHES: Dict[str, int] = {"rglru_scan": 0}
CHUNK_STEPS = 32  # steps of S per block: kChunk of the source

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    lib.rglru_scan_launch.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I64, _I64, _P]
    lib.rglru_scan_launch.restype = _I
    lib.rglru_scan_scratch_bytes.argtypes = [_I, _I64, _I64]
    lib.rglru_scan_scratch_bytes.restype = _I64
    lib.rglru_scan_error_string.argtypes = [_I]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def rglru_scan_kernel(
    a: torch.Tensor,  # (B, S, W) float32
    b: torch.Tensor,  # (B, S, W) float32
    h0: Optional[torch.Tensor] = None,  # (B, W) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (h (B, S, W) f32, h_last (B, W) f32).

    The kernel has no backward yet: under grad mode, inputs that require a
    gradient raise rather than return outputs that would drop it."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, h0)
    ):
        raise RuntimeError(
            "rglru_scan_kernel has no backward yet (ROADMAP.md Queue 2, K5 "
            "backward kernel): call it under torch.no_grad() or on inputs "
            "that do not require grad"
        )
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got a on {a.device}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, W), got shape {tuple(a.shape)}")
    B, S, W = a.shape
    operands = [("a", a, (B, S, W)), ("b", b, (B, S, W))]
    if h0 is not None:
        operands.append(("h0", h0, (B, W)))
    for name, t, shape in operands:
        if (
            tuple(t.shape) != shape
            or t.dtype != torch.float32
            or t.device != a.device
            or not t.is_contiguous()
        ):
            raise ValueError(
                f"{name}: want a contiguous {shape} float32 tensor on "
                f"{a.device}, got {tuple(t.shape)} {t.dtype} on {t.device} "
                f"contiguous={t.is_contiguous()}"
            )
    h = torch.empty_like(a)
    h_last = torch.empty((B, W), dtype=torch.float32, device=a.device)
    lib = _lib()
    scratch = torch.empty(
        lib.rglru_scan_scratch_bytes(B, S, W), dtype=torch.uint8, device=a.device
    )
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            h.data_ptr(), h_last.data_ptr(), scratch.data_ptr(), B, S, W, stream,
        )
    if err != 0:
        msg = _lib().rglru_scan_error_string(err).decode()
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err} ({msg})")
    LAUNCHES["rglru_scan"] += 1
    return h, h_last
