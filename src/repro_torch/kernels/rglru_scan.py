"""Python binding of the RG-LRU scan CUDA kernel (K5).

Counterpart of the TPU kernel `repro.kernels.rglru_scan`
(``rglru_scan_kernel``); the CUDA source, its bound and its design are in
``csrc/rglru_scan.cu``. It computes h_t = a_t * h_{t-1} + b_t over
(B, S, W) float32 inputs from an initial state h0 (B, W) or zeros, as a
chained scan over chunks of S (a reset kernel, then the scan kernel).

``rglru_scan_bwd_kernel`` is its backward, the reverse chained scan
(a reset, then ``rglru_scan_bwd_kernel``), from a, the saved h and h0.

The wrappers only launch: contiguous float32 CUDA tensors, or they raise,
and neither records a gradient. `repro_torch.kernels.ops.rglru_scan` is
the entry point: its autograd Function pairs them on the card, and it
sends CPU tensors to the plain version. ``LAUNCHES`` counts calls: one
call is the reset and the scan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["LAUNCHES", "CHUNK_STEPS", "rglru_scan_kernel", "rglru_scan_bwd_kernel"]

LAUNCHES: Dict[str, int] = {"rglru_scan": 0, "rglru_scan_bwd": 0}
CHUNK_STEPS = 32  # steps of S per block: kChunk of the source

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    lib.rglru_scan_launch.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I64, _I64, _P]
    lib.rglru_scan_launch.restype = _I
    lib.rglru_scan_bwd_launch.argtypes = [*[_P] * 9, _I, _I64, _I64, _P]
    lib.rglru_scan_bwd_launch.restype = _I
    lib.rglru_scan_scratch_bytes.argtypes = [_I, _I64, _I64]
    lib.rglru_scan_scratch_bytes.restype = _I64
    lib.rglru_scan_error_string.argtypes = [_I]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def _refuse_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is a raw launcher and records no gradient: call "
            "repro_torch.kernels.ops.rglru_scan (its autograd Function runs "
            "the backward kernel), or call this under torch.no_grad()"
        )


def _check(operands, device) -> None:
    for name, t, shape in operands:
        if (
            tuple(t.shape) != shape
            or t.dtype != torch.float32
            or t.device != device
            or not t.is_contiguous()
        ):
            raise ValueError(
                f"{name}: want a contiguous {shape} float32 tensor on "
                f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device} "
                f"contiguous={t.is_contiguous()}"
            )


def _scratch(B: int, S: int, W: int, device) -> torch.Tensor:
    return torch.empty(
        _lib().rglru_scan_scratch_bytes(B, S, W), dtype=torch.uint8, device=device
    )


def _raise(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().rglru_scan_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def rglru_scan_kernel(
    a: torch.Tensor,  # (B, S, W) float32
    b: torch.Tensor,  # (B, S, W) float32
    h0: Optional[torch.Tensor] = None,  # (B, W) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (h (B, S, W) f32, h_last (B, W) f32).

    Under grad mode, inputs that require a gradient raise: this launcher
    would return outputs that drop it."""
    _refuse_grad("rglru_scan_kernel", a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got a on {a.device}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, W), got shape {tuple(a.shape)}")
    B, S, W = a.shape
    operands = [("a", a, (B, S, W)), ("b", b, (B, S, W))]
    if h0 is not None:
        operands.append(("h0", h0, (B, W)))
    _check(operands, a.device)
    h = torch.empty_like(a)
    h_last = torch.empty((B, W), dtype=torch.float32, device=a.device)
    scratch = _scratch(B, S, W, a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib().rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            h.data_ptr(), h_last.data_ptr(), scratch.data_ptr(), B, S, W, stream,
        )
    _raise(err, "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return h, h_last


def rglru_scan_bwd_kernel(
    a: torch.Tensor,  # (B, S, W) float32
    h: torch.Tensor,  # (B, S, W) the forward's states
    h0: Optional[torch.Tensor],  # (B, W) or None (zeros)
    dh: torch.Tensor,  # (B, S, W) gradient of h
    dh_last: Optional[torch.Tensor] = None,  # (B, W) gradient of h_last
    *,
    want_dh0: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(da, db, dh0) of the recurrence, float32; dh0 is None unless
    ``want_dh0``."""
    _refuse_grad("rglru_scan_bwd_kernel", a, h, h0, dh, dh_last)
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got a on {a.device}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, W), got shape {tuple(a.shape)}")
    B, S, W = a.shape
    operands = [("a", a, (B, S, W)), ("h", h, (B, S, W)), ("dh", dh, (B, S, W))]
    operands += [(n, t, (B, W)) for n, t in (("h0", h0), ("dh_last", dh_last)) if t is not None]
    _check(operands, a.device)
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((B, W), dtype=torch.float32, device=a.device) if want_dh0 else None
    scratch = _scratch(B, S, W, a.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib().rglru_scan_bwd_launch(
            a.data_ptr(), h.data_ptr(), ptr(h0), dh.data_ptr(), ptr(dh_last),
            da.data_ptr(), db.data_ptr(), ptr(dh0), scratch.data_ptr(), B, S, W, stream,
        )
    _raise(err, "rglru_scan_bwd")
    LAUNCHES["rglru_scan_bwd"] += 1
    return da, db, dh0
