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
sends CPU tensors to the plain version. ``_build.LAUNCHES`` counts calls:
one call is the reset and the scan.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import I, I64, P, Library, refuse_grad

__all__ = ["CHUNK_STEPS", "rglru_scan_kernel", "rglru_scan_bwd_kernel"]

CHUNK_STEPS = 32  # steps of S per block: kChunk of the source

_LIB = Library("rglru_scan", {
    "rglru_scan_launch": (I, [P, P, P, P, P, P, I, I64, I64, P]),
    "rglru_scan_bwd_launch": (I, [*[P] * 9, I, I64, I64, P]),
    "rglru_scan_scratch_bytes": (I64, [I, I64, I64]),
})


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
        _LIB.fn("rglru_scan_scratch_bytes")(B, S, W), dtype=torch.uint8, device=device
    )


def rglru_scan_kernel(
    a: torch.Tensor,  # (B, S, W) float32
    b: torch.Tensor,  # (B, S, W) float32
    h0: Optional[torch.Tensor] = None,  # (B, W) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (h (B, S, W) f32, h_last (B, W) f32).

    Under grad mode, inputs that require a gradient raise: this launcher
    would return outputs that drop it."""
    refuse_grad("rglru_scan_kernel", "rglru_scan", a, b, h0)
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
    _LIB.launch(
        "rglru_scan", a.device,
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), h_last.data_ptr(), scratch.data_ptr(), B, S, W,
    )
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
    refuse_grad("rglru_scan_bwd_kernel", "rglru_scan", a, h, h0, dh, dh_last)
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

    _LIB.launch(
        "rglru_scan_bwd", a.device,
        a.data_ptr(), h.data_ptr(), ptr(h0), dh.data_ptr(), ptr(dh_last),
        da.data_ptr(), db.data_ptr(), ptr(dh0), scratch.data_ptr(), B, S, W,
    )
    return da, db, dh0
