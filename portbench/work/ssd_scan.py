"""Work of one call of the SSD scan (`repro_torch.kernels.ops.ssd_scan`,
K4) and of its backward, from the call's shapes: x (B, S, H, P), dt
(B, S, H), A (H,), Bm and Cm (B, S, N), ``chunk``. ``forward`` is a
frozen copy of `chip_smoke.py::ssd_work`."""

from __future__ import annotations

import torch

from .roofline import PEAK_PRODUCT_FLOPS

__all__ = ["forward", "backward"]


def _shape(call: dict):
    (B, S, H, P), N = call["shapes"][0], call["shapes"][3][-1]
    return B, S, H, P, N, call["kwargs"].get("chunk", 128), call["dtypes"][0]


def _input_bytes(B, S, H, P, N, es) -> int:
    return (B * S * H * P + 2 * B * S * N) * es + (B * S * H + H) * 4


def forward(call: dict):
    """(bytes, flops, peak flops): x, dt, A, B, C read and y, h_fin written
    once; per chunk of qc steps 2 (N + P) flops per causal (i, j) pair (C B^T
    and its product with x) and 4 N P per step (the chunk's state and the
    carried-in term), at the peak rate for products of the input type. The
    exponentials are not counted."""
    B, S, H, P, N, chunk, dtype = _shape(call)
    es = torch.finfo(dtype).bits // 8
    nbytes = _input_bytes(B, S, H, P, N, es) + (B * S * H * P + B * H * P * N) * 4
    flops = 0
    for c0 in range(0, S, chunk):
        qc = min(chunk, S - c0)
        flops += 2 * (qc * (qc + 1) // 2) * (N + P) + 4 * qc * N * P
    flops *= B * H
    return nbytes, flops, PEAK_PRODUCT_FLOPS[dtype]


def backward(call: dict):
    """(bytes, flops, peak flops) of the gradient of one call: twice the
    forward's operations; the inputs read and their gradients written once."""
    B, S, H, P, N, chunk, dtype = _shape(call)
    es = torch.finfo(dtype).bits // 8
    _, flops, peak = forward(call)
    return 2 * _input_bytes(B, S, H, P, N, es), 2 * flops, peak
