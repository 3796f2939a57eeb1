"""Work of one call of flash attention (`repro_torch.kernels.ops.
flash_attention`, K3) and of its backward, from the call's shapes: q
(B, S, H, hd), k and v (B, S, KV, hd), ``window``. Frozen copies of
`chip_smoke.py::attention_work`, ``attention_bwd_work`` and
``live_pairs``."""

from __future__ import annotations

import numpy as np
import torch

from .roofline import PEAK_PRODUCT_FLOPS

__all__ = ["live_pairs", "forward", "backward"]


def live_pairs(Sq: int, Skv: int, window, q_offset: int = 0) -> int:
    """(query, key) pairs inside the causal/window band."""
    qpos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, Skv - 1)
    lo = np.zeros_like(qpos) if window is None else np.maximum(qpos - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _shape(call: dict):
    B, S, H, hd = call["shapes"][0]
    KV = call["shapes"][1][2]
    return B, S, H, KV, hd, call["kwargs"].get("window"), call["dtypes"][0]


def forward(call: dict):
    """(bytes, flops, peak flops): q, k, v read and out written once; 4 hd
    flops per live (query, key) pair (QK^T and PV) at the peak rate for
    products of the input type. The softmax's exponentials are not counted."""
    B, S, H, KV, hd, window, dtype = _shape(call)
    es = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * es
    flops = 4 * hd * live_pairs(S, S, window) * B * H
    return nbytes, flops, PEAK_PRODUCT_FLOPS[dtype]


def backward(call: dict):
    """(bytes, flops, peak flops): q, k, v, out and dout read once (lse in
    f32), dq, dk, dv written once; 10 hd flops per live (query, key) pair
    (S, dP, dV, dK, dQ) at the peak rate for products of the input type."""
    B, S, H, KV, hd, window, dtype = _shape(call)
    es = torch.finfo(dtype).bits // 8
    nbytes = (4 * B * S * H * hd + 4 * B * S * KV * hd) * es + B * H * S * 4
    flops = 10 * hd * live_pairs(S, S, window) * B * H
    return nbytes, flops, PEAK_PRODUCT_FLOPS[dtype]
