"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity; they assume the full 700 W power limit) and the bound
of a piece of work. Copied from `chip_smoke.py` (``HBM_BYTES_PER_S``,
``PEAK_PRODUCT_FLOPS``, ``roofline``)."""

from __future__ import annotations

import torch

__all__ = ["HBM_BYTES_PER_S", "PEAK_PRODUCT_FLOPS", "bound_s"]

HBM_BYTES_PER_S = 3.35e12
# Peak rate for products of inputs of the type: bf16 on the tensor cores,
# float32 outside them.
PEAK_PRODUCT_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    """The least time the chip could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)
